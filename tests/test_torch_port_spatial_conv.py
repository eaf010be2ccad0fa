"""The H-sharded 3x3 conv with its halo exchange (parallel/spatial_conv.py) on
a CPU mesh, in one 4-rank gloo job, against the JAX package's
conv3x3_spatial (parallel/spatial_conv.py:57) on the virtual CPU devices
and against the port's unsharded conv.

The job (the worker below, four processes that import no JAX) builds the
meshes (1, 4), (2, 2) and (2, 1) over one world and runs, on each rank's
samples and rows of one seeded batch, the forward and the gradients of x, w
and b of sum(y * g): at spatial 2 (the (2, 2) mesh) and 4 (the (1, 4) mesh)
and on the data-only mesh's pre-padded path (the host pre-padded ingest
buffer read raw), in float32 on F.conv2d and on the kernel convs (their plain
versions on these CPU tensors), and in float64 on F.conv2d. The weight and
bias gradients are summed over the mesh, as the train step does. The parent
stitches the shards and holds float32 against JAX (rel L2) and float64
against the port's unsharded conv.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from hyperpri_tpu.parallel.spatial_conv import conv3x3_spatial as jax_conv3x3_spatial  # noqa: E402
from hyperpri_tpu_torch.data.pipeline import pre_pad_images  # noqa: E402
from hyperpri_tpu_torch.ops.kernels import framing  # noqa: E402
from hyperpri_tpu_torch.parallel.spatial_conv import local_conv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
N, H, W, C, O = 2, 16, 10, 6, 12
JAX_REL = 1e-5    # float32 against JAX, rel L2
F64_REL = 1e-12   # float64 against the unsharded conv, rel L2
CASES = [("2x2", "f32", False), ("2x2", "f32", True), ("1x4", "f32", False),
         ("1x4", "f32", True), ("2x1_pre_padded", "f32", False),
         ("2x1_pre_padded", "f32", True), ("2x2", "f64", False), ("1x4", "f64", False),
         ("2x1_pre_padded", "f64", False)]

_WORKER = textwrap.dedent(r'''
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)

    from hyperpri_tpu_torch.parallel.mesh import AXES, Mesh
    from hyperpri_tpu_torch.parallel.spatial_conv import conv3x3_spatial

    MESHES = {
        "1x4": Mesh(init_device_mesh("cpu", (1, 4), mesh_dim_names=AXES)),
        "2x2": Mesh(init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)),
        "2x1_pre_padded": Mesh(init_device_mesh("cpu", (2, 2, 1),
                                                mesh_dim_names=("replica",) + AXES)[AXES]),
    }
    data = np.load(os.path.join(out, "inputs.npz"))
    cases = json.loads(data["cases"].item())
    results = {}
    for mesh_name, dtype_name, kernels in cases:
        mesh = MESHES[mesh_name]
        dtype = {"f32": torch.float32, "f64": torch.float64}[dtype_name]
        pre = mesh_name.endswith("pre_padded")
        x_all = torch.from_numpy(data["x_padded" if pre else "x"]).to(dtype)
        g_all = torch.from_numpy(data["g"]).to(dtype)
        s0, s1 = mesh.sample_range(x_all.shape[0])
        r0, r1 = (0, x_all.shape[1]) if pre else mesh.row_range(x_all.shape[1])
        x = x_all[s0:s1, r0:r1].clone().requires_grad_()
        w = torch.from_numpy(data["w"]).to(dtype).requires_grad_()
        b = torch.from_numpy(data["b"]).to(torch.float32 if kernels else dtype).requires_grad_()
        hw = tuple(int(v) for v in data["hw"]) if pre else None
        y = conv3x3_spatial(x, w, b, mesh, kernels=kernels, pre_padded_hw=hw)
        g = g_all[s0:s1] if pre else g_all[s0:s1, r0:r1]
        (y * g).sum().backward()
        key = f"{mesh_name}_{dtype_name}_{int(kernels)}"
        results[key + "_y"] = y.detach().double().numpy()
        results[key + "_dw"] = mesh.all_reduce_(w.grad.clone()).double().numpy()
        results[key + "_db"] = mesh.all_reduce_(b.grad.clone()).double().numpy()
        if not pre:   # the ingest buffer is leaf data: no dx on the kernel route
            results[key + "_dx"] = x.grad.double().numpy()
        results[key + "_range"] = np.array([s0, s1, r0, r1])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()
''')


def _launch(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "init"),
                               str(tmp_path)], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, H, W, C))
    spec = framing.ingest_spec(H, W, C)
    return {"x": x, "x_padded": pre_pad_images(torch.from_numpy(x), spec).numpy(),
            "w": rng.normal(size=(3, 3, C, O)) * 0.2, "b": rng.normal(size=(O,)),
            "g": rng.normal(size=(N, H, W, O)), "hw": np.array([H, W])}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_conv")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", cases=json.dumps(CASES), **inputs)
    ranks = _launch(tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return inputs, ranks


def _stitched(ranks, key, name):
    """The global tensor from the ranks' shards (sample and row ranges)."""
    pieces = {}
    for r in ranks:
        s0, s1, r0, r1 = r[key + "_range"]
        pieces[(s0, r0)] = r[f"{key}_{name}"]
    rows = sorted({k[1] for k in pieces})
    return np.concatenate([np.concatenate([pieces[(s, r)] for r in rows], axis=1)
                           for s in sorted({k[0] for k in pieces})], axis=0)


def _port_results(ranks, key):
    out = {"y": _stitched(ranks, key, "y"), "dw": ranks[0][key + "_dw"],
           "db": ranks[0][key + "_db"]}
    if key + "_dx" in ranks[0]:
        out["dx"] = _stitched(ranks, key, "dx")
    for r in ranks[1:]:   # the summed weight gradients are the same on every rank
        np.testing.assert_array_equal(r[key + "_dw"], out["dw"])
    return out


def _jax_results(inputs, mesh_name):
    pre = mesh_name.endswith("pre_padded")
    d, s = (2, 1) if pre else (int(mesh_name[0]), int(mesh_name[2]))
    mesh = jax_make_mesh({"data": d, "spatial": s}, devices=jax.devices()[:d * s])
    x = jnp.asarray(inputs["x_padded" if pre else "x"], jnp.float32)
    w, b, g = (jnp.asarray(inputs[k], jnp.float32) for k in ("w", "b", "g"))
    hw = (H, W) if pre else None

    def loss(x, w, b):
        return jnp.sum(jax_conv3x3_spatial(x, w, b, mesh, pre_padded_hw=hw) * g)

    y = jax.jit(lambda x, w, b: jax_conv3x3_spatial(x, w, b, mesh, pre_padded_hw=hw))(x, w, b)
    dx, dw, db = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, w, b)
    out = {"y": np.asarray(y), "dw": np.asarray(dw), "db": np.asarray(db)}
    if not pre:   # the ingest buffer is leaf data: the port computes no dx for it
        out["dx"] = np.asarray(dx)
    return out


def _unsharded(inputs):
    """The port's conv on the whole batch in float64, and its gradients."""
    x, w, b, g = (torch.from_numpy(inputs[k]).requires_grad_() for k in ("x", "w", "b", "g"))
    y = local_conv(x, w, b, False)
    (y * g.detach()).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(),
            "db": b.grad.numpy()}


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4", "2x1_pre_padded"])
@pytest.mark.parametrize("kernels", [False, True])
def test_float32_against_jax(job, mesh_name, kernels):
    inputs, ranks = job
    got = _port_results(ranks, f"{mesh_name}_f32_{int(kernels)}")
    want = _jax_results(inputs, mesh_name)
    assert set(got) == set(want)
    for name in want:
        assert _rel_l2(got[name], want[name]) <= JAX_REL, name


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4", "2x1_pre_padded"])
def test_float64_against_unsharded(job, mesh_name):
    inputs, ranks = job
    got = _port_results(ranks, f"{mesh_name}_f64_0")
    want = _unsharded(inputs)
    for name in got:
        assert _rel_l2(got[name], want[name]) <= F64_REL, name
