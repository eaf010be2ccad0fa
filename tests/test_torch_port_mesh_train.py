"""Multi-device training on a CPU mesh: the port's train step, fit, resume and
validation under parallel/mesh.py, in one 4-rank gloo job.

The job (the worker below, four processes that import no JAX) builds the
meshes (1, 4), (2, 2) and (2, 1) over one world of four ranks and runs:

  - the train step of a U-Net with UNet's modules and forward at widths
    4-64 (`_MODEL`; the published models hold 31M parameters at any input
    size, too many to all-reduce over gloo in a test), in float64 on stock
    ops, two Adam steps on one batch, at 32x32 and at 16x16, whose deepest
    levels do not split over 4 (nor the 1-row one over 2), with the
    transposed-conv upsampling (the bilinear at (2, 2) and 16x16), on the
    meshes against the single-device step that every rank also runs: step 1's
    loss, every gradient leaf (summed over the mesh), the BatchNorm running
    statistics and the parameters after two steps, each within F64_REL of
    the largest entry of its tree (grads, statistics, parameters; see
    `worst`); the ZeRO optimizer keeping 1/d of every sharded moment;
  - CubeNET's own training forward (first_depth 8, its alternate head) in
    float64 on (1, 4) at 16x16: logits and running statistics against one
    device; its float32 loss at (2, 2) at 32x32;
  - the narrow step in float32 on the kernel route (gates lowered, the
    kernels' plain versions on these CPU tensors) on the data-only mesh: the
    kernel calls per step equal the single device's (the route is kept),
    and with the Adam moments offloaded to host memory the parameters after
    two steps are bit-equal to those without;
  - train_net under a (2, 2) mesh for two epochs (rank 0 writes), then a
    resume that runs epochs 2-3 only, the resumed state exported (the ZeRO
    slices gathered) and validate_net under the mesh.

The parent holds CubeNET's float32 loss at (2, 2) against the JAX package's
mesh step from the same flax variables (JAX's bound, test_sharding.py:87),
the final checkpoint loaded by a single-process Trainer bit-equal to the
mesh's state, and the mesh's validation curves against one process.
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

from hyperpri_tpu.config import ExpHyperspectralPRI as JaxConfig  # noqa: E402
from hyperpri_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from hyperpri_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from hyperpri_tpu.train.trainer import masked_bce as jax_masked_bce  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402
from hyperpri_tpu_torch.train.checkpoint import find_resume_checkpoint  # noqa: E402
from hyperpri_tpu_torch.train.evaluate import validate_net  # noqa: E402
from hyperpri_tpu_torch.train.trainer import Trainer  # noqa: E402
from hyperpri_tpu_torch.weights import export_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANDS, FD = 8, 8
F64_REL = 1e-10      # float64 mesh step against the single-device step
# The parameters of the conv biases that feed a BatchNorm: their gradient is
# round-off (~1e-15 of the largest leaf), and Adam's step moves them by
# lr * g / (|g| + eps) ~ lr * g / eps, so their two runs differ by
# lr * 1e-15 / 1e-8 per step: a few 1e-10 of the largest parameter.
ROUNDOFF_PARAMS = 1e-8
JAX_LOSS_ABS = 2e-5  # test_sharding.py:87's bound between JAX's mesh and single-device steps
WORLD = 4

# UNet's modules and forward (its mesh wiring) at widths 4-64, so that a
# step's gradients and moments stay small enough to all-reduce over gloo in a
# test (the published models hold 31M parameters at any input width).
_MODEL = textwrap.dedent(r"""
    import torch
    import torch.nn as nn
    from hyperpri_tpu_torch.models.parts import DoubleConv, Down, OutConv, Up, _Conv
    from hyperpri_tpu_torch.models.unet import UNet

    class NarrowUNet(UNet):
        def __init__(self, bands, bilinear=False, dtype=torch.float32, use_kernels=False,
                     **gates):
            nn.Module.__init__(self)
            self.n_channels, self.analyze, self.fused_bn = bands, False, False
            self.dtype, self.spatial_mesh = dtype, None
            c, f = 4, 2 if bilinear else 1
            kw = dict(use_kernels=use_kernels, dtype=dtype, **gates)
            self.inc = DoubleConv(bands, c, **kw)
            self.down1, self.down2 = Down(c, 2 * c, **kw), Down(2 * c, 4 * c, **kw)
            self.down3, self.down4 = Down(4 * c, 8 * c, **kw), Down(8 * c, 16 * c // f, **kw)
            self.up1 = Up(16 * c, 8 * c, bilinear, **kw)   # UNet's plan, c = 4
            self.up2 = Up(8 * c, 4 * c, bilinear, **kw)
            self.up3 = Up(4 * c, 2 * c, bilinear, **kw)
            self.up4 = Up(2 * c, c * f, bilinear, **kw)
            self.outc = OutConv(c, 1, dtype)
            g = torch.Generator().manual_seed(0)
            for m in self.modules():
                if isinstance(m, _Conv):
                    m.reset_parameters(g)

    def cubenet(dtype, bands=8, first_depth=8):
        # CubeNET with seeded weights of fan-in scale, drawn fast (31M of them)
        from hyperpri_tpu_torch.models.cubenet import CubeNET
        from hyperpri_tpu_torch.models.parts import TorchBatchNorm

        with torch.device("meta"):
            m = CubeNET(bands, 1, first_depth, dtype=dtype)
        m = m.to_empty(device="cpu")
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, TorchBatchNorm):
                    mod.weight.fill_(1.0)
                    mod.running_var.fill_(1.0)
                    mod.running_mean.zero_()
                    mod.bias.normal_(0.0, 0.1, generator=g)
                elif isinstance(mod, _Conv):
                    mod.weight.normal_(0.0, mod.fan_in ** -0.5, generator=g)
                    mod.bias.normal_(0.0, 0.1, generator=g)
        return m.to(dtype)
""")

_WORKER = textwrap.dedent(r"""
    import copy, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, init, out, tree = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    BANDS, FD = 8, 8
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)
    exec(open(os.path.join(out, "model.py")).read())

    from hyperpri_tpu_torch.config import ExpHyperspectralPRI
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed
    from hyperpri_tpu_torch.parallel.mesh import AXES, Mesh
    from hyperpri_tpu_torch.parallel.sharding import ZeroOptimizer
    from hyperpri_tpu_torch.serve import masked_bce, step_logs
    from hyperpri_tpu_torch.train.evaluate import validate_net
    from hyperpri_tpu_torch.train.step import make_optimizer, make_train_step
    from hyperpri_tpu_torch.train.trainer import train_net
    from hyperpri_tpu_torch.weights import export_state

    MESHES = {
        "1x4": Mesh(init_device_mesh("cpu", (1, 4), mesh_dim_names=AXES)),
        "2x2": Mesh(init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)),
        "2x1": Mesh(init_device_mesh("cpu", (2, 2, 1),
                                     mesh_dim_names=("replica",) + AXES)[AXES]),
    }
    GATES = dict(min_pixels=16, min_channels=8)
    # (size, bilinear, meshes): 16x16 has the levels that do not split
    STEP_CASES = ((32, False, ("2x2",)), (16, False, ("1x4",)), (16, True, ("2x2",)))
    ROUNDOFF = 1e-9   # a gradient leaf this far below the largest holds round-off only
    KERNELS = (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad)
    report = {}

    def batch(hw, dtype):
        g = torch.Generator().manual_seed(hw)
        return {"image": torch.randn(2, hw, hw, BANDS, generator=g, dtype=dtype),
                "mask": (torch.rand(2, hw, hw, 1, generator=g) < 0.3).float(),
                "valid": torch.ones(2)}

    def shard(b, mesh):
        s0, s1 = mesh.sample_range(2)
        r0, r1 = mesh.row_range(b["image"].shape[1])
        return {"image": b["image"][s0:s1, r0:r1], "mask": b["mask"][s0:s1, r0:r1],
                "valid": b["valid"][s0:s1]}

    def rows(t, mesh):
        r0, r1 = mesh.row_range(t.shape[1] * mesh.spatial)
        s0, s1 = mesh.sample_range(t.shape[0] * mesh.data)
        return s0, s1, r0, r1

    def narrow(dtype, mesh, kernels, bilinear=False):
        gates = GATES if kernels else {}
        m = NarrowUNet(BANDS, bilinear, dtype, kernels, **gates)
        if dtype == torch.float64:
            m = m.double()   # parameters too: the whole step in float64
        m.spatial_mesh = mesh
        return m

    def run(dtype, hw, mesh=None, kernels=False, offload=False, bilinear=False):
        m = narrow(dtype, mesh, kernels, bilinear)
        if mesh is None:
            opt = make_optimizer(m, "ADAM", 1e-3)
        else:
            opt = ZeroOptimizer(m, lambda ps: make_optimizer(ps, "ADAM", 1e-3), mesh, offload)
        step = make_train_step(m, opt, 0.5, mesh=mesh)
        b = batch(hw, dtype)
        rec = {}
        for k in range(2):
            calls = [f.calls for f in KERNELS]
            logs = step(b if mesh is None else shard(b, mesh))
            if k == 0:
                rec["calls"] = [f.calls - c for f, c in zip(KERNELS, calls)]
                rec["loss"] = float(logs["loss_sum"]) / float(logs["n"])
                rec["grads"] = {n: p.grad.clone() for n, p in m.named_parameters()}
        rec["params"] = {n: p.detach().clone() for n, p in m.named_parameters()}
        rec["stats"] = {n: t.clone() for n, t in m.named_buffers()}
        return m, opt, rec

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def worst(got, want, keys=None):
        # over the tree's largest entry: a conv bias that feeds a BatchNorm has
        # a round-off gradient, which Adam scales by 1/eps into its parameter
        # and, through it, into the next batch's mean
        scale = max(float(t.abs().max()) for t in want.values())
        return max(float((got[k] - want[k]).abs().max()) for k in keys or want) / scale

    # float64 on stock ops: every mesh, both sizes, both upsamplings, against one device
    for hw, bilinear, names in STEP_CASES:
            _, _, ref = run(torch.float64, hw, bilinear=bilinear)
            gmax = max(float(g.abs().max()) for g in ref["grads"].values())
            roundoff = sorted(k for k, g in ref["grads"].items()
                              if float(g.abs().max()) <= ROUNDOFF * gmax)
            rest = [k for k in ref["params"] if k not in roundoff]
            for name in names:
                mesh = MESHES[name]
                _, opt, rec = run(torch.float64, hw, mesh, bilinear=bilinear)
                errs = {"loss": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
                        "grads": worst(rec["grads"], ref["grads"]),
                        "stats": worst(rec["stats"], ref["stats"]),
                        "params": worst(rec["params"], ref["params"], rest),
                        "params_roundoff": worst(rec["params"], ref["params"], roundoff),
                        "roundoff_leaves": roundoff}
                sharded = [p for p in opt.params if opt.dims[p] is not None]
                errs["sharded_leaves"] = len(sharded)
                errs["moments_one_dth"] = all(
                    opt.inner.state[opt.slices[p]][k].numel() * mesh.data == p.numel()
                    for p in sharded for k in ("exp_avg", "exp_avg_sq"))
                report[f"f64_{name}_{hw}_{int(bilinear)}"] = errs

    # CubeNET's own wiring (31M parameters): the training forward in float64 on
    # (1, 4) at 16x16 and (2, 2) at 32x32 against one device, logits and
    # running statistics; and its float32 loss at (2, 2) for the JAX mesh step

    ref = cubenet(torch.float64)
    sharded = copy.deepcopy(ref)
    mesh = MESHES["1x4"]
    b = batch(16, torch.float64)
    with torch.no_grad():
        want = ref(b["image"], train=True)
        sharded.spatial_mesh = mesh
        got = sharded(shard(b, mesh)["image"], train=True)
    s0, s1, r0, r1 = rows(got, mesh)
    report["cubenet_f64_1x4_16"] = {
        "logits": rel(got, want[s0:s1, r0:r1]),
        "stats": worst(dict(sharded.named_buffers()), dict(ref.named_buffers()))}
    del ref, sharded
    mesh = MESHES["2x2"]
    f32 = cubenet(torch.float32)
    f32.spatial_mesh = mesh
    b = shard(batch(32, torch.float32), mesh)
    with torch.no_grad():
        logits = f32(b["image"], train=True)
        logs = step_logs(masked_bce(logits, b["mask"], b["valid"], mesh), logits, b, 0.5, mesh)
    report["cubenet_f32_loss_2x2"] = float(logs["loss_sum"]) / float(logs["n"])
    del f32

    # float32 on the kernel route: the data-only mesh keeps it, offload is exact
    _, _, one = run(torch.float32, 16, kernels=True)
    _, _, on = run(torch.float32, 16, MESHES["2x1"], kernels=True, offload=True)
    _, _, off = run(torch.float32, 16, MESHES["2x1"], kernels=True)
    report["calls_single"], report["calls_2x1"] = one["calls"], off["calls"]
    report["offload_bit_equal"] = all(torch.equal(on["params"][k], off["params"][k])
                                      for k in off["params"])
    report["offload_calls"] = on["calls"]

    # the product loop under a (2, 2) mesh
    def config():
        return ExpHyperspectralPRI(calling_path=tree, hsi_lo=0, hsi_hi=BANDS, device="cpu",
                                   mesh_shape={"data": 2, "spatial": 2}, zero_shard_opt=True)

    first = train_net(config(), max_epochs=2, progress=False, model=NarrowUNet(BANDS))
    report["first_epochs"] = first.fit_result.epochs_run
    report["first_shape"] = first.mesh.shape
    cfg = config()
    resumed = train_net(cfg, checkpoint=True, max_epochs=4, progress=False,
                        model=NarrowUNet(BANDS))
    report["resumed_epochs"] = resumed.fit_result.epochs_run
    report["resumed_first_epoch"] = resumed.fit_result.history[0]["epoch"]
    state = export_state(resumed.model, resumed.optimizer)
    curve = validate_net(cfg.get_val_data(), cfg, trainer=resumed, verbose=False)
    if rank == 0:
        torch.save(state, os.path.join(out, "mesh_state.pt"))
        np.savez(os.path.join(out, "curve.npz"), *curve)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
""")


def _start(tmp_path, *args):
    """The worker on WORLD ranks, started."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    (tmp_path / "model.py").write_text(_MODEL)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "init"),
                              str(tmp_path), *map(str, args)], env=env, cwd=tmp_path,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def _finish(tmp_path, procs):
    """-> each rank's report, once every rank has exited 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]


def _jax_mesh_loss():
    """Step 1's loss of the JAX package's train step on a (2, 2) mesh of the
    virtual CPU devices (its Trainer routes the convs through conv3x3_spatial),
    from the weights of the workers' float32 CubeNET (`_MODEL`'s cubenet):
    the loss is computed before the update, so the train-mode forward and
    masked_bce are the step's."""
    namespace = {}
    exec(_MODEL, namespace)
    init = export_state(namespace["cubenet"](torch.float32, BANDS, FD))
    cfg = JaxConfig(calling_path=".", split_no=1)
    cfg.hsi_lo, cfg.hsi_hi, cfg.channels, cfg.cube_featmaps = 0, BANDS, BANDS, FD
    cfg.zero_shard_opt, cfg.mesh_shape = True, {"data": 2, "spatial": 2}
    tr = JaxTrainer(cfg, mesh=jax_make_mesh(cfg.mesh_shape, devices=jax.devices()[:4]))
    g = torch.Generator().manual_seed(32)
    b = {"image": torch.randn(2, 32, 32, BANDS, generator=g, dtype=torch.float32).numpy(),
         "mask": (torch.rand(2, 32, 32, 1, generator=g) < 0.3).float().numpy(),
         "valid": np.ones(2, np.float32)}
    sh = tr._batch_shardings()
    b = {k: jax.device_put(v, sh[k]) for k, v in b.items()}
    params = jax.tree.map(lambda t: np.asarray(t.numpy()), init["params"])
    stats = jax.tree.map(lambda t: np.asarray(t.numpy()), init["batch_stats"])

    def loss(params, stats, b):
        logits, _ = tr.model.apply({"params": params, "batch_stats": stats}, b["image"],
                                   train=True, mutable=["batch_stats"])
        return jax_masked_bce(logits, b["mask"], b["valid"])

    return float(jax.jit(loss)(params, stats, b))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    tree = tmp / "tree"
    make_experiment_tree(str(tree), n_boxes=2, dates_per_box=2, size_hw=(16, 16), bands=BANDS,
                         seed=0)
    procs = _start(tmp, tree)
    try:   # the JAX side while the workers run
        jax_loss = _jax_mesh_loss()
    finally:
        reports = _finish(tmp, procs)
    yield tmp, tree, reports, jax_loss
    shutil.rmtree(tmp, ignore_errors=True)


def _narrow_unet():
    namespace = {}
    exec(_MODEL, namespace)
    return namespace["NarrowUNet"](BANDS)


@pytest.mark.parametrize("mesh, hw, bilinear", [("2x2", 32, False), ("1x4", 16, False),
                                                ("2x2", 16, True)])
def test_float64_mesh_step_equals_single_device(job, mesh, hw, bilinear):
    for rank, report in enumerate(job[2]):
        errs = report[f"f64_{mesh}_{hw}_{int(bilinear)}"]
        for key in ("loss", "grads", "stats", "params"):
            assert errs[key] <= F64_REL, (rank, key, errs)
        # the conv biases that feed a BatchNorm, whose gradient is round-off
        # (zero in exact arithmetic): Adam's first steps scale it by lr / eps
        assert errs["params_roundoff"] <= ROUNDOFF_PARAMS, (rank, errs)
        assert errs["roundoff_leaves"] and all(
            k.split(".")[-2] in ("conv1", "conv2") and k.endswith(".bias")
            for k in errs["roundoff_leaves"]), errs["roundoff_leaves"]
        assert errs["moments_one_dth"], (rank, errs)
        if mesh != "1x4":   # a data axis of 2 shards nearly every leaf
            assert errs["sharded_leaves"] > 0


def test_cubenet_training_forward_on_a_mesh(job):
    for report in job[2]:
        errs = report["cubenet_f64_1x4_16"]
        assert errs["logits"] <= F64_REL and errs["stats"] <= F64_REL, errs


def test_data_only_mesh_keeps_the_kernel_route(job):
    """conv3x3_packed, conv3x3_bias_act and conv3x3_wgrad calls of step 1
    (the narrow model's convs are at most 64 wide: no conv3x3_bias_act)."""
    for report in job[2]:
        assert report["calls_2x1"] == report["calls_single"]
        assert report["calls_single"][0] > 0 and report["calls_single"][2] > 0


def test_offloaded_moments_give_bit_equal_parameters(job):
    for report in job[2]:
        assert report["offload_bit_equal"]
        assert report["offload_calls"] == report["calls_single"]


def test_float32_mesh_loss_against_jax_mesh_step(job):
    want = job[3]
    for report in job[2]:
        assert abs(report["cubenet_f32_loss_2x2"] - want) <= JAX_LOSS_ABS


def _config(tree):
    return ExpHyperspectralPRI(calling_path=str(tree), hsi_lo=0, hsi_hi=BANDS, device="cpu")


def test_train_net_resume_and_single_process_load(job):
    tmp, tree, reports, _ = job
    for report in reports:
        assert report["first_epochs"] == 2 and report["first_shape"] == {"data": 2, "spatial": 2}
        assert report["resumed_epochs"] == 2 and report["resumed_first_epoch"] == 2
    cfg = _config(tree)
    last = find_resume_checkpoint(cfg.save_path)
    assert last is not None and last.endswith("last.ckpt")
    single = Trainer(cfg, model=_narrow_unet())
    single.restore_state(last)
    got = _flat(export_state(single.model, single.optimizer))
    want = _flat(torch.load(tmp / "mesh_state.pt"))
    assert set(got) == set(want) and int(want["count"]) == 4
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_validate_net_under_mesh_equals_one_process(job):
    tmp, tree = job[:2]
    cfg = _config(tree)
    want = validate_net(cfg.get_val_data(), cfg, trainer=Trainer(cfg, model=_narrow_unet()),
                        verbose=False)
    got = np.load(tmp / "curve.npz")
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{k}"], w)
