"""parallel/mesh.py and parallel/sharding.py in one process, against the JAX
package's mesh rule and ZeRO partition rule; the Trainer's mesh options at a
world of one (a gloo group made in this process and destroyed after each
test); train_net(model_parallel=True) and `kfold_train --model-shard` with
the configuration JAX's train_net sets; comet_logging refused."""

import math
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import optax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from hyperpri_tpu import config as jconfig  # noqa: E402
from hyperpri_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from hyperpri_tpu.parallel.sharding import estimate_zero_savings as jax_savings  # noqa: E402
from hyperpri_tpu.parallel.sharding import zero_partition_spec as jax_spec  # noqa: E402
from hyperpri_tpu.train import trainer as jtrainer  # noqa: E402
from hyperpri_tpu_torch import cli  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402
from hyperpri_tpu_torch.models.cubenet import CubeNET  # noqa: E402
from hyperpri_tpu_torch.parallel.mesh import mesh_sizes  # noqa: E402
from hyperpri_tpu_torch.parallel.sharding import (  # noqa: E402
    ZeroOptimizer,
    estimate_zero_savings,
    moments_tree_shapes,
    zero_partition_spec,
)
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET  # noqa: E402
from hyperpri_tpu_torch.train import trainer as ptrainer  # noqa: E402
from hyperpri_tpu_torch.train.step import make_optimizer  # noqa: E402
from hyperpri_tpu_torch.train.trainer import Trainer  # noqa: E402
from hyperpri_tpu_torch.weights import _torch_leaves, flax_axes  # noqa: E402

# test_sharding.py:20's shapes over its 8 devices, and a few more
MESH_SHAPES = [{"data": 2, "spatial": 4}, {"data": 2}, None, {"spatial": 2}, {"data": 8},
               {"data": 1, "spatial": 8}, {"data": 3, "spatial": 4}, {"data": 16}]


@pytest.fixture
def world1():
    """A gloo group of one, destroyed after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_mesh_sizes_match_jax_make_mesh(shape):
    try:
        want = jax_make_mesh(shape).shape
    except ValueError:
        with pytest.raises(ValueError):
            mesh_sizes(shape, 8)
        return
    assert mesh_sizes(shape, 8) == (want["data"], want["spatial"])


@pytest.fixture(scope="module")
def cubenet():
    """A CubeNET (first_depth 8: 31M parameters, shapes only) on the meta
    device, and the flax shape of each parameter, from the port's flax
    paths and layouts (weights.py)."""
    with torch.device("meta"):
        model = CubeNET(8, 1, 8)
    shapes = {}
    for name, module in model.named_modules():
        for leaf, collection, flax_leaf, _ in _torch_leaves(module):
            if collection == "params":
                p = getattr(module, leaf)
                path = "/".join(name.split(".") + [flax_leaf])
                shapes[path] = (p, tuple(p.shape[a] for a in flax_axes(module, p.dim())))
    return model, shapes


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_zero_partition_spec_leaf_by_leaf(cubenet, d):
    """Every parameter of CubeNET in its flax layout: the port's spec is
    JAX's, and ZeroOptimizer slices the torch dimension that the flax
    dimension JAX shards is, to 1/d of it."""
    model, shapes = cubenet

    class Stub:   # the data axis alone: ZeroOptimizer reads its size and place
        data, coordinate = d, (d - 1, 0)

    opt = ZeroOptimizer(model, lambda ps: make_optimizer(ps), Stub() if d > 1 else None)
    sharded = 0
    for path, (p, shape) in shapes.items():
        want = jax_spec(jax.ShapeDtypeStruct(shape, jax.numpy.float32), d)
        assert zero_partition_spec(shape, d) == tuple(want), path
        dim = opt.dims[p]
        if want == P():
            assert dim is None and opt.slices[p].shape == p.shape, path
        else:
            sharded += 1
            assert p.shape[dim] == shape[list(want).index("data")], path
            assert opt.slices[p].shape[dim] * d == p.shape[dim], path
    assert len(shapes) == len(opt.params) and (sharded > 0 or d == 1)


@pytest.mark.parametrize("d", [2, 4, 3])
def test_estimate_zero_savings_equals_jax(cubenet, d):
    model, shapes = cubenet
    params = _nest({path: jax.ShapeDtypeStruct(shape, jax.numpy.float32)
                    for path, (_, shape) in shapes.items()})
    mesh = jax_make_mesh({"data": d, "spatial": 1}, devices=jax.devices()[:d])
    want = jax_savings(jax.eval_shape(optax.adam(1e-3).init, params), mesh)
    assert estimate_zero_savings(moments_tree_shapes(model), d) == want
    assert want > 0.9 or d == 3


def test_zero_partition_spec_rules():
    """test_sharding.py:31's cases."""
    assert zero_partition_spec(np.zeros((3, 3, 64, 128)), 2) == (None, None, None, "data")
    assert zero_partition_spec(np.zeros((7,)), 2) == ()
    assert zero_partition_spec(np.zeros(()), 2) == ()
    assert zero_partition_spec(np.zeros((3, 3, 64, 128)), 1) == ()


@pytest.mark.parametrize("offload", [False, True])
def test_zero_optimizer_whole_leaves_equal_adam(offload):
    """With one data rank every leaf is whole: two steps equal
    torch.optim.Adam's bit for bit, with the moments offloaded or not."""
    models = [SpectralUNET(8, 1, 16, generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    opts = [make_optimizer(models[0]),
            ZeroOptimizer(models[1], lambda ps: make_optimizer(ps), None, offload)]
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=g) for p in models[0].parameters()]
        for m, opt in zip(models, opts):
            for p, gr in zip(m.parameters(), grads):
                p.grad = gr.clone()
            opt.step()
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    state = opts[1].full_state()
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(opts[0].state[a]["exp_avg_sq"], state[b]["exp_avg_sq"])


def _tiny_cfg(root, **kw):
    return ExpHyperspectralPRI(calling_path=str(root), hsi_lo=0, hsi_hi=8, device="cpu",
                               model_name="SpectralUNET", spectral_bn_size=16, **kw)


def test_trainer_takes_the_mesh_options(world1, tmp_path):
    tr = Trainer(_tiny_cfg(tmp_path, mesh_shape={"data": 1, "spatial": 1}, zero_shard_opt=True,
                           offload_opt_state=True))
    assert tr.mesh.shape == {"data": 1, "spatial": 1}
    assert tr.model.spatial_mesh is tr.mesh and isinstance(tr.optimizer, ZeroOptimizer)
    assert tr.effective_batch(3) == 3 and dist.get_backend() == "gloo"


def test_mesh_larger_than_the_world_raises(world1, tmp_path):
    with pytest.raises(ValueError, match="does not cover"):
        Trainer(_tiny_cfg(tmp_path, mesh_shape={"data": 2}))


def test_grad_accum_chunks_under_a_mesh_raises(world1, tmp_path):
    cfg = _tiny_cfg(tmp_path, mesh_shape={"data": 1}, grad_accum_chunks=2)
    with pytest.raises(ValueError, match="grad_accum_chunks"):
        Trainer(cfg)


def test_comet_logging_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="comet_logging"):
        Trainer(_tiny_cfg(tmp_path, comet_logging=True))


def _jax_model_parallel_cfg(tmp_path, test_deepspeed):
    """The configuration JAX's train_net(model_parallel=True) hands its
    Trainer at a world of one device."""
    cfg = jconfig.ExpHyperspectralPRI(calling_path=str(tmp_path), hsi_lo=0, hsi_hi=8)
    cfg.test_deepspeed = test_deepspeed
    seen = []

    class Stop(Exception):
        pass

    def capture(c, *a, **k):
        seen.append(c)
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "Trainer", capture)
        mp.setattr(jtrainer.jax, "devices", lambda: jax.local_devices()[:1])
        with pytest.raises(Stop):
            jtrainer.train_net(cfg, model_parallel=True, progress=False)
    return seen[0]


KEYS = ("precision", "zero_shard_opt", "offload_opt_state", "mesh_shape")


def test_kfold_train_model_shard_in_one_process(world1, tmp_path, monkeypatch):
    """`kfold_train --model-shard` as one process: train_net(model_parallel=True)
    sets what JAX's sets (bf16, ZeRO, the mesh of the world) and the fit runs
    on SpectralUNET-16, whose run directory holds the checkpoints."""
    make_experiment_tree(str(tmp_path), n_boxes=2, dates_per_box=2, size_hw=(8, 8), bands=16,
                         seed=0)
    seen = []
    real = ptrainer.Trainer

    def spy(cfg, *a, **k):
        seen.append({key: getattr(cfg, key) for key in KEYS})
        return real(cfg, *a, **k)

    monkeypatch.setattr(ptrainer, "Trainer", spy)
    cli.kfold_train(["--calling-path", str(tmp_path), "--model-shard", "--num-splits", "1",
                     "--max-epochs", "1", "--device", "cpu", "--model", "SpectralUNET",
                     "--spectral-bn-size", "16", "--hsi-lo", "0", "--hsi-hi", "16"])
    want = _jax_model_parallel_cfg(tmp_path, False)
    assert seen[0] == {key: getattr(want, key) for key in KEYS}
    assert seen[0]["mesh_shape"] == {"data": math.gcd(2, 1), "spatial": 1}
    run = os.path.join(str(tmp_path), "Saved_Models", "HSI")
    assert any("last.ckpt" in files for _, _, files in os.walk(run))
    shutil.rmtree(run)


def test_model_parallel_with_test_deepspeed_offloads(world1, tmp_path):
    make_experiment_tree(str(tmp_path), n_boxes=2, dates_per_box=2, size_hw=(8, 8), bands=16,
                         seed=0)
    cfg = ExpHyperspectralPRI(calling_path=str(tmp_path), hsi_lo=0, hsi_hi=16, device="cpu",
                              model_name="SpectralUNET", spectral_bn_size=16)
    cfg.test_deepspeed = True
    tr = ptrainer.train_net(cfg, model_parallel=True, max_epochs=1, progress=False)
    want = _jax_model_parallel_cfg(tmp_path, True)
    assert {k: getattr(cfg, k) for k in KEYS} == {k: getattr(want, k) for k in KEYS}
    assert tr.optimizer.offload and tr.fit_result.epochs_run == 1
    shutil.rmtree(os.path.join(str(tmp_path), "Saved_Models"))
