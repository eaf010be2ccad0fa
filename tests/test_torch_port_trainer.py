"""The port's product loop (config, registry, train/trainer.py, checkpoint.py,
evaluate.py) on a tiny synthetic tree, against the JAX package's train_net
and validate_net, with the checkpoints it writes (resume, early stopping and
the ingest on and off are in test_torch_port_trainer_resume.py).

Both sides start from one flax init: the JAX package's Trainer draws it from
key run_num, and the port loads the same variables (weights.py). The port's
gates are lowered through CubeNET's constructor so that the kernel route and
the ingest fire on their plain versions at 16x24; the JAX
side takes XLA's convs (its kernel gate needs a TPU) and runs op by op
(jax.disable_jit): jitted on this CPU it is off a float64 run by up to 26% on
a leaf (ROADMAP caveat R5).
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hyperpri_tpu import config as jconfig  # noqa: E402
from hyperpri_tpu.train import evaluate as jevaluate  # noqa: E402
from hyperpri_tpu.train import trainer as jtrainer  # noqa: E402
from hyperpri_tpu_torch.config import ExpHyperspectralPRI  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402
from hyperpri_tpu_torch.models.cubenet import CubeNET  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed  # noqa: E402
from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad  # noqa: E402
from hyperpri_tpu_torch.train import checkpoint  # noqa: E402
from hyperpri_tpu_torch.train import evaluate  # noqa: E402
from hyperpri_tpu_torch.train.trainer import Trainer, train_net  # noqa: E402
from hyperpri_tpu_torch.weights import load_jax_variables  # noqa: E402

BANDS, HW = 20, (16, 24)
GATES = dict(min_pixels=16, min_channels=8)   # every gated 3x3 conv takes a kernel
# Per-epoch losses against the JAX package. Epoch 0's train loss comes before
# any update: float32 round-off only. Every later loss follows Adam steps, and
# Adam moves a parameter whose gradient is at round-off level by +-lr with a
# sign that is noise (tests/test_torch_port_train_step.py), so two float32
# trajectories of this tiny model drift apart: after one step and after two
# the losses stay within these limits.
FIRST_LOSS_REL = 1e-5
LATER_LOSS_REL = 2e-2


def _port_cfg(root, **kw):
    return ExpHyperspectralPRI(calling_path=str(root), hsi_lo=0, hsi_hi=BANDS, device="cpu",
                               **kw)


def _jax_cfg(root, **kw):
    return jconfig.ExpHyperspectralPRI(calling_path=str(root), hsi_lo=0, hsi_hi=BANDS,
                                       device="cpu", **kw)


def _calling_path(tmp_path_factory, tree, name):
    """A fresh calling path whose Datasets/ is the shared tree's."""
    root = tmp_path_factory.mktemp(name)
    os.symlink(tree / "Datasets", root / "Datasets")
    return root


def _port_model(params, batch_stats):
    model = CubeNET(BANDS, 1, 64, bilinear=False, use_kernels=True, **GATES)
    return load_jax_variables(model, params, batch_stats)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_experiment_tree(str(root), n_boxes=2, dates_per_box=2, size_hw=HW, bands=BANDS,
                         seed=0)
    return root


def _checkpoints(save_path):
    """What the checkpoint tests read from a run directory, after which the
    directory is removed: a CubeNET-64 full checkpoint is ~375 MB, and the
    suite's temporary space is shared."""
    ckpt_dir = os.path.join(save_path, "Checkpoints")
    info = {"ckpts": sorted(os.listdir(ckpt_dir)),
            "dice": sorted(os.listdir(os.path.join(save_path, "diceCheckpoints"))),
            "eval": checkpoint.find_eval_checkpoint(save_path),
            "resume": checkpoint.find_resume_checkpoint(save_path)}
    payload = checkpoint.load_checkpoint(os.path.join(ckpt_dir, "last.ckpt"))
    info["last"] = {"epoch": payload["epoch"], "count": int(payload["state"]["count"]),
                    "keys": set(payload["state"]),
                    "first_conv": tuple(payload["state"]["params"]["first_conv"]["kernel"].shape)}
    shutil.rmtree(save_path)
    return info


@pytest.fixture(scope="module")
def parity(tree, tmp_path_factory):
    """Two epochs of both packages' train_net from one init: the JAX
    Trainer's own (captured as it creates its state), loaded into the port."""
    jroot = _calling_path(tmp_path_factory, tree, "jax_run")
    jcfg = _jax_cfg(jroot)
    created = []

    def capture(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    create = jtrainer.create_train_state
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jtrainer, "create_train_state", capture)
        jt = jtrainer.train_net(jcfg, max_epochs=2, progress=False)
    jhist = []
    with open(os.path.join(jcfg.save_path, "LOGS", "metrics.csv")) as f:
        header = f.readline().strip().split(",")
        for line in f:
            jhist.append(dict(zip(header, line.strip().split(","))))
    jckpts = sorted(os.listdir(os.path.join(jcfg.save_path, "Checkpoints")))
    shutil.rmtree(jcfg.save_path)
    init = created[0]
    model = _port_model(jax.tree.map(np.asarray, init.params),
                        jax.tree.map(np.asarray, init.batch_stats))
    root = _calling_path(tmp_path_factory, tree, "port_run")
    cfg = _port_cfg(root)
    before = dict(conv3x3_packed.calls_by_framing), dict(conv3x3_wgrad.calls_by_framing)
    trainer = train_net(cfg, max_epochs=2, progress=False, model=copy.deepcopy(model))
    counts = ({k: v - before[0].get(k, 0) for k, v in conv3x3_packed.calls_by_framing.items()},
              {k: v - before[1].get(k, 0) for k, v in conv3x3_wgrad.calls_by_framing.items()})
    return dict(jax=jt, jcfg=jcfg, jhist=jhist, jckpts=jckpts, jinit=init, port=trainer,
                cfg=cfg, init=model, counts=counts, ckpt=_checkpoints(cfg.save_path))


@pytest.mark.parametrize("epoch", [0, 1])
def test_fit_matches_jax_per_epoch(parity, epoch):
    mine = parity["port"].fit_result.history[epoch]
    theirs = parity["jhist"][epoch]
    rel = FIRST_LOSS_REL if epoch == 0 else LATER_LOSS_REL
    assert mine["tr_loss"] == pytest.approx(float(theirs["tr_loss"]), rel=rel)
    assert mine["val_loss"] == pytest.approx(float(theirs["val_loss"]), rel=LATER_LOSS_REL)
    assert mine["steps"] == 1


def test_kernel_route_and_ingest_fired(parity):
    """Two steps: the ingest conv read the pre-padded buffer in each (forward
    and weight gradient), and every other kernel call was unframed (the port
    hands unframed tensors from conv to conv)."""
    packed, wgrad = parity["counts"]
    assert packed.get("pre_padded") == 2 and wgrad.get("pre_padded") == 2
    assert packed.get("unframed", 0) > 0 and wgrad.get("unframed", 0) > 0
    assert {k for k, v in packed.items() if v} | {k for k, v in wgrad.items() if v} == {
        "pre_padded", "unframed"}


def test_checkpoints_named_and_selected(parity):
    info = parity["ckpt"]
    ckpts = info["ckpts"]
    assert len(ckpts) == len(parity["jckpts"]) == 2 and "last.ckpt" in ckpts
    assert len(info["dice"]) == 1
    best = info["eval"]
    assert os.path.basename(best) in ckpts and "last" not in best
    parsed = checkpoint.parse_ckpt_name(best)
    losses = [h["val_loss"] for h in parity["port"].fit_result.history]
    assert parsed["epoch"] == int(np.argmin(losses))
    assert parsed["val_loss"] == pytest.approx(min(losses), abs=5e-4)
    assert info["resume"].endswith("last.ckpt")
    last = info["last"]
    assert last["epoch"] == 1 and last["count"] == 2
    assert last["keys"] == {"params", "batch_stats", "mu", "nu", "count"}
    assert last["first_conv"] == (3, 3, BANDS, 64)


def test_validate_net_matches_jax_on_the_same_weights(parity, tree, tmp_path_factory):
    """Both sweeps from the same (initial) weights: the curves agree and the
    best threshold is the same."""
    jcfg = parity["jcfg"]
    with jax.disable_jit():
        jp, jr, jth = jevaluate.validate_net(jcfg.get_val_data(), jcfg, trainer=parity["jax"],
                                             state=parity["jinit"], verbose=False)
    root = _calling_path(tmp_path_factory, tree, "port_eval")
    cfg = _port_cfg(root)
    trainer = Trainer(cfg, copy.deepcopy(parity["init"]))
    p, r, th = evaluate.validate_net(cfg.get_val_data(), cfg, trainer=trainer,
                                     state=trainer.state, verbose=False)
    np.testing.assert_allclose(th, np.asarray(jth), atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-3)
    np.testing.assert_allclose(r, np.asarray(jr), atol=1e-3)
    from hyperpri_tpu.ops.metrics import best_threshold_from_pr as jbest
    from hyperpri_tpu_torch.ops.metrics import best_threshold_from_pr

    mine = float(best_threshold_from_pr(*(torch.from_numpy(a) for a in (p, r, th)))[0])
    assert mine == float(jbest(jnp.asarray(jp), jnp.asarray(jr), jnp.asarray(jth))[0])
    assert os.path.exists(os.path.join(cfg.save_path, "pr_curve.csv"))
    results = evaluate.test_net(cfg.get_test_data(), cfg, mine, trainer=trainer,
                                state=trainer.state, verbose=False)
    assert 0.0 <= results["dice"] <= 1.0 and results["conf_mat"].shape == (2, 2)
