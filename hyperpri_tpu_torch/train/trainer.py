"""Training engine: epochs of train steps and validation, early stopping, dual
checkpointing, CSV/TensorBoard logging, resume (port of
hyperpri_tpu/train/trainer.py).

The protocol is the reference's, as the JAX package keeps it: Adam(1e-3),
masked BCE-with-logits, per-epoch validation driving early stopping on
val_loss with `overall` patience and two best-model checkpoints. One step is
train/step.py's (model forward and backward through the CUDA kernels, Adam
update). Host pre-padded ingest (`_ingest_setup`, trainer.py:368-410): when
the first conv takes the packed kernel, the train loader writes each batch
into the framed buffer of CubeNET.ingest_spec and the step reads it in place;
evaluation and prediction keep logical cubes.

SpectralUNET (trainer.py:427-456): `grad_accum_chunks` > 0 takes the chunked
step of train/chunked.py, which only a per-pixel model can take; the
model's `offload` keeps the step's saved residuals in host memory (pinned on
the card, train/step.py save_on_host), the counterpart of
`spectral_offload_policy`; evaluation and prediction run it through
ops/chunked.apply_pixelwise_chunked, whose logits equal the unchunked
eval's (ROADMAP caveat R4).

Not ported (they raise): meshes and ZeRO sharding, optimizer offload, orbax,
feature extraction.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from hyperpri_tpu_torch._device import resolve_device
from hyperpri_tpu_torch.config import ExperimentConfig
from hyperpri_tpu_torch.data.pipeline import DataLoader
from hyperpri_tpu_torch.models.registry import describe_route
from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET
from hyperpri_tpu_torch.ops.chunked import apply_pixelwise_chunked
from hyperpri_tpu_torch.ops.kernels import launches_by_dtype
from hyperpri_tpu_torch.ops.metrics import (
    StatScores,
    accuracy_from_stats,
    dice_from_stats,
    jaccard_from_stats,
)
from hyperpri_tpu_torch.serve import batch_stats_metrics, masked_bce
from hyperpri_tpu_torch.train.checkpoint import (
    DualCheckpointManager,
    find_resume_checkpoint,
    load_checkpoint,
)
from hyperpri_tpu_torch.train.chunked import make_chunked_train_step
from hyperpri_tpu_torch.train.step import make_optimizer, make_train_step
from hyperpri_tpu_torch.utils.logging import ExperimentLogger
from hyperpri_tpu_torch.weights import export_state, load_adam_moments, load_jax_variables

_NOT_PORTED = {
    "mesh_shape": "meshes",
    "zero_shard_opt": "ZeRO-sharded optimizer state",
    "offload_opt_state": "host-offloaded optimizer state",
    "feature_extraction": "feature extraction (frozen backbone)",
}


@dataclass
class TrainState:
    """The model and optimizer a fit updates in place, and its step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclass
class FitResult:
    epochs_run: int
    best_val_loss: float
    best_val_dice: float
    stopped_early: bool
    state: TrainState
    history: List[Dict[str, float]] = field(default_factory=list)


def _epoch_reduce(history) -> Dict[str, float]:
    """Per-step logs -> epoch loss and confusion-count metrics (:249-260)."""
    total_n = float(sum(float(h["n"]) for h in history))
    loss = sum(float(h["loss_sum"]) for h in history) / max(total_n, 1.0)
    stats = StatScores.zeros()
    for h in history:
        stats = stats.merge(StatScores(*(v.cpu() for v in h["stats"])))
    return {
        "loss": loss,
        "acc": float(accuracy_from_stats(stats)),
        "dice": float(dice_from_stats(stats, zero_division=1e-12)),
        "pos_iou": float(jaccard_from_stats(stats)),
    }


def _array_batch(batch):
    return {k: v for k, v in batch.items() if k != "names"}


class Trainer:
    """Epoch-driven fit / validate / predict engine (trainer.py:272-678)."""

    def __init__(self, cfg: ExperimentConfig, model: Optional[nn.Module] = None):
        for attr, what in _NOT_PORTED.items():
            if getattr(cfg, attr, None):
                raise NotImplementedError(f"{what} ({attr}) is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = (model if model is not None else cfg.get_network()).to(self.device)
        per_pixel = isinstance(self.model, SpectralUNET)
        if cfg.grad_accum_chunks > 0 and not per_pixel:
            # the chunked step rasterizes (N, H, W, C) into (1, chunk, 1, C)
            # pixel rows: only valid for per-pixel models
            raise ValueError("grad_accum_chunks requires a per-pixel model "
                             f"(SpectralUNET); got {type(self.model).__name__}")
        if cfg.offload and not per_pixel:
            raise ValueError("offload is SpectralUNET's host-offloaded remat; got "
                             f"{type(self.model).__name__}")
        self.optimizer = make_optimizer(self.model, cfg.optimizer, cfg.learn_rate, cfg.momentum,
                                        cfg.weight_decay)
        self.state = TrainState(self.model, self.optimizer)
        self.profile: Optional[Dict[str, object]] = None
        self.fit_result: Optional[FitResult] = None
        self.loaders: Dict[str, DataLoader] = {}

    def _ingest_setup(self, sample):
        """(pad spec, ingest_hw) when the first conv takes the packed kernel
        for these cubes, else (None, None)."""
        spec_of = getattr(self.model, "ingest_spec", None)
        if spec_of is None:
            return None, None
        _, h, w, _ = sample["image"].shape
        spec = spec_of(h, w)
        return (spec, (h, w)) if spec is not None else (None, None)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _eval_step(self, batch, return_logits: bool = False):
        """Validation: the eval form (running statistics), counts at 0.5
        (trainer.py:229-246). SpectralUNET runs in pixel chunks."""
        if isinstance(self.model, SpectralUNET):
            logits = apply_pixelwise_chunked(self.model, batch["image"])
        else:
            logits = self.model(batch["image"], train=False)
        loss = masked_bce(logits, batch["mask"], batch["valid"])
        n = batch["valid"].sum()
        logs = {"loss_sum": loss * n, "n": n,
                "stats": batch_stats_metrics(logits, batch["mask"], batch["valid"], 0.5)}
        if return_logits:
            logs["logits"] = logits
        return logs

    # -- fit ------------------------------------------------------------------

    def fit(self, train_loader: DataLoader, val_loader: DataLoader,
            resume_from: Optional[str] = None, max_epochs: Optional[int] = None,
            progress: bool = True) -> FitResult:
        cfg = self.cfg
        pad_spec, ingest_hw = self._ingest_setup(train_loader.probe())
        offload = bool(cfg.offload or getattr(self.model, "offload", False))
        if cfg.grad_accum_chunks > 0:
            step = make_chunked_train_step(self.model, self.optimizer, cfg.threshold,
                                           cfg.grad_accum_chunks, offload=offload)
        else:
            step = make_train_step(self.model, self.optimizer, cfg.threshold,
                                   ingest_hw=ingest_hw, offload=offload)
        if progress:
            print(f"route: {describe_route(self.model, cfg.pallas_train)}"
                  + ("; the first conv reads the host pre-padded buffer" if ingest_hw else "")
                  + (f"; {cfg.grad_accum_chunks} pixel chunks a step"
                     if cfg.grad_accum_chunks > 0 else "")
                  + ("; saved residuals offloaded to host memory" if offload else ""))
        ckpt = DualCheckpointManager(cfg.save_path)
        logger = ExperimentLogger(cfg.save_path, hparams=cfg)
        start_epoch, wait = 0, 0
        best_val_loss, best_val_dice = float("inf"), float("-inf")
        if resume_from:
            payload = load_checkpoint(resume_from)
            self.restore_state(resume_from, payload=payload)
            start_epoch = int(payload["epoch"]) + 1
            wait = int(payload["wait"])
            best_val_loss = float(payload["best_val_loss"])
            best_val_dice = float(payload["best_val_dice"])
            ckpt.best_val_loss, ckpt.best_val_dice = best_val_loss, best_val_dice
            if progress:
                print(f"Resumed from {resume_from} at epoch {start_epoch}")
        epochs = max_epochs if max_epochs is not None else cfg.epochs
        stopped, history = False, []
        launched = launches_by_dtype()
        epoch = start_epoch - 1
        try:
            for epoch in range(start_epoch, epochs):
                profiling = bool(cfg.profile_dir) and epoch == start_epoch + 1
                with self._profiler(profiling) as prof:
                    t0 = time.perf_counter()
                    train_loader.set_epoch(epoch)
                    train_hist = []
                    for batch in train_loader.batches(pad_spec):
                        train_hist.append(step(_array_batch(batch)))
                        self.state.step += 1
                    tr = _epoch_reduce(train_hist)   # reads the logs: waits for the device
                    train_time = time.perf_counter() - t0
                    vl = _epoch_reduce([self._eval_step(_array_batch(b)) for b in val_loader])
                    self._sync()
                    epoch_time = time.perf_counter() - t0
                if profiling:
                    self._record_profile(prof, epoch, epoch_time, len(train_hist))
                metrics = {"epoch": epoch, "tr_loss": tr["loss"], "tr_acc": tr["acc"],
                           "tr_dice": tr["dice"], "tr_pos_iou": tr["pos_iou"],
                           "val_loss": vl["loss"], "val_acc": vl["acc"],
                           "val_dice": vl["dice"], "val_pos_iou": vl["pos_iou"],
                           "lr": cfg.learn_rate, "epoch_time": epoch_time,
                           "train_time": train_time, "steps": len(train_hist)}
                logger.log_metrics(metrics, step=epoch)
                history.append(metrics)
                if progress:
                    print(f"epoch {epoch:4d}  tr_loss {tr['loss']:.4f}  val_loss "
                          f"{vl['loss']:.4f}  val_dice {vl['dice']:.4f}  ({epoch_time:.1f}s)")
                if vl["loss"] < best_val_loss:
                    best_val_loss, wait = vl["loss"], 0
                else:
                    wait += 1
                best_val_dice = max(best_val_dice, vl["dice"])
                state = export_state(self.model, self.optimizer)
                payload = {"state": state, "epoch": epoch, "wait": wait,
                           "best_val_loss": best_val_loss, "best_val_dice": best_val_dice}
                weights = {"params": state["params"], "batch_stats": state["batch_stats"]}
                ckpt.step(epoch, vl["loss"], vl["dice"], payload, weights)
                if wait >= cfg.overall:
                    stopped = True
                    if progress:
                        print(f"Early stopping at epoch {epoch} (patience {cfg.overall})")
                    break
        finally:
            logger.close()
        if progress:
            now = launches_by_dtype()
            counts = [f"{name} {dtype} {n - launched.get((name, dtype), 0)}"
                      for (name, dtype), n in now.items() if n > launched.get((name, dtype), 0)]
            print(f"kernel launches in this fit: {', '.join(counts) or 'none'}")
        return FitResult(epochs_run=epoch - start_epoch + 1, best_val_loss=best_val_loss,
                         best_val_dice=best_val_dice, stopped_early=stopped,
                         state=self.state, history=history)

    # -- profiling ------------------------------------------------------------

    def _profiler(self, on: bool):
        """torch.profiler over an epoch (CPU and, on a card, CUDA activity),
        or nothing."""
        if not on:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _record_profile(self, prof, epoch: int, wall_s: float, steps: int):
        """Record device busy time against the epoch's wall time and write a
        Chrome trace into cfg.profile_dir."""
        from torch.autograd import DeviceType

        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        trace = os.path.join(self.cfg.profile_dir, f"epoch{epoch}.trace.json")
        prof.export_chrome_trace(trace)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        self.profile = {
            "epoch": epoch, "steps": steps, "wall_ms": wall_s * 1e3, "busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)) if busy_ms else None,
            "trace": trace,
            "top": [(e.key, e.count, e.self_device_time_total / 1e3) for e in top],
        }

    # -- predict / restore ----------------------------------------------------

    def predict(self, loader: DataLoader):
        """Yield (logits, masks, valid, names) per batch, tensors on the
        device (trainer.py:652-664)."""
        for batch in loader:
            logs = self._eval_step(_array_batch(batch), return_logits=True)
            yield logs["logits"], batch["mask"], batch["valid"], batch.get("names")

    def restore_state(self, path: str, payload=None) -> TrainState:
        """Load a checkpoint (or its already loaded `payload`) into this
        trainer's model: parameters and BatchNorm statistics from a full or
        weights-only file, and the Adam state and step count from a full
        one."""
        raw = load_checkpoint(path) if payload is None else payload
        tree = raw.get("state", raw)
        device = next(self.model.parameters()).device
        load_jax_variables(self.model, tree["params"], tree["batch_stats"])
        self.model.to(device)
        if "mu" in tree:
            load_adam_moments(self.model, self.optimizer, tree["mu"], tree["nu"],
                              int(tree["count"]))
            self.state.step = int(tree["count"])
        return self.state


def train_net(params: ExperimentConfig, checkpoint: Optional[bool] = None,
              model_parallel: bool = False, max_epochs: Optional[int] = None,
              progress: bool = True, model: Optional[nn.Module] = None) -> Trainer:
    """Entry point mirroring the reference's train_net(params, checkpoint,
    model_parallel) (trainer.py:703-756). Returns the Trainer, with the fit's
    result in `fit_result`. `model` replaces cfg.get_network()."""
    if model_parallel:
        raise NotImplementedError("model_parallel (meshes, ZeRO) is not ported yet")
    cfg = params
    trainer = Trainer(cfg, model)
    image_dtype = torch.bfloat16 if cfg.precision == "bf16" else None
    train_loader = DataLoader(cfg.get_train_data(), cfg.b_size["train"], shuffle=True,
                              seed=cfg.run_num, device=trainer.device, image_dtype=image_dtype)
    val_loader = DataLoader(cfg.get_val_data(), cfg.b_size["val"], shuffle=False,
                            device=trainer.device, image_dtype=image_dtype)
    resume = find_resume_checkpoint(cfg.save_path) if checkpoint else None
    trainer.loaders = {"train": train_loader, "val": val_loader}
    trainer.fit_result = trainer.fit(train_loader, val_loader, resume_from=resume,
                                     max_epochs=max_epochs, progress=progress)
    return trainer
