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

Meshes (trainer.py:275-305, :309-360, :379-388, :413-470): with
`cfg.mesh_shape` (or a `mesh=`) one process per device trains on a
('data', 'spatial') mesh of parallel/mesh.py, NCCL on the card and gloo on
the CPU. The model takes the mesh as its `spatial_mesh`, every rank starts
from rank 0's parameters, the loaders give each rank its samples and rows,
the step sums the gradients of the globally normalized loss over the mesh,
and the logs are reduced over it. `zero_shard_opt` keeps each data rank's
slice of the Adam moments (parallel/sharding.ZeroOptimizer) and
`offload_opt_state` keeps them in pinned host memory between steps. Only
the mesh's first rank writes checkpoints and logs, after a barrier-closed
gather of the whole state: a checkpoint is the single-device format, so a
run resumes at another mesh shape or on one device. The host pre-padded
ingest stays on data-only meshes, where each rank's geometry is the single
device's. `grad_accum_chunks` under a mesh raises, as in the JAX package.

Not ported (they raise): feature extraction, the offline Comet archive
(comet_logging). `orbax_under_mesh` changes no format: checkpoints under a
mesh are the port's torch.save files, as on one device.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
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
from hyperpri_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    init_distributed,
    launched_world,
    make_mesh,
)
from hyperpri_tpu_torch.parallel.sharding import (
    ZeroOptimizer,
    estimate_zero_savings,
    moments_tree_shapes,
)
from hyperpri_tpu_torch.serve import masked_bce, step_logs
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
    "feature_extraction": "feature extraction (frozen backbone)",
    "comet_logging": "the offline Comet archive",
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

    def __init__(self, cfg: ExperimentConfig, model: Optional[nn.Module] = None,
                 mesh: Optional[Mesh] = None):
        for attr, what in _NOT_PORTED.items():
            if getattr(cfg, attr, None):
                raise NotImplementedError(f"{what} ({attr}) is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if mesh is not None or cfg.mesh_shape:
            self.device = init_distributed(self.device)
            mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, self.device.type)
        self.mesh = mesh
        self.model = (model if model is not None else cfg.get_network()).to(self.device)
        per_pixel = isinstance(self.model, SpectralUNET)
        if mesh is not None:
            if cfg.grad_accum_chunks > 0:
                raise ValueError("grad_accum_chunks is a single-device memory-control path; "
                                 "under a mesh use spatial sharding (--model-shard) instead")
            self.model.spatial_mesh = mesh
            with torch.no_grad():   # every rank starts from the first rank's state
                mesh.broadcast_(list(self.model.parameters()) + list(self.model.buffers()))
        if cfg.grad_accum_chunks > 0 and not per_pixel:
            # the chunked step rasterizes (N, H, W, C) into (1, chunk, 1, C)
            # pixel rows: only valid for per-pixel models
            raise ValueError("grad_accum_chunks requires a per-pixel model "
                             f"(SpectralUNET); got {type(self.model).__name__}")
        if cfg.offload and not per_pixel:
            raise ValueError("offload is SpectralUNET's host-offloaded remat; got "
                             f"{type(self.model).__name__}")
        def inner(params):
            return make_optimizer(params, cfg.optimizer, cfg.learn_rate, cfg.momentum,
                                  cfg.weight_decay)

        if cfg.zero_shard_opt or cfg.offload_opt_state:
            self.optimizer = ZeroOptimizer(self.model, inner,
                                           mesh if cfg.zero_shard_opt else None,
                                           offload=cfg.offload_opt_state)
        else:
            self.optimizer = inner(self.model)
        self.state = TrainState(self.model, self.optimizer)
        self.profile: Optional[Dict[str, object]] = None
        self.fit_result: Optional[FitResult] = None
        self.loaders: Dict[str, DataLoader] = {}

    @property
    def is_main(self) -> bool:
        """True on the rank that writes checkpoints and logs (the mesh's
        first, or the only one)."""
        return self.mesh is None or dist.get_rank() == self.mesh.rank_at(0, 0)

    def effective_batch(self, b: int) -> int:
        """b rounded up to a multiple of the mesh's data axis, so that the
        global batch splits evenly (trainer.py:309-315); the fill samples
        carry valid = 0."""
        if self.mesh is None:
            return b
        return math.ceil(b / self.mesh.data) * self.mesh.data

    def _barrier(self):
        if self.mesh is not None:
            self.mesh.all_reduce_(torch.zeros(1, device=self.device))

    def _ingest_setup(self, sample):
        """(pad spec, ingest_hw) when the first conv takes the packed kernel
        for these cubes, else (None, None). Under a mesh only a data-only
        one keeps it: an H-sharded buffer would break the framing."""
        spec_of = getattr(self.model, "ingest_spec", None)
        if spec_of is None or (self.mesh is not None and self.mesh.spatial > 1):
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
        loss = masked_bce(logits, batch["mask"], batch["valid"], self.mesh)
        logs = step_logs(loss, logits, batch, 0.5, self.mesh)
        if return_logits:
            logs["logits"] = logits
        return logs

    # -- fit ------------------------------------------------------------------

    def fit(self, train_loader: DataLoader, val_loader: DataLoader,
            resume_from: Optional[str] = None, max_epochs: Optional[int] = None,
            progress: bool = True) -> FitResult:
        cfg = self.cfg
        progress = progress and self.is_main
        pad_spec, ingest_hw = self._ingest_setup(train_loader.probe())
        offload = bool(cfg.offload or getattr(self.model, "offload", False))
        if cfg.grad_accum_chunks > 0:
            step = make_chunked_train_step(self.model, self.optimizer, cfg.threshold,
                                           cfg.grad_accum_chunks, offload=offload)
        else:
            step = make_train_step(self.model, self.optimizer, cfg.threshold,
                                   ingest_hw=ingest_hw, offload=offload, mesh=self.mesh)
        if progress:
            print(f"route: {describe_route(self.model, cfg.pallas_train)}"
                  + ("; the first conv reads the host pre-padded buffer" if ingest_hw else "")
                  + (f"; {cfg.grad_accum_chunks} pixel chunks a step"
                     if cfg.grad_accum_chunks > 0 else "")
                  + ("; saved residuals offloaded to host memory" if offload else "")
                  + self._describe_mesh())
        ckpt = DualCheckpointManager(cfg.save_path) if self.is_main else None
        logger = ExperimentLogger(cfg.save_path, hparams=cfg) if self.is_main else None
        start_epoch, wait = 0, 0
        best_val_loss, best_val_dice = float("inf"), float("-inf")
        if resume_from:
            payload = load_checkpoint(resume_from)
            self.restore_state(resume_from, payload=payload)
            start_epoch = int(payload["epoch"]) + 1
            wait = int(payload["wait"])
            best_val_loss = float(payload["best_val_loss"])
            best_val_dice = float(payload["best_val_dice"])
            if ckpt is not None:
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
                if logger is not None:
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
                # every rank takes part in gathering the ZeRO slices
                if ckpt is not None or isinstance(self.optimizer, ZeroOptimizer):
                    state = export_state(self.model, self.optimizer)
                if ckpt is not None:
                    payload = {"state": state, "epoch": epoch, "wait": wait,
                               "best_val_loss": best_val_loss, "best_val_dice": best_val_dice}
                    weights = {"params": state["params"], "batch_stats": state["batch_stats"]}
                    ckpt.step(epoch, vl["loss"], vl["dice"], payload, weights)
                self._barrier()
                if wait >= cfg.overall:
                    stopped = True
                    if progress:
                        print(f"Early stopping at epoch {epoch} (patience {cfg.overall})")
                    break
        finally:
            if logger is not None:
                logger.close()
        if progress:
            now = launches_by_dtype()
            counts = [f"{name} {dtype} {n - launched.get((name, dtype), 0)}"
                      for (name, dtype), n in now.items() if n > launched.get((name, dtype), 0)]
            print(f"kernel launches in this fit: {', '.join(counts) or 'none'}")
        return FitResult(epochs_run=epoch - start_epoch + 1, best_val_loss=best_val_loss,
                         best_val_dice=best_val_dice, stopped_early=stopped,
                         state=self.state, history=history)

    def _describe_mesh(self) -> str:
        text = ""
        if self.mesh is not None:
            text = (f"; mesh data {self.mesh.data} x spatial {self.mesh.spatial} "
                    f"({dist.get_backend()})")
        if isinstance(self.optimizer, ZeroOptimizer):
            d = self.mesh.data if self.optimizer.mesh is not None else 1
            share = estimate_zero_savings(moments_tree_shapes(self.model), d)
            text += (f"; optimizer state {share:.1%} sharded over {d} data ranks"
                     + (", in pinned host memory between steps" if self.cfg.offload_opt_state
                        else ""))
        return text

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
        device (trainer.py:652-664). Under a mesh each rank computes its
        shard, and every rank yields the whole global batch."""
        for batch in loader:
            logs = self._eval_step(_array_batch(batch), return_logits=True)
            logits, masks, valid = logs["logits"], batch["mask"], batch["valid"]
            names = batch.get("names")
            if self.mesh is not None:
                logits, masks = (self.mesh.all_gather(self.mesh.all_gather(t, SPATIAL_AXIS, 1),
                                                      DATA_AXIS, 0) for t in (logits, masks))
                valid = self.mesh.all_gather(valid, DATA_AXIS, 0)
                parts = [None] * self.mesh.data
                dist.all_gather_object(parts, names, group=self.mesh.group(DATA_AXIS))
                names = [name for part in parts for name in part]
            yield logits, masks, valid, names

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
    result in `fit_result`. `model` replaces cfg.get_network(). Under torchrun
    every rank calls it."""
    cfg = params
    if model_parallel:
        # MODEL_SHARD=True (trainer.py:716-728): bf16, ZeRO-sharded Adam state
        # (offloaded with test_deepspeed) and, unless given, a mesh of the
        # launched world that gives the data axis what the batch divides
        cfg.precision = "bf16"
        cfg.zero_shard_opt = True
        if cfg.test_deepspeed:
            cfg.offload_opt_state = True
        if cfg.mesh_shape is None:
            world = launched_world()[1]
            data = math.gcd(cfg.b_size["train"], world)
            cfg.mesh_shape = {"data": data, "spatial": world // data}
    trainer = Trainer(cfg, model)
    image_dtype = torch.bfloat16 if cfg.precision == "bf16" else None
    train_loader = DataLoader(cfg.get_train_data(), trainer.effective_batch(cfg.b_size["train"]),
                              shuffle=True, seed=cfg.run_num, device=trainer.device,
                              image_dtype=image_dtype, mesh=trainer.mesh)
    val_loader = DataLoader(cfg.get_val_data(), trainer.effective_batch(cfg.b_size["val"]),
                            shuffle=False, device=trainer.device, image_dtype=image_dtype,
                            mesh=trainer.mesh)
    resume = find_resume_checkpoint(cfg.save_path) if checkpoint else None
    trainer.loaders = {"train": train_loader, "val": val_loader}
    trainer.fit_result = trainer.fit(train_loader, val_loader, resume_from=resume,
                                     max_epochs=max_epochs, progress=progress)
    return trainer
