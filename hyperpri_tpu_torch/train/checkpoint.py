"""Checkpointing: the dual best-model policy and resume (port of
hyperpri_tpu/train/checkpoint.py), with the JAX package's file names:

  - Checkpoints/      best-val_loss FULL state (model, BatchNorm statistics,
                      Adam state, epoch/wait/best counters) as
                      `epoch={e}-val_loss={l:.3f}-val_dice={d:.3f}.ckpt`, plus
                      `last.ckpt` every epoch;
  - diceCheckpoints/  best-val_dice WEIGHTS-ONLY state.

A payload is a torch.save file of nested dicts whose keys are the flax paths
of hyperpri_tpu_torch/weights.py ("params"/"first_conv"/"kernel", ...) and
whose leaves are CPU tensors in flax's layouts: weights.load_jax_variables
reads it back, and it loads with torch.load(weights_only=True).

The reference's checkpoints (a Lightning .ckpt, a raw .pt state dict, a
DeepSpeed ZeRO-2 directory) are torch files or directories too, so
detect_checkpoint_format decides by content (checkpoint.py:38-61 decides by
magic bytes, which cannot tell the port's torch.save files from the
reference's). train/torch_import.py loads the reference's formats.
"""

from __future__ import annotations

import os
import pickle
import pickletools
import re
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(path: str, payload: Any) -> None:
    """Write beside the target and rename: a reader never sees half a file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


LIGHTNING_KEY = "pytorch-lightning_version"


def _is_lightning_file(path: str) -> bool:
    """Whether the torch.save zip at `path` is a Lightning checkpoint: its
    pickle stream holds the string LIGHTNING_KEY. The stream is read opcode by
    opcode (pickletools.genops), never executed."""
    try:
        with zipfile.ZipFile(path) as z:
            name = next(n for n in z.namelist() if n.endswith("/data.pkl"))
            stream = z.read(name)
        return any(arg == LIGHTNING_KEY for _, arg, _ in pickletools.genops(stream))
    except (zipfile.BadZipFile, StopIteration, ValueError):
        return False


def load_torch_file(path: str) -> Any:
    """torch.load on the CPU, with the load chosen by format:

      - every file is first loaded with weights_only=True (tensors and
        containers only): the port's own payloads and the reference's raw
        .pt state dicts;
      - a Lightning .ckpt (its pickle stream names LIGHTNING_KEY, found
        without unpickling it) whose safe load fails on its hyper-parameters
        or loop state is loaded with weights_only=False, which is FULL
        UNPICKLING: evaluate only Lightning checkpoints you trust;
      - any other file whose safe load fails raises pickle.UnpicklingError
        and is never fully unpickled.

    (A ZeRO-2 directory's files are loaded by torch_import.consolidate_zero2_dir,
    always with full unpickling.)"""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not _is_lightning_file(path):
            raise pickle.UnpicklingError(
                f"{path}: holds objects other than tensors and containers and is "
                f"not a Lightning checkpoint, so it is not unpickled ({e})") from None
        return torch.load(path, map_location="cpu", weights_only=False)


def _payload_format(payload: Any) -> str:
    """'port' for the port's own payload (top level "params" or "state"),
    'torch' for the reference's (a Lightning payload, a "state_dict", or
    flat dotted keys of tensors); raises for anything else."""
    if isinstance(payload, dict):
        if "params" in payload or "state" in payload:
            return "port"
        if LIGHTNING_KEY in payload or "state_dict" in payload:
            return "torch"
        if payload and all(isinstance(k, str) and "." in k for k in payload) and all(
                isinstance(v, torch.Tensor) for v in payload.values()):
            return "torch"
    raise ValueError("neither the port's checkpoint nor a reference state dict: "
                     f"{type(payload).__name__} with keys "
                     f"{list(payload)[:5] if isinstance(payload, dict) else None}")


def read_checkpoint(path: str) -> Tuple[str, Any]:
    """-> (format, payload): ('zero_dir', None) for a directory (a DeepSpeed
    ZeRO-2 checkpoint), else the file's payload (load_torch_file) and its
    format, 'port' or 'torch' (_payload_format)."""
    if os.path.isdir(path):
        return "zero_dir", None
    payload = load_torch_file(path)
    try:
        return _payload_format(payload), payload
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def detect_checkpoint_format(path: str) -> str:
    """'zero_dir' | 'port' | 'torch', decided by content, not extension (the
    reference's files are .ckpt and .pt alike, and so are the port's)."""
    return read_checkpoint(path)[0]


class DualCheckpointManager:
    """Best-val_loss full checkpoints + best-val_dice weight checkpoints."""

    def __init__(self, save_path: str, save_last: bool = True):
        self.ckpt_dir = os.path.join(save_path, "Checkpoints")
        self.dice_dir = os.path.join(save_path, "diceCheckpoints")
        self.save_last = save_last
        self.best_val_loss = float("inf")
        self.best_val_dice = float("-inf")
        self._best_loss_file: Optional[str] = None
        self._best_dice_file: Optional[str] = None

    @staticmethod
    def _fname(epoch: int, val_loss: float, val_dice: float) -> str:
        return f"epoch={epoch}-val_loss={val_loss:.3f}-val_dice={val_dice:.3f}.ckpt"

    def step(self, epoch: int, val_loss: float, val_dice: float, full_state: Any,
             weights_state: Any) -> Dict[str, bool]:
        """Call once per epoch after validation. Returns which bests updated."""
        out = {"best_loss": False, "best_dice": False}
        name = self._fname(epoch, val_loss, val_dice)
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            new = os.path.join(self.ckpt_dir, name)
            save_checkpoint(new, full_state)
            if self._best_loss_file and os.path.exists(self._best_loss_file):
                os.remove(self._best_loss_file)  # save_top_k=1
            self._best_loss_file = new
            out["best_loss"] = True
        if val_dice > self.best_val_dice:
            self.best_val_dice = val_dice
            new = os.path.join(self.dice_dir, name)
            save_checkpoint(new, weights_state)
            if self._best_dice_file and os.path.exists(self._best_dice_file):
                os.remove(self._best_dice_file)
            self._best_dice_file = new
            out["best_dice"] = True
        if self.save_last:
            save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"), full_state)
        return out


def _newest(directory: str, keep) -> Optional[str]:
    best, best_t = None, -1.0
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if keep(name) and os.path.getmtime(path) > best_t:
            best, best_t = path, os.path.getmtime(path)
    return best


def find_resume_checkpoint(save_path: str) -> Optional[str]:
    """Newest `last*` checkpoint for crash resume (checkpoint.py:136-157)."""
    load_path = os.path.join(save_path, "Checkpoints")
    if not os.path.exists(load_path):
        return None
    return _newest(load_path, lambda name: "last" in name)


def find_eval_checkpoint(save_path: str) -> Optional[str]:
    """Newest non-`last` checkpoint in Checkpoints/, else last.ckpt, else
    best_wts.pt beside them (checkpoint.py:160-176)."""
    load_path = os.path.join(save_path, "Checkpoints")
    if os.path.exists(load_path):
        best = _newest(load_path, lambda name: "last" not in name)
        if best is not None:
            return best
        last = os.path.join(load_path, "last.ckpt")
        return last if os.path.exists(last) else None
    alt = os.path.join(save_path, "best_wts.pt")
    return alt if os.path.exists(alt) else None


def parse_ckpt_name(path: str) -> Dict[str, float]:
    m = re.match(r"epoch=(\d+)-val_loss=([-\d.]+)-val_dice=([-\d.]+)\.ckpt",
                 os.path.basename(path))
    if not m:
        return {}
    return {"epoch": int(m.group(1)), "val_loss": float(m.group(2)),
            "val_dice": float(m.group(3))}
