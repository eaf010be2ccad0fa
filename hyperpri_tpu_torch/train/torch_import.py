"""Import the reference's PyTorch checkpoints into the port's models (port of
hyperpri_tpu/train/torch_import.py).

The reference's eval-time checkpoint resolution takes three formats: Lightning
.ckpt files, raw .pt state dicts ('module.*' or bare keys) and DeepSpeed
ZeRO-2 directories. Their keys (`inc.double_conv.0.weight`,
`down1.maxpool_conv.1.double_conv.*`, ...) are converted here into the flax-path
numpy trees the JAX package's `convert_state_dict` returns, and those trees
go into the model through weights.load_jax_variables, the one loader of flax
trees (it turns flax kernels into the port's layouts and checks that every
leaf is used and every entry filled). Layout transforms, as in the JAX
package:

  torch Conv2d  (O, I, kh, kw)      -> flax Conv kernel (kh, kw, I, O)
  torch Conv3d  (O, 1, D, kh, kw)   -> flax Conv kernel (kh, kw, D, O)
                                       (CubeNET's spectral collapse: a 2D conv)
  torch ConvT2d (I, O, kh, kw)      -> flax ConvTranspose kernel (kh, kw, I, O),
                                       spatially flipped (flax does not flip)
  torch Linear  (O, I)              -> flax Dense kernel (I, O)
  torch BN weight/bias/running_*    -> flax BatchNorm scale/bias + batch_stats

Loading: a raw .pt or Lightning .ckpt is read by checkpoint.load_torch_file,
with weights_only=True; only a Lightning .ckpt whose hyper-parameters or loop
state the safe load refuses is read again with weights_only=False, which is
full unpickling: load only checkpoints you trust. A ZeRO-2 directory's files
are always fully unpickled, as DeepSpeed writes them with its own objects.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from hyperpri_tpu_torch.train.checkpoint import load_torch_file
from hyperpri_tpu_torch.weights import load_jax_variables

_DC = {"conv1": ("0", "conv"), "bn1": ("1", "bn"), "conv2": ("3", "conv"), "bn2": ("4", "bn")}


def _double_conv_map(flax_prefix: str, torch_prefix: str) -> Dict[str, Tuple[str, str]]:
    return {f"{flax_prefix}/{fname}": (f"{torch_prefix}.{tidx}", kind)
            for fname, (tidx, kind) in _DC.items()}


def module_map(model_name: str, cfg=None) -> Dict[str, Tuple[str, str]]:
    """flax module path -> (torch module prefix, kind in conv|conv3d|convT|linear|bn)."""
    name = model_name.lower()
    m: Dict[str, Tuple[str, str]] = {}
    if name in ("unet", "unet+"):
        m.update(_double_conv_map("inc", "inc.double_conv"))
        for k in range(1, 5):
            m.update(_double_conv_map(f"down{k}/conv", f"down{k}.maxpool_conv.1.double_conv"))
            m[f"up{k}/up"] = (f"up{k}.up", "convT")
            m.update(_double_conv_map(f"up{k}/conv", f"up{k}.conv.double_conv"))
        m["outc/conv"] = ("outc.conv", "conv")
        return m
    if name == "spectralunet":
        for blk in ["tail", "down1", "down2", "down3", "down4", "up1", "up2", "up3", "up4"]:
            m[f"{blk}/linear"] = (f"{blk}.0", "linear")
            m[f"{blk}/bn"] = (f"{blk}.1", "bn")
        m["outc"] = ("outc", "linear")
        return m
    if name == "cubenet":
        m["first_conv"] = ("first_conv", "conv3d")
        m["first_bn"] = ("inc.1", "bn")
        m["inc2_conv"] = ("inc2.0", "conv")
        m["inc2_bn"] = ("inc2.1", "bn")
        for k in range(1, 5):
            m.update(_double_conv_map(f"down{k}/conv", f"down{k}.maxpool_conv.1.double_conv"))
        for k in range(1, 4):
            m[f"up{k}/up"] = (f"up{k}.up", "convT")
            m.update(_double_conv_map(f"up{k}/conv", f"up{k}.conv.double_conv"))
        if (getattr(cfg, "cube_featmaps", 64) if cfg is not None else 64) == 64:
            m["up4/up"] = ("up4.up", "convT")
            m.update(_double_conv_map("up4/conv", "up4.conv.double_conv"))
        else:
            m["upsample4"] = ("upsample4", "convT")
            m.update(_double_conv_map("upconv4", "upconv4.double_conv"))
        m["outc/conv"] = ("outc.conv", "conv")
        return m
    raise ValueError(f"no torch mapping for model {model_name!r}")


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else t)


def convert_state_dict(torch_sd: Dict[str, Any], model_name: str,
                       cfg=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference-keyed state dict -> (flax params, flax batch_stats) as nested
    dicts of numpy arrays under flax paths and layouts."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    def put(tree, path, leaf, value):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node[leaf] = value

    for flax_path, (tprefix, kind) in module_map(model_name, cfg).items():
        weight = _np(torch_sd[f"{tprefix}.weight"])
        bias = _np(torch_sd[f"{tprefix}.bias"])
        if kind == "conv":
            put(params, flax_path, "kernel", np.transpose(weight, (2, 3, 1, 0)))
        elif kind == "conv3d":
            put(params, flax_path, "kernel", np.transpose(weight[:, 0], (2, 3, 1, 0)))
        elif kind == "convT":
            # flax's ConvTranspose applies its kernel unflipped, torch's flips it
            put(params, flax_path, "kernel",
                np.transpose(weight, (2, 3, 0, 1))[::-1, ::-1].copy())
        elif kind == "linear":
            put(params, flax_path, "kernel", weight.T)
        elif kind == "bn":
            put(params, flax_path, "scale", weight)
            put(batch_stats, flax_path, "mean", _np(torch_sd[f"{tprefix}.running_mean"]))
            put(batch_stats, flax_path, "var", _np(torch_sd[f"{tprefix}.running_var"]))
        else:  # pragma: no cover
            raise ValueError(kind)
        put(params, flax_path, "bias", bias)
    return params, batch_stats


def normalize_torch_keys(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the reference's wrappers: Lightning payloads nest under
    'state_dict'; keys may carry '_forward_module.m_network.', 'm_network.'
    or 'module.'; the frozen 'feat_ext' keys are dropped."""
    if "pytorch-lightning_version" in raw:
        raw = raw["state_dict"]
    out = {}
    for k, v in raw.items():
        for prefix in ("_forward_module.m_network.", "m_network.", "module."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        if "feat_ext" in k:
            continue
        out[k] = v
    return out


def _load_into(trainer, cfg, sd: Dict[str, Any]):
    params, batch_stats = convert_state_dict(sd, cfg.model_name, cfg)
    device = next(trainer.model.parameters()).device
    load_jax_variables(trainer.model, params, batch_stats)
    trainer.model.to(device)
    return trainer.state


def load_torch_checkpoint_state(trainer, cfg, path: str, raw=None):
    """Load a reference .pt / .ckpt file (or its already loaded payload
    `raw`) into the trainer's model; -> the trainer's state."""
    raw = load_torch_file(path) if raw is None else raw
    return _load_into(trainer, cfg, normalize_torch_keys(raw))


def _zero_rank(path: str) -> int:
    m = re.search(r"zero_pp_rank_(\d+)_", os.path.basename(path))
    if m is None:
        raise ValueError(f"no rank in the ZeRO-2 shard name {path}")
    return int(m.group(1))


def consolidate_zero2_dir(ckpt_dir: str) -> Dict[str, Any]:
    """Merge a DeepSpeed ZeRO-2 checkpoint directory into one float32 state
    dict, without DeepSpeed:

      <dir>/latest                      text file naming the tag subdir
      <dir>/<tag>/mp_rank_00_model_states.pt
          'module'       the full module state dict (bf16 under 'bf16-mixed')
          'param_shapes' per optimizer group an OrderedDict {name: shape}
      <dir>/<tag>/zero_pp_rank_<R>_mp_rank_00_optim_states.pt
          ['optimizer_state_dict']['single_partition_of_fp32_groups']
          = per group the 1-D float32 master shard of rank R (each group's
            parameters flattened in param_shapes order, zero-padded to a
            multiple of the world size)

    The float32 masters overwrite the module copies; BatchNorm buffers
    (running_mean/var) exist only in 'module'. Every file is fully unpickled."""
    tag = None
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            tag = f.read().strip()
    if tag and os.path.isdir(os.path.join(ckpt_dir, tag)):
        root = os.path.join(ckpt_dir, tag)
    else:
        hits = glob.glob(os.path.join(ckpt_dir, "**", "*model_states.pt"), recursive=True)
        if not hits:
            raise FileNotFoundError(f"no *model_states.pt under {ckpt_dir}")
        root = os.path.dirname(sorted(hits)[0])

    ms = torch.load(os.path.join(root, "mp_rank_00_model_states.pt"), map_location="cpu",
                    weights_only=False)
    sd = {k: v.float() if isinstance(v, torch.Tensor) else v for k, v in ms["module"].items()}
    # by rank as a number: zero_pp_rank_10_* follows zero_pp_rank_9_*
    optim_files = sorted(glob.glob(os.path.join(root, "*_optim_states.pt")),
                         key=_zero_rank)
    param_shapes = ms.get("param_shapes")
    if optim_files and param_shapes:
        per_rank = [torch.load(f, map_location="cpu", weights_only=False)
                    ["optimizer_state_dict"]["single_partition_of_fp32_groups"]
                    for f in optim_files]
        for g, shapes in enumerate(param_shapes):
            flat = torch.cat([torch.as_tensor(r[g]).float().flatten() for r in per_rank])
            offset = 0
            for name, shape in shapes.items():
                numel = int(np.prod(tuple(shape)))
                sd[name] = flat[offset:offset + numel].view(tuple(shape))
                offset += numel
            # what lies past `offset` is the world-size padding
    return sd


def load_zero2_checkpoint_state(trainer, cfg, ckpt_dir: str):
    """Load a DeepSpeed ZeRO-2 directory into the trainer's model."""
    return _load_into(trainer, cfg, normalize_torch_keys(consolidate_zero2_dir(ckpt_dir)))
