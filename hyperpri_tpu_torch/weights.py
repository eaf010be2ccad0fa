"""Carry the JAX package's flax variables into the port's modules, and the
port's parameters, gradients and optimizer state back out under flax paths.

The flax trees arrive as nested dicts of numpy arrays keyed exactly like the
flax tree (`first_conv/kernel`, `down1/conv/conv1/kernel`, `up1/up/kernel`,
`outc/conv/kernel`, `tail/linear/kernel`, ...). A port module's dotted name
is its flax path.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from hyperpri_tpu_torch.models.parts import ConvTransposeUp, TorchBatchNorm, _Conv


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for name, child in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(child, dict):
            flat.update(_flatten(child, path))
        else:
            flat[path] = np.asarray(child)
    return flat


def _torch_leaves(module: nn.Module):
    """(torch leaf, collection, flax leaf, layout transform) for one module.
    Each transform is its own inverse's mirror: `_to_flax` undoes it."""
    if isinstance(module, TorchBatchNorm):
        return [("weight", "params", "scale", None), ("bias", "params", "bias", None),
                ("running_mean", "batch_stats", "mean", None),
                ("running_var", "batch_stats", "var", None)]
    if isinstance(module, ConvTransposeUp):
        # flax (2, 2, C, O) under lax.conv_transpose is unflipped; torch's
        # ConvTranspose2d weight is (C, O, 2, 2) of the spatially flipped kernel.
        def convt(k):
            return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
        return [("weight", "params", "kernel", convt), ("bias", "params", "bias", None)]
    if isinstance(module, _Conv):
        def conv(k):
            return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW
        return [("weight", "params", "kernel", conv), ("bias", "params", "bias", None)]
    if isinstance(module, nn.Linear):
        # flax Dense's kernel is (in, out), torch's weight (out, in)
        return [("weight", "params", "kernel", np.transpose), ("bias", "params", "bias", None)]
    return []


def load_jax_variables(model: nn.Module, params: dict,
                       batch_stats: Optional[dict] = None) -> nn.Module:
    """Fill `model` from flax `params` (and `batch_stats` for an unfolded
    model). Raises if a flax leaf goes unused, a port parameter or buffer is
    left unfilled, or a shape disagrees."""
    trees = {"params": _flatten(params), "batch_stats": _flatten(batch_stats or {})}
    used = {"params": set(), "batch_stats": set()}
    state: Dict[str, torch.Tensor] = {}
    for name, module in model.named_modules():
        for leaf, collection, flax_leaf, transform in _torch_leaves(module):
            path = "/".join(name.split(".") + [flax_leaf]) if name else flax_leaf
            key = f"{name}.{leaf}" if name else leaf
            if path not in trees[collection]:
                raise KeyError(f"{collection} has no {path} for {key}")
            value = trees[collection][path]
            if transform is not None:
                value = transform(value)
            state[key] = torch.tensor(np.ascontiguousarray(value, dtype=np.float32))
            used[collection].add(path)
    for collection, flat in trees.items():
        unused = sorted(set(flat) - used[collection])
        if unused:
            raise ValueError(f"unused {collection} leaves: {unused}")
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    if missing:
        raise ValueError(f"port entries not filled: {missing}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: flax shape {tuple(value.shape)} != port shape "
                             f"{tuple(expected[key].shape)}")
    model.load_state_dict(state, strict=True)
    return model


def flax_axes(module: nn.Module, ndim: int) -> tuple:
    """For a leaf of `module` with `ndim` dimensions in torch's layout: the
    torch dimension that each of its flax dimensions is, in flax's order."""
    if isinstance(module, nn.Linear) and ndim == 2:
        return (1, 0)  # (out, in) -> (in, out)
    if ndim != 4:
        return tuple(range(ndim))
    if isinstance(module, ConvTransposeUp):
        return (2, 3, 0, 1)  # (C, O, 2, 2) -> (2, 2, C, O), flipped below
    return (2, 3, 1, 0)  # OIHW -> HWIO


def _to_flax(module: nn.Module, value: np.ndarray) -> np.ndarray:
    """A conv or Dense weight (or anything of its layout: gradient, Adam
    moment) from torch's layout back to flax's; other leaves are unchanged."""
    value = np.transpose(value, flax_axes(module, value.ndim))
    if isinstance(module, ConvTransposeUp) and value.ndim == 4:
        return value[::-1, ::-1]  # the unflipped kernel of lax.conv_transpose
    return value


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def export_flax_trees(model: nn.Module,
                      optimizer: Optional[torch.optim.Optimizer] = None) -> Dict[str, dict]:
    """The way back, for comparing leaf by leaf with the JAX package: nested
    dicts of numpy arrays under flax paths and layouts (HWIO kernels, the
    conv-transpose flip). Keys: "params", "batch_stats", "grads" (parameters
    that hold a gradient) and, given a torch.optim.Adam, "mu" and "nu" (its
    first and second moments, optax's names)."""
    return _flax_trees(model, _optimizer_states(optimizer))


def _flax_trees(model: nn.Module, states: dict) -> Dict[str, dict]:
    flat: Dict[str, Dict[str, np.ndarray]] = {
        k: {} for k in ("params", "batch_stats", "grads", "mu", "nu")}

    def put(kind, path, module, tensor):
        value = tensor.detach().to("cpu", torch.float32).numpy()
        # a copy: the arrays must not follow later in-place updates of the model
        flat[kind][path] = np.array(_to_flax(module, value), order="C", copy=True)

    for name, module in model.named_modules():
        for leaf, collection, flax_leaf, _ in _torch_leaves(module):
            path = "/".join(name.split(".") + [flax_leaf]) if name else flax_leaf
            tensor = getattr(module, leaf)
            put(collection, path, module, tensor)
            if collection != "params":
                continue
            if tensor.grad is not None:
                put("grads", path, module, tensor.grad)
            state = states.get(tensor, {})
            if "exp_avg" in state:
                put("mu", path, module, state["exp_avg"])
                put("nu", path, module, state["exp_avg_sq"])
    return {kind: _nest(leaves) for kind, leaves in flat.items()}


def _optimizer_states(optimizer) -> dict:
    """{parameter: its optimizer state, whole}: a torch optimizer's `state`,
    or a ZeroOptimizer's slices gathered over the mesh (a collective: every
    rank of the mesh calls it)."""
    if optimizer is None:
        return {}
    if hasattr(optimizer, "full_state"):
        return optimizer.full_state()
    return optimizer.state


def _tensors(tree):
    """Nested dicts of numpy arrays -> of CPU tensors (torch.load with
    weights_only=True takes tensors, not numpy arrays)."""
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def export_state(model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """A checkpoint's state: "params" and "batch_stats" under flax paths and
    layouts, and with an Adam optimizer its moments "mu", "nu" and step
    count "count" (optax's names), all as CPU tensors."""
    states = _optimizer_states(optimizer)
    trees = _flax_trees(model, states)
    state = {k: _tensors(trees[k]) for k in ("params", "batch_stats")}
    if optimizer is not None and trees["mu"]:
        steps = {float(st["step"]) for st in states.values() if "step" in st}
        if len(steps) != 1:
            raise ValueError(f"Adam parameters at different step counts: {sorted(steps)}")
        state.update(mu=_tensors(trees["mu"]), nu=_tensors(trees["nu"]),
                     count=torch.tensor(int(steps.pop())))
    return state


def load_adam_moments(model: nn.Module, optimizer: torch.optim.Optimizer, mu: dict,
                      nu: dict, count: int) -> None:
    """Set a torch.optim.Adam's state from optax-named moments under flax
    paths and layouts (export_state's "mu", "nu", "count"), exactly."""
    flat_mu, flat_nu = _flatten(mu), _flatten(nu)
    for name, module in model.named_modules():
        for leaf, collection, flax_leaf, transform in _torch_leaves(module):
            if collection != "params":
                continue
            path = "/".join(name.split(".") + [flax_leaf]) if name else flax_leaf
            param = getattr(module, leaf)

            def moment(flat):
                value = flat[path] if transform is None else transform(flat[path])
                return torch.tensor(np.ascontiguousarray(value, dtype=np.float32)).to(param)

            state = {"step": torch.tensor(float(count)), "exp_avg": moment(flat_mu),
                     "exp_avg_sq": moment(flat_nu)}
            if hasattr(optimizer, "load_full_state"):
                optimizer.load_full_state(param, state)   # ZeroOptimizer keeps its slices
            else:
                optimizer.state[param] = state
