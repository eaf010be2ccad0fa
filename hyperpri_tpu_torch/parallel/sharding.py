"""ZeRO: optimizer state sharded over the mesh's 'data' axis, optionally kept
in pinned host memory between steps (port of hyperpri_tpu/parallel/sharding.py
and of the offload of hyperpri_tpu/train/trainer.py:331-346).

The partition rule is the JAX package's (`zero_partition_spec`), applied to
each parameter in the checkpoint's flax layout (weights.flax_axes), so a leaf
is sharded here iff the JAX package shards it, along the same dimension.

`ZeroOptimizer` runs a torch optimizer (Adam, as the configuration has it)
over each rank's slices: for every sharded parameter the rank keeps only its
1/d slice of each state tensor (Adam's exp_avg and exp_avg_sq) and updates
only that slice of the parameter; replicated leaves (scalars, indivisible
shapes, every leaf at d = 1) are the parameters themselves, updated whole on
every rank. Adam is elementwise, so a slice's
update is the unsharded update of those elements, bit for bit. After the step
the parameters are gathered back over 'data'. With `offload` the state
tensors live in pinned host memory between steps and are copied to the
device for the update: the same kernels on the same values, so the
parameters are bit-equal to a run without offload. Checkpoints hold the
whole state (`full_state`, gathered), in the single-device format, so a run
resumes at any mesh shape or on one device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn as nn

from hyperpri_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def zero_partition_spec(leaf, axis_size: int) -> tuple:
    """The partition of one optimizer-state leaf over a data axis of
    `axis_size` (sharding.py:22-38): the largest dimension divisible by the
    axis size (ties to the trailing one) carries DATA_AXIS; scalars and
    indivisible leaves are replicated, (). The tuple reads as JAX's
    PartitionSpec does."""
    shape = tuple(getattr(leaf, "shape", leaf))
    if not shape or axis_size <= 1:
        return ()
    dims = sorted(range(len(shape)), key=lambda d: (shape[d] % axis_size == 0, shape[d], d))
    best = dims[-1]
    if shape[best] % axis_size != 0:
        return ()
    spec = [None] * len(shape)
    spec[best] = DATA_AXIS
    return tuple(spec)


def _leaves(tree) -> Iterable:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)) and not all(isinstance(d, int) for d in tree):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def estimate_zero_savings(opt_state, axis_size: int) -> float:
    """Fraction of the optimizer state's elements that are sharded
    (sharding.py:56-65): `opt_state` is a nested dict or list whose leaves
    are arrays or shapes, in the checkpoint's layout (export_state's "count",
    "mu" and "nu")."""
    total = sharded = 0
    for leaf in _leaves(opt_state):
        shape = tuple(getattr(leaf, "shape", leaf))
        n = math.prod(shape) if shape else 1
        total += n
        if zero_partition_spec(shape, axis_size) != ():
            sharded += n
    return sharded / max(total, 1)


def _flax_layouts(model: nn.Module) -> Dict[nn.Parameter, tuple]:
    """{parameter: torch dimension of each flax dimension} (weights.flax_axes)."""
    from hyperpri_tpu_torch.weights import flax_axes

    return {p: flax_axes(module, p.dim()) for module in model.modules()
            for p in module.parameters(recurse=False)}


class ZeroOptimizer:
    """A torch optimizer over this rank's slices of the model's parameters
    (ZeRO over `mesh`'s data axis; every leaf whole when mesh is None or its
    data axis has one rank). `make_inner(params)` builds the optimizer over
    the slice tensors (make_optimizer's Adam). Call `step()` after the
    gradients are summed over the mesh."""

    def __init__(self, model: nn.Module, make_inner: Callable[[List[torch.Tensor]],
                                                              torch.optim.Optimizer],
                 mesh: Optional[Mesh] = None, offload: bool = False):
        self.mesh = mesh
        self.offload = offload
        d = mesh.data if mesh is not None else 1
        index = mesh.coordinate[0] if mesh is not None else 0
        self.params: List[nn.Parameter] = [p for p in model.parameters() if p.requires_grad]
        layouts = _flax_layouts(model)
        self.dims: Dict[nn.Parameter, Optional[int]] = {}
        self.slices: Dict[nn.Parameter, torch.Tensor] = {}
        for p in self.params:
            axes = layouts[p]
            flax_shape = tuple(p.shape[a] for a in axes)
            spec = zero_partition_spec(flax_shape, d)
            dim = axes[spec.index(DATA_AXIS)] if spec else None
            self.dims[p] = dim
            if dim is None:   # whole: the optimizer updates the parameter itself
                self.slices[p] = p
            else:
                k = p.shape[dim] // d
                self.slices[p] = p.detach().narrow(dim, index * k, k).clone().requires_grad_(True)
        self.inner = make_inner([self.slices[p] for p in self.params])
        self._host: Dict[tuple, torch.Tensor] = {}

    # -- the step -------------------------------------------------------------

    def _slice(self, p: nn.Parameter, t: torch.Tensor) -> torch.Tensor:
        dim = self.dims[p]
        if dim is None:
            return t
        k = p.shape[dim] // self.mesh.data
        return t.narrow(dim, self.mesh.coordinate[0] * k, k)

    def zero_grad(self, set_to_none: bool = True):
        """Drop every gradient (the step's `zero_grad(set_to_none=True)`)."""
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        sharded = [p for p in self.params if self.dims[p] is not None]
        for p in sharded:
            s = self.slices[p]
            s.copy_(self._slice(p, p.detach()))
            s.grad = None if p.grad is None else self._slice(p, p.grad).contiguous()
        self._to_device()
        self.inner.step()
        self._to_host()
        if sharded:
            for p, whole in zip(self.params,
                                self._gathered([self.slices[p] for p in self.params])):
                if self.dims[p] is not None:
                    p.copy_(whole)

    def _gathered(self, pieces: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensor of each parameter's slice-shaped piece (in
        self.params' order), the sharded ones in one all_gather over 'data'."""
        sharded = [k for k, p in enumerate(self.params) if self.dims[p] is not None]
        out = list(pieces)
        if not sharded:
            return out
        flat = torch.cat([pieces[k].reshape(-1) for k in sharded])
        whole = self.mesh.all_gather(flat, DATA_AXIS, 0).view(self.mesh.data, -1)
        start = 0
        for k in sharded:
            n = pieces[k].numel()
            parts = [part.view(pieces[k].shape) for part in whole[:, start:start + n]]
            out[k] = torch.cat(parts, dim=self.dims[self.params[k]])
            start += n
        return out

    def _state_tensors(self):
        """(parameter, its state dict, name, tensor) of every state tensor
        with elements (not Adam's step counter)."""
        for p in self.params:
            state = self.inner.state.get(self.slices[p], {})
            for name, t in list(state.items()):
                if isinstance(t, torch.Tensor) and t.dim() > 0:
                    yield p, state, name, t

    def _to_device(self):
        if self.offload:
            for p, state, name, t in self._state_tensors():
                state[name] = t.to(p.device, non_blocking=True)

    def _to_host(self):
        """The state tensors into their pinned host buffers (allocated at the
        first step, then reused); the device copies are freed."""
        if not self.offload:
            return
        for p, state, name, t in self._state_tensors():
            if t.device.type != "cuda":   # on the CPU the state is in host memory already
                continue
            host = self._host.get((p, name))
            if host is None:
                host = self._host[p, name] = torch.empty_like(t, device="cpu", pin_memory=True)
            host.copy_(t, non_blocking=True)
            state[name] = host
        if self._host:
            torch.cuda.synchronize(self.params[0].device)   # the copies are read as checkpoints

    # -- checkpoints ----------------------------------------------------------

    def full_state(self) -> Dict[nn.Parameter, dict]:
        """{parameter: its whole state} with every slice gathered over the
        data axis, on the parameter's device (a collective over the mesh)."""
        states = [self.inner.state.get(self.slices[p]) or {} for p in self.params]
        out = {p: dict(s) for p, s in zip(self.params, states) if s}
        names = sorted({k for s in states for k, t in s.items()
                        if isinstance(t, torch.Tensor) and t.dim() > 0})
        for name in names:
            if not all(name in s for s in states):
                raise ValueError(f"optimizer state {name!r} is missing for some parameters")
            pieces = [s[name].to(p.device) for p, s in zip(self.params, states)]
            for p, whole in zip(self.params, self._gathered(pieces)):
                out[p][name] = whole
        return out

    def load_full_state(self, p: nn.Parameter, state: dict):
        """Set parameter p's state from its whole state (this rank keeps its
        slice; under offload, in pinned host memory)."""
        s = {name: (self._slice(p, t).contiguous().clone()
                    if isinstance(t, torch.Tensor) and t.dim() > 0 else t)
             for name, t in state.items()}
        self.inner.state[self.slices[p]] = s
        if self.offload:
            self._to_host()

    def state_bytes(self) -> int:
        """Bytes of this rank's state tensors (the moments' slices)."""
        return sum(t.numel() * t.element_size() for *_, t in self._state_tensors())


def moments_tree_shapes(model: nn.Module) -> dict:
    """The shapes of an Adam state's leaves in the checkpoint's layout: the
    step count and a first and second moment per parameter, for
    estimate_zero_savings."""
    shapes = [tuple(p.shape[a] for a in axes) for p, axes in _flax_layouts(model).items()
              if p.requires_grad]
    return {"count": (), "mu": shapes, "nu": shapes}


def sum_gradients(model: nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the whole mesh, in one flat
    collective: each rank's gradient is its share of the globally normalized
    loss's (its samples, its rows), so the sum, not DDP's mean, is the
    gradient."""
    if not mesh.groups():
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    mesh.all_reduce_(flat)
    for g, summed in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(summed)
