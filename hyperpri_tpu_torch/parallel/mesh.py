"""The ('data', 'spatial') device mesh of multi-device training (port of
hyperpri_tpu/parallel/mesh.py).

One process per device, launched by `torchrun` (or a single process, world
1). The mesh is a torch.distributed DeviceMesh with two axes:

  - 'data':    the batch is split over it (DDP's axis) and the optimizer state
               is sharded over it (ZeRO, parallel/sharding.py);
  - 'spatial': the H axis of the feature maps is split over it, each rank
               holding an even share of the rows (parallel/spatial_conv.py
               exchanges the one-row halos a 3x3 conv needs).

On the card the backend is NCCL and each process takes cuda:LOCAL_RANK; on
the CPU it is gloo. A failed NCCL init raises: nothing falls back to gloo or
to the CPU.

Where the JAX package declares shardings and lets XLA place the collectives,
the port calls them itself: `Mesh` holds the axis groups and the few
collectives the model, the step and the loader need, each differentiable
where autograd passes through it.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
AXES = (DATA_AXIS, SPATIAL_AXIS)


def mesh_sizes(shape: Optional[Dict[str, int]], n: int) -> Tuple[int, int]:
    """(data, spatial) sizes of a mesh over n ranks, by make_mesh's rule
    (mesh.py:27-47): axes omitted get the remaining ranks in order (data
    first), so {} puts all n on 'data' and {"data": 2} gives spatial n // 2.
    A shape that does not cover n exactly raises."""
    shape = dict(shape or {})
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes are {AXES}")
    sizes = [shape.get(DATA_AXIS, 0), shape.get(SPATIAL_AXIS, 0)]
    known = math.prod(s for s in sizes if s > 0)
    for i, s in enumerate(sizes):
        if s == 0:
            sizes[i] = n // known
            known *= sizes[i]
    if sizes[0] * sizes[1] != n or min(sizes) < 1:
        raise ValueError(f"mesh shape {sizes} does not cover {n} devices")
    return sizes[0], sizes[1]


def launched_world() -> Tuple[int, int, int]:
    """(rank, world size, local rank) of this process: torchrun's RANK,
    WORLD_SIZE and LOCAL_RANK, or those of the process group already
    initialized, or (0, 1, 0) for a single process."""
    if dist.is_initialized():
        return (dist.get_rank(), dist.get_world_size(),
                int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    return (int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(device: torch.device) -> torch.device:
    """Join (or start) the process group for a mesh and return this
    process's device: cuda:LOCAL_RANK on the card, with NCCL, else the CPU
    with gloo. Under torchrun the group reads its address from the
    environment; a single process makes a world of 1 with an in-process
    store. A group already initialized is kept, unless its backend does not
    serve `device` (gloo under a CUDA device raises)."""
    rank, world, local_rank = launched_world()
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but a mesh on "
                               f"{device.type} needs {backend}")
        return device
    if world == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return device


class _AllReduce(torch.autograd.Function):
    """Sum over the given groups, replicated on every member; its transpose
    is the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        out = t.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """(N, h, W, C) row shards of the spatial peers -> the (N, s*h, W, C)
    whole on every peer; the transpose sums the peers' cotangents of the
    whole and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, index, s):
        ctx.group, ctx.index, ctx.h = group, index, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(s)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[:, ctx.index * ctx.h:(ctx.index + 1) * ctx.h].contiguous(), None, None, None


@dataclass(frozen=True)
class Mesh:
    """A 2-D DeviceMesh with the axes ('data', 'spatial') and this rank's
    place in it."""

    device_mesh: object

    @property
    def shape(self) -> Dict[str, int]:
        return {name: self.device_mesh.size(i) for i, name in enumerate(AXES)}

    @property
    def data(self) -> int:
        return self.device_mesh.size(0)

    @property
    def spatial(self) -> int:
        return self.device_mesh.size(1)

    @property
    def coordinate(self) -> Tuple[int, int]:
        return tuple(self.device_mesh.get_coordinate())

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank_at(self, data_index: int, spatial_index: int) -> int:
        """The global rank of the mesh's (data, spatial) place."""
        return int(self.device_mesh.mesh[data_index, spatial_index])

    def groups(self, axes: Sequence[str] = AXES) -> tuple:
        """The groups of `axes` with more than one member, to reduce over in
        turn."""
        return tuple(self.group(a) for a in axes if self.shape[a] > 1)

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str] = AXES) -> torch.Tensor:
        """Differentiable sum of t over `axes` (a new tensor)."""
        groups = self.groups(axes)
        return _AllReduce.apply(t, groups) if groups else t

    def all_reduce_(self, t: torch.Tensor, axes: Sequence[str] = AXES) -> torch.Tensor:
        """In-place sum of t over `axes`, outside autograd."""
        for g in self.groups(axes):
            dist.all_reduce(t, group=g)
        return t

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: every rank takes the tensors of the mesh's (0, 0) rank
        (flattened, one broadcast per dtype and axis)."""
        i, j = self.coordinate
        for dtype in {t.dtype for t in tensors}:
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch._utils._flatten_dense_tensors(same)
            if self.data > 1:
                dist.broadcast(flat, src=self.rank_at(0, j), group=self.group(DATA_AXIS))
            if self.spatial > 1:
                dist.broadcast(flat, src=self.rank_at(i, 0), group=self.group(SPATIAL_AXIS))
            for t, v in zip(same, torch._utils._unflatten_dense_tensors(flat, same)):
                t.copy_(v)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Concatenation along `dim` of the tensors of `axis`'s members, in
        their order on the axis (equal shapes; no gradient)."""
        n = self.shape[axis]
        if n == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable: this rank's rows of an H-sharded NHWC tensor ->
        the whole tensor, on every spatial peer."""
        if self.spatial == 1:
            return x
        return _GatherRows.apply(x, self.group(SPATIAL_AXIS), self.coordinate[1], self.spatial)

    # -- batch layout (batch_sharding / sample_sharding) ---------------------

    def sample_range(self, n: int) -> Tuple[int, int]:
        """[start, stop) of the samples of an n-sample global batch that this
        rank holds: the data axis splits N evenly."""
        if n % self.data:
            raise ValueError(f"a batch of {n} does not split over {self.data} data ranks")
        k = n // self.data
        return self.coordinate[0] * k, (self.coordinate[0] + 1) * k

    def row_range(self, h: int) -> Tuple[int, int]:
        """[start, stop) of the rows of an h-row map that this rank holds:
        the spatial axis splits H evenly."""
        if h % self.spatial:
            raise ValueError(f"{h} rows do not split over {self.spatial} spatial ranks")
        k = h // self.spatial
        return self.coordinate[1] * k, (self.coordinate[1] + 1) * k


def make_mesh(shape: Optional[Dict[str, int]] = None, device_type: str = "cpu") -> Mesh:
    """The mesh of `shape` (mesh_sizes' rule) over the whole launched world,
    whose process group must be up (init_distributed). A shape larger or
    smaller than the world raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    sizes = mesh_sizes(shape, dist.get_world_size())
    return Mesh(init_device_mesh(device_type, sizes, mesh_dim_names=AXES))


@dataclass(frozen=True)
class Rows:
    """How a feature map's H axis lies on the mesh: its global height `h`,
    split evenly over the spatial ranks (sharded) when it divides, else held
    whole by every spatial peer (replicated: the deep levels whose rows do
    not split, as 38 rows at spatial 4, or 2 at spatial 4 from a 16-row
    input). Ops that are not local in H gather the rows, compute on the
    whole map and keep this rank's rows of their output (`keep`)."""

    mesh: Mesh
    h: int

    @property
    def sharded(self) -> bool:
        return self.h % self.mesh.spatial == 0

    @property
    def split(self) -> bool:
        """True iff the rows are spread over more than one rank."""
        return self.mesh.spatial > 1 and self.sharded

    @property
    def reduce_axes(self) -> tuple:
        """The axes over which this map's pixels are spread (its BatchNorm
        sums run over them): data always, spatial when the rows are split."""
        return AXES if self.split else (DATA_AXIS,)

    def halved(self) -> "Rows":
        return Rows(self.mesh, self.h // 2)

    def doubled(self) -> "Rows":
        return Rows(self.mesh, 2 * self.h)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """x with all of its h rows (gathered when split)."""
        return self.mesh.gather_rows(x) if self.split else x

    def keep(self, x_whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole map of height h."""
        if not self.split:
            return x_whole
        r0, r1 = self.mesh.row_range(self.h)
        return x_whole[:, r0:r1]

    @classmethod
    def of_input(cls, mesh: Mesh, x: torch.Tensor) -> "Rows":
        """The rows of a network input, which is always split evenly."""
        return cls(mesh, x.shape[1] * mesh.spatial)
