"""The H-sharded 3x3 SAME conv with an explicit one-row halo exchange (port of
hyperpri_tpu/parallel/spatial_conv.py:57-137 `conv3x3_spatial`).

Each spatial rank holds an even share of the rows of an (N, H, W, C) map.
A 3x3 SAME conv needs one row from each H-neighbour:

  1. `_HaloExchange` sends this rank's first row up and its last row down
     and receives the neighbours' (torch.distributed batch_isend_irecv
     within the spatial group); at the global top and bottom the halo is
     zero, the SAME conv's padding. Its backward sends the halo rows'
     cotangents back, and each neighbour adds them to its boundary row: the
     transpose of the exchange (ppermute's);
  2. the local conv runs on the extended (N, h+2, W, C) block: in training
     with kernels, ops/kernels/conv_train.conv3x3_bias_train (conv3x3_packed
     for O <= 64, conv3x3_bias_act above, the adjoint and conv3x3_wgrad in the
     backward), else F.conv2d; the JAX mesh route's unfused conv, with no
     statistics epilogue and no prologue (parts.py:386-405);
  3. the two halo output rows are sliced off.

The weight and bias gradients of each rank are its rows' share; the step
sums them over the mesh (parallel/sharding.sum_gradients). With one spatial
rank there is no exchange. `pre_padded_hw` (data-only meshes) takes x as the
host pre-padded ingest buffer and reads it raw, as the single device does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from hyperpri_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh


def _exchange(mesh: Mesh, up: Optional[torch.Tensor], down: Optional[torch.Tensor]):
    """Send `up` to the spatial neighbour above and `down` to the one below
    (None at a global edge, and nothing is sent there); -> (the row received
    from above, the row received from below), None at an edge."""
    i, j = mesh.coordinate
    group = mesh.group(SPATIAL_AXIS)
    ops, recv = [], [None, None]
    for k, (peer_j, send) in enumerate(((j - 1, up), (j + 1, down))):
        if send is None:
            continue
        peer = mesh.rank_at(i, peer_j)
        recv[k] = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, peer, group))
        ops.append(dist.P2POp(dist.irecv, recv[k], peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv[0], recv[1]


def _edges(mesh: Mesh):
    j, s = mesh.coordinate[1], mesh.spatial
    return j > 0, j < s - 1


class _HaloExchange(torch.autograd.Function):
    """(N, h, W, C) rows -> (N, h+2, W, C): the row above, the rows, the row
    below (zero at the global edges)."""

    @staticmethod
    def forward(ctx, xs, mesh):
        ctx.mesh = mesh
        has_up, has_down = _edges(mesh)
        top, bot = _exchange(mesh, xs[:, :1].contiguous() if has_up else None,
                             xs[:, -1:].contiguous() if has_down else None)
        zero = xs.new_zeros(xs[:, :1].shape)
        return torch.cat([zero if top is None else top, xs,
                          zero if bot is None else bot], dim=1)

    @staticmethod
    def backward(ctx, ge):
        mesh = ctx.mesh
        has_up, has_down = _edges(mesh)
        # this rank's halo rows are its neighbours' boundary rows: send their
        # cotangents back, and add what the neighbours send to our own
        from_up, from_down = _exchange(mesh, ge[:, :1].contiguous() if has_up else None,
                                       ge[:, -1:].contiguous() if has_down else None)
        g = ge[:, 1:-1].clone()
        if from_up is not None:
            g[:, :1] += from_up
        if from_down is not None:
            g[:, -1:] += from_down
        return g, None


def local_conv(xe: torch.Tensor, w: torch.Tensor, b: torch.Tensor, kernels: bool,
               pre_padded_hw=None) -> torch.Tensor:
    """The conv of one shard's block: w HWIO (3, 3, C, O) in x's dtype, b
    float32. `kernels`: conv_train's kernel convs (bias added in float32);
    else F.conv2d (bias added in the compute dtype, as Conv3x3's route
    off the kernels does)."""
    if kernels:
        from hyperpri_tpu_torch.ops.kernels.conv_train import (
            conv3x3_bias_stats_train,
            conv3x3_bias_train,
        )

        if pre_padded_hw is not None:
            return conv3x3_bias_stats_train(xe.contiguous(), w, b.float(), pre_padded_hw)[0]
        return conv3x3_bias_train(xe.contiguous(), w, b.float())
    if pre_padded_hw is not None:
        # the logical window of the padded buffer (crop at (1, 1), the true
        # channel count from the kernel)
        h, width = pre_padded_hw
        xe = xe[:, 1:1 + h, 1:1 + width, :w.shape[2]]
    y = F.conv2d(xe.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + b.to(xe.dtype)


def conv3x3_spatial(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mesh: Mesh, *,
                    kernels: bool = False, pre_padded_hw=None,
                    split: Optional[bool] = None) -> torch.Tensor:
    """3x3 SAME conv + bias of this rank's (N, h, W, C) rows of an H-sharded
    map, differentiable. w HWIO in x's dtype, b float32. `kernels` runs the
    local conv on the trainable kernel convs. `split` = False says that x
    holds the whole map on every spatial peer (a level whose rows do not
    split evenly, models/parts.py), which needs no exchange; default: split
    iff the mesh has more than one spatial rank. `pre_padded_hw` = logical
    (h, w) of a host pre-padded buffer, for data-only meshes."""
    split = mesh.spatial > 1 if split is None else split
    if pre_padded_hw is not None and split:
        raise ValueError("pre-padded ingest requires a data-parallel-only mesh (spatial=1), "
                         f"got spatial={mesh.spatial}")
    if not split:
        return local_conv(x, w, b, kernels, pre_padded_hw)
    xe = _HaloExchange.apply(x, mesh)
    # the block's own zero padding reaches only the two halo output rows
    return local_conv(xe, w, b, kernels)[:, 1:-1]
