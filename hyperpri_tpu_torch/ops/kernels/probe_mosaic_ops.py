"""Probe of the one-op data movements behind the pool backward (rolls, repeats,
a -inf select, a strided concatenate, stack and broadcast reshapes) on an
(8, 16, 128) float32 array: the port of the TPU probe
scripts/probe_mosaic_ops.py:run_case (the JAX package's), one hand-written
CUDA kernel per op in csrc/probe_mosaic_ops.cu (one thread a float4 of a
row, gathered from the op's source row; one launch per op).

    python -m hyperpri_tpu_torch.ops.kernels.probe_mosaic_ops

runs every op on the card against its PyTorch op and prints `name OK` or
`name FAIL` per op; unlike the TPU probe, which printed the largest deviation
(NaN for the -inf select), the check is bit for bit and inf-aware
(torch.equal), and the command exits non-zero if any op fails.

`run_case` runs the plain version, `run_case_reference`, only for tensors on
the CPU. For CUDA tensors it launches the op's kernel or raises.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from hyperpri_tpu_torch.ops.kernels import _plain

S = (8, 16, 128)  # (outer, sublane, lane), the TPU probe's shape


def _neg_inf_where(x):
    return torch.where(x > 0, torch.full_like(x, -float("inf")), x)


# The TPU probe's eight cases, in its order (the C kernels' op index).
OPS = {
    "roll_axis0": lambda x: torch.roll(x, 1, 0),
    "roll_axis1": lambda x: torch.roll(x, 1, 1),
    "repeat_axis0": lambda x: torch.repeat_interleave(x[:4], 2, dim=0),
    "repeat_axis1": lambda x: torch.repeat_interleave(x[:, :8], 2, dim=1),
    "neg_inf_where": _neg_inf_where,
    "stride2_axis0": lambda x: torch.cat([x[0::2], x[1::2]], 0),
    "stack_reshape_axis0": lambda x: torch.stack([x[:4], x[4:]], dim=1).reshape(S),
    "bcast_reshape_axis1": lambda x: x[:, :8, None, :].expand(8, 8, 2, 128).reshape(S),
}


def run_case_reference(name: str, x: torch.Tensor) -> torch.Tensor:
    """Plain version: the op in PyTorch."""
    return OPS[name](x).contiguous()


def _lib():
    return _plain.bind("probe_mosaic_ops", "mosaic_op_f32",
                       [ctypes.c_int] + [ctypes.c_void_p] * 3)


def run_case(name: str, x: torch.Tensor) -> torch.Tensor:
    """The op `name` on x (8, 16, 128) float32. `run_case.launches` counts
    launches of the CUDA kernels."""
    if name not in OPS:
        raise ValueError(f"unknown op {name!r}; the ops are {list(OPS)}")
    if tuple(x.shape) != S or x.dtype != torch.float32:
        raise ValueError(f"need an {S} float32 x, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return run_case_reference(name, x)
    if x.device.type != "cuda" or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"run_case: need a contiguous, 16-byte aligned CUDA tensor, got "
                         f"{x.device}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib()(list(OPS).index(name), x.data_ptr(), y.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mosaic op {name} kernel launch failed: cudaError_t {err}")
    run_case.launches += 1
    return y


run_case.launches = 0


def probe_input(device) -> torch.Tensor:
    """The TPU probe's input: normal samples from numpy's seed 0."""
    x = np.random.default_rng(0).normal(size=S).astype(np.float32)
    return torch.from_numpy(x).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mosaic_ops: no CUDA device", file=sys.stderr)
        return 1
    x = probe_input("cuda")
    failed = 0
    for name in OPS:
        try:
            out = run_case(name, x)
            torch.cuda.synchronize()
            ok = torch.equal(out, run_case_reference(name, x))
            detail = "" if ok else "differs from the PyTorch op"
        except RuntimeError as e:
            ok, detail = False, str(e).replace("\n", " ")[:110]
        failed += not ok
        print(f"{name:28s} {'OK' if ok else 'FAIL'} {detail}".rstrip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
