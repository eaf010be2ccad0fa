"""Probe: two dh taps packed into the K axis of the C = 64 packed conv, against
three half-zero K = 128 products. The port of the TPU probe
scripts/probe_dh_fold.py:build (the JAX package's), as the hand-written CUDA
kernels in csrc/probe_dh_fold.cu.

Both compute, on a padded bf16 buffer (N, HP, WP, lanes), the (N, HP-2,
WP-8, 64) bf16 output
    out[n, h, w, o] = sum_{dh,dw,c} x[n, h+dh, w+dw, c] * W[dh][c, dw*64 + o]
in float32:
  - `current(x128, w)`: x128 has 128 lanes, the upper 64 zero; w (3, 128,
    192) bf16, rows 64+ zero; per dh one K = 128 product;
  - `folded(x64, w01, w2)`: x64 holds the 64 real lanes; [x(dh0) | x(dh1)] is
    multiplied by w01 (1, 128, 192), then [x(dh2) | 0] by w2 (1, 128, 192),
    rows 64+ zero.
The TPU kernels' tiles (TH = 8 rows, TW = 64 columns, windows of TWB = 72)
are kept: HP - 2 must be a multiple of 8 and WP - 8 of 64. `build` makes the
probe's inputs as the TPU probe does, at its shapes (n=2, h=608, w=968 give
(2, 610, 1032, lanes) buffers and a (2, 608, 1024, 64) output).

On the card a call takes one of two kernel bodies, chosen before the launch
by sm90_plan.dh_fold_plan: "sm90", the Hopper kernel (TMA boxes of the
pre-padded buffer in an mbarrier ring, wgmma products, the weights read in
place by TMA: no packing pass), for 16-byte aligned weights; or "legacy",
the synchronous mma.sync kernel on weights packed each call (`_pack`). Both
read x in 16-byte units: its data pointer must be 16-byte aligned. The
private keyword `_legacy=True` takes the synchronous body whatever the
layout, to hold the two against each other. `current.launches` and
`folded.launches` count launches, `launches_by_path` by body.

    python -m hyperpri_tpu_torch.ops.kernels.probe_dh_fold

runs both kernels on both bodies on the card and prints max |current -
folded|, the median of ten CUDA-event timings of each, and of one cuDNN call
of the same function (`cudnn_conv`), and the card's name and power limit.

`current` and `folded` run their plain versions, `current_reference` and
`folded_reference`, only for tensors on the CPU. For CUDA tensors they launch
a kernel or raise.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from hyperpri_tpu_torch.ops.kernels import _plain, sm90_plan

TH, TW = 8, 64
TWB = TW + 8
LS = 64  # output channels; each dh product has 3*LS columns, one group per dw


def _out_shape(x: torch.Tensor):
    n, hp, wp, _ = x.shape
    if (hp - 2) % TH or (wp - 8) % TW or hp < 2 + TH or wp < 8 + TW:
        raise ValueError(f"need HP - 2 a multiple of {TH} and WP - 8 of {TW}, got "
                         f"{tuple(x.shape)}")
    return n, hp - 2, wp - 8


def _shifted_add(p: torch.Tensor, wo: int) -> torch.Tensor:
    """The TPU kernels' epilogue: p[:, :, 0:W, 0:64] + p[:, :, 1:1+W, 64:128]
    + p[:, :, 2:2+W, 128:192]."""
    return (p[:, :, 0:wo, 0:LS] + p[:, :, 1:1 + wo, LS:2 * LS]
            + p[:, :, 2:2 + wo, 2 * LS:3 * LS])


def current_reference(x128: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the current kernel: per dh, the float32 product of
    the dh-shifted buffer with w[dh] and the shifted add, summed over dh."""
    _, ho, wo = _out_shape(x128)
    xf, wf = x128.float(), w.float()
    acc = None
    for dh in range(3):
        s = _shifted_add(xf[:, dh:dh + ho] @ wf[dh], wo)
        acc = s if acc is None else acc + s
    return acc.to(torch.bfloat16)


def folded_reference(x64: torch.Tensor, w01: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain version of the folded kernel: [x(dh0) | x(dh1)] @ w01 and
    [x(dh2) | 0] @ w2 in float32, each with the shifted add."""
    _, ho, wo = _out_shape(x64)
    xf = x64.float()
    cat01 = torch.cat([xf[:, 0:ho], xf[:, 1:1 + ho]], dim=-1)
    cat2 = torch.cat([xf[:, 2:2 + ho], torch.zeros_like(xf[:, 2:2 + ho])], dim=-1)
    acc = _shifted_add(cat01 @ w01[0].float(), wo)
    acc = acc + _shifted_add(cat2 @ w2[0].float(), wo)
    return acc.to(torch.bfloat16)


def _pack(w: torch.Tensor) -> torch.Tensor:
    """(taps_dh, 128, 192) -> [dh][chunk][dw][o][32 lanes]: the B rows the
    synchronous kernel stages, one 32-lane chunk of K at a time."""
    d = w.shape[0]
    return (w.reshape(d, 4, 32, 3, LS).permute(0, 1, 3, 4, 2).contiguous()
            .to(torch.bfloat16))


def cudnn_conv(x64: torch.Tensor, w: torch.Tensor):
    """The probe's function as one cuDNN call, the yardstick beside the
    kernels (no kernel path calls it): a VALID 3x3 conv (F.conv2d) of the 64
    real lanes of x64 with w's real rows, cut to the output's WP - 8 columns.
    Returns a callable, the weights rearranged once outside it, whose result
    is (N, 64, HP-2, WP-8) in channels-last memory."""
    _, _, wo = _out_shape(x64)
    # W[dh][c, dw*64 + o] -> OIHW weights of the real 64 lanes
    w_oihw = (w[:, :64].reshape(3, 64, 3, LS).permute(3, 1, 0, 2)
              .contiguous(memory_format=torch.channels_last))
    x_cl = x64.permute(0, 3, 1, 2)[..., :wo + 2]
    return lambda: F.conv2d(x_cl, w_oihw)


def call_plan(x: torch.Tensor, *ws: torch.Tensor, _legacy: bool = False):
    """The sm90_plan.DhFoldPlan of a call on x with the weights ws: the
    Hopper body reads the weights in place, so unaligned weights take the
    synchronous body, which packs them (x must be aligned for both)."""
    n, hp, wp, lanes = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + ws)
    return sm90_plan.dh_fold_plan(n, hp, wp, lanes, aligned, sm90=not _legacy)


def _launch(entry: str, x: torch.Tensor, ws, blocks=None) -> torch.Tensor:
    """Launch `entry` on x and the weight operands ws (the packed weights
    for the synchronous body; w, or w01 and w2, for the Hopper body, which
    takes the persistent grid `blocks` too)."""
    n, ho, wo = _out_shape(x)
    y = torch.empty((n, ho, wo, LS), dtype=torch.bfloat16, device=x.device)
    extra = [] if blocks is None else [blocks]
    fn = _plain.bind("probe_dh_fold", entry, [ctypes.c_void_p] * (2 + len(ws))
                     + [ctypes.c_int] * (3 + len(extra)) + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *[w.data_ptr() for w in ws], y.data_ptr(), n, x.shape[1],
                 x.shape[2], *extra, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError_t {err}")
    return y


def _check(x, lanes, *ws):
    if x.dim() != 4 or x.shape[-1] != lanes or x.dtype != torch.bfloat16:
        raise ValueError(f"need a bf16 (N, HP, WP, {lanes}) buffer, got {tuple(x.shape)} "
                         f"{x.dtype}")
    for w in ws:
        if w.shape[1:] != (128, 3 * LS):
            raise ValueError(f"need (taps, 128, {3 * LS}) weights, got {tuple(w.shape)}")
    if x.device.type == "cuda":
        for t in (x,) + ws:
            if t.device != x.device or not t.is_contiguous() or t.dtype != torch.bfloat16:
                raise ValueError("operands must be contiguous bf16 on x's CUDA device")
        if x.data_ptr() % 16:   # both bodies read x in 16-byte vectors or TMA boxes
            raise ValueError("x's data pointer must be 16-byte aligned")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def current(x128: torch.Tensor, w: torch.Tensor, *, _legacy: bool = False) -> torch.Tensor:
    """Three K = 128 products, half of K zero; `current.launches` counts
    launches of the CUDA kernels, `launches_by_path` by body ("sm90",
    "legacy")."""
    _check(x128, 128, w)
    if w.shape[0] != 3:
        raise ValueError(f"need w (3, 128, {3 * LS}), got {tuple(w.shape)}")
    if x128.device.type == "cpu":
        return current_reference(x128, w)
    plan = call_plan(x128, w, _legacy=_legacy)
    if plan.path == "sm90":
        y = _launch("dh_fold_sm90_current", x128, (w,), plan.grid[0])
    else:
        wk = _pack(w).permute(1, 0, 2, 3, 4).contiguous()   # [chunk][dh][dw][o][k]
        y = _launch("dh_fold_current", x128, (wk,))
    current.launches += 1
    _plain.count(current.launches_by_path, (plan.path,))
    return y


def folded(x64: torch.Tensor, w01: torch.Tensor, w2: torch.Tensor, *,
           _legacy: bool = False) -> torch.Tensor:
    """Two K = 128 products, the first with both halves of K real;
    `folded.launches` counts launches of the CUDA kernels, `launches_by_path`
    by body ("sm90", "legacy")."""
    _check(x64, 64, w01, w2)
    if w01.shape[0] != 1 or w2.shape[0] != 1:
        raise ValueError("need w01 and w2 of shape (1, 128, 192)")
    if x64.device.type == "cpu":
        return folded_reference(x64, w01, w2)
    plan = call_plan(x64, w01, w2, _legacy=_legacy)
    if plan.path == "sm90":
        y = _launch("dh_fold_sm90_folded", x64, (w01, w2), plan.grid[0])
    else:
        wk = torch.cat([_pack(w01), _pack(w2)]).reshape(8, 3, LS, 32)   # [w01 | w2 chunks]
        y = _launch("dh_fold_folded", x64, (wk,))
    folded.launches += 1
    _plain.count(folded.launches_by_path, (plan.path,))
    return y


current.launches = 0
current.launches_by_path = {}
folded.launches = 0
folded.launches_by_path = {}


def build(n: int = 2, h: int = 608, w: int = 968, device=None, seed: int = 0):
    """((current, (x128, w)), (folded, (x64, w01, w2))) on the probe's inputs:
    a normal bf16 buffer of n_h*8 + 2 rows and n_w*64 + 8 columns covering
    (h, w), its upper 64 lanes zero in x128, and normal weights, as the TPU
    probe builds them (from a torch generator, so not its numbers)."""
    device = torch.device("cuda" if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_h, n_w = h // TH, -(-w // TW)
    hp, wp = n_h * TH + 2, n_w * TW + 8
    x128 = torch.randn((n, hp, wp, 128), generator=gen, device=device).to(torch.bfloat16)
    x128[..., 64:] = 0
    x64 = x128[..., :64].contiguous()
    wp3 = torch.randn((3, 128, 3 * LS), generator=gen, device=device).to(torch.bfloat16)
    wp3[:, 64:, :] = 0
    w01 = torch.cat([wp3[0, :64], wp3[1, :64]])[None].contiguous()
    w2 = torch.cat([wp3[2, :64], torch.zeros_like(wp3[2, :64])])[None].contiguous()
    return (current, (x128, wp3)), (folded, (x64, w01, w2))


def cuda_ms(fn, args, reps: int = 10) -> float:
    """Median milliseconds of fn(*args) by CUDA events, after a warm-up."""
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dh_fold: no CUDA device", file=sys.stderr)
        return 1
    (cur, a_cur), (fold, a_fold) = build()
    ya, yb = cur(*a_cur), fold(*a_fold)
    err = (ya.float() - yb.float()).abs().max().item()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"max |cur - folded| = {err:.3e}")
    for body, legacy in (("sm90", False), ("legacy", True)):
        ta = cuda_ms(lambda *a: cur(*a, _legacy=legacy), a_cur)
        tb = cuda_ms(lambda *a: fold(*a, _legacy=legacy), a_fold)
        print(f"{body:6s} current (3 half-K products): {ta:.3f} ms")
        print(f"{body:6s} folded  (2 products):        {tb:.3f} ms  "
              f"({(ta - tb) / ta * 100:+.1f}%)")
    print(f"cuDNN VALID conv of the 64 real lanes:  "
          f"{cuda_ms(cudnn_conv(a_fold[0], a_cur[1]), ()):.3f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
