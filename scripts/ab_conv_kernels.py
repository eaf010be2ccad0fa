"""Time the port's 3x3 conv kernels at the training steps' calls, and the
dh-fold and Mosaic-op probes, for one source tree, to compare two commits of
hyperpri_tpu_torch on the same card within one job:

    git archive <parent> | tar -x -C build/parent      # a gitignored directory
    python3 scripts/ab_conv_kernels.py build/parent [GROUP ...]
    python3 scripts/ab_conv_kernels.py . [GROUP ...]
    python3 scripts/ab_conv_kernels.py . [GROUP ...]
    python3 scripts/ab_conv_kernels.py build/parent [GROUP ...]

Each run imports hyperpri_tpu_torch from the given tree (building its kernels
there) and calls, on seeded inputs, the groups named (all when none is):
  - shift_bf16, shift_f32: conv3x3_bias_act_shift (ReLU off) at every
    distinct conv3x3_bias_act call shape of a training step (12 calls a
    step: the bf16 product-loop step, and the float32 UNET and CubeNET-64
    steps, which make the same calls); control: conv3x3_bias_act itself at
    those calls in their modes, bf16 and float32;
  - wgrad_fold_bf16, wgrad_fold_f32: conv3x3_wgrad's fold mode ((dW, db)
    from the raw cotangent gy, the statistics conv's output y, gsum and
    gsumsq) at the eleven conv3x3_wgrad calls of a CubeNET-64 step (the
    bf16 product-loop step and the float32 step make the same calls; the
    first conv reads the host pre-padded buffer), on each tree's default
    body; wgrad_fold_control: the non-fold kernel at those calls on the
    materialized g_eff, bf16 and float32;
  - dh_fold: the dh-fold probe's current and folded kernels at the probe's
    2x610x1032 buffers, through the public functions only (each tree's
    default body); dh_fold_control: one cuDNN call of the same function (a
    VALID 3x3 conv of the 64 real lanes, F.conv2d), built here so that
    every tree runs the same call;
  - mosaic: the eight Mosaic-op kernels on the probe's 8x16x128 input;
    mosaic_control: the eight PyTorch ops.
Per call it prints the median wrapper time by CUDA events (20 timed calls
after 3 warm-ups), the device time of the call's kernels from torch.profiler
over 10 calls (the conv, dh-fold and Mosaic-op kernels by name; every kernel
of a control call) and a digest of the call's output bits (two trees whose
digests agree computed the same bits); then, per kernel, dtype and group,
the sums over the calls (time x multiplicity). The card's name and power
limit come first. Needs a CUDA device; imports no JAX.
"""

import os
import statistics
import subprocess
import sys

import torch

# The distinct conv3x3_bias_act calls of a training step (the bf16
# product-loop step and the float32 UNET and CubeNET-64 steps make the same
# twelve): (label, shape (N, H, W, C), O, mode, calls).
STEP_CALLS = [
    ("down1.conv1 stats", (2, 304, 484, 64), 128, "stats", 1),
    ("down1/up3.conv2 stats+prologue", (2, 304, 484, 128), 128, "prologue", 2),
    ("down1/up3.conv2 adjoint", (2, 304, 484, 128), 128, "adjoint", 2),
    ("up3.conv1 stats", (2, 304, 484, 256), 128, "stats", 1),
    ("up3.conv1 adjoint", (2, 304, 484, 128), 256, "adjoint", 1),
    ("down2.conv1 stats", (2, 152, 242, 128), 256, "stats", 1),
    ("down2/up2.conv2 stats+prologue", (2, 152, 242, 256), 256, "prologue", 2),
    ("down2/up2.conv2 adjoint", (2, 152, 242, 256), 256, "adjoint", 2),
]
# The shift conv at those shapes, ReLU off (label, shape, O, calls), and then
# (label, kernel, shape, O, mode, dtype, calls, group) of every timed call.
SHIFT_CALLS = [
    ("down1.conv1", (2, 304, 484, 64), 128, 1),
    ("down1/up3.conv2 and adjoints", (2, 304, 484, 128), 128, 4),
    ("up3.conv1", (2, 304, 484, 256), 128, 1),
    ("up3.conv1 adjoint", (2, 304, 484, 128), 256, 1),
    ("down2.conv1", (2, 152, 242, 128), 256, 1),
    ("down2/up2.conv2 and adjoints", (2, 152, 242, 256), 256, 4),
]
CALLS = [(label, "shift", shape, o, "conv", dtype, count, f"shift_{dtype}")
         for dtype in ("bf16", "f32") for label, shape, o, count in SHIFT_CALLS]
CALLS += [(label, "halo", shape, o, mode, dtype, count, "control")
          for dtype in ("bf16", "f32") for label, shape, o, mode, count in STEP_CALLS]
# The weight gradient's calls of a CubeNET-64 step: (label, shape, O, mode,
# calls); mode "pre_padded" reads x from the ingest buffer.
WGRAD_CALLS = [
    ("first_conv", (2, 608, 968, 238), 64, "pre_padded", 1),
    ("inc2/up4.conv2 prologue", (2, 608, 968, 64), 64, "prologue", 2),
    ("down1.conv1", (2, 304, 484, 64), 128, "plain", 1),
    ("down1/up3.conv2 prologue", (2, 304, 484, 128), 128, "prologue", 2),
    ("down2.conv1", (2, 152, 242, 128), 256, "plain", 1),
    ("down2/up2.conv2 prologue", (2, 152, 242, 256), 256, "prologue", 2),
    ("up3.conv1", (2, 304, 484, 256), 128, "plain", 1),
    ("up4.conv1", (2, 608, 968, 128), 64, "plain", 1),
]
CALLS += [(label, "fold", shape, o, mode, dtype, count, f"wgrad_fold_{dtype}")
          for dtype in ("bf16", "f32") for label, shape, o, mode, count in WGRAD_CALLS]
CALLS += [(label, "wgrad", shape, o, mode, dtype, count, "wgrad_fold_control")
          for dtype in ("bf16", "f32") for label, shape, o, mode, count in WGRAD_CALLS]
# The probes: (label, kernel, shape, O, mode, dtype, calls, group); the dh-fold
# shape is the probe's output, the Mosaic ops' their one input.
PROBE_SHAPE = (2, 608, 968)
MOSAIC_OPS = ["roll_axis0", "roll_axis1", "repeat_axis0", "repeat_axis1", "neg_inf_where",
              "stride2_axis0", "stack_reshape_axis0", "bcast_reshape_axis1"]
CALLS += [(name, "dh_fold", PROBE_SHAPE, 64, name, "bf16", 1, "dh_fold")
          for name in ("current", "folded")]
CALLS += [("cuDNN VALID conv", "cudnn", PROBE_SHAPE, 64, "valid", "bf16", 1, "dh_fold_control")]
CALLS += [(name, "mosaic", (8, 16, 128), 128, name, "f32", 1, "mosaic") for name in MOSAIC_OPS]
CALLS += [(name, "torch_op", (8, 16, 128), 128, name, "f32", 1, "mosaic_control")
          for name in MOSAIC_OPS]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# the device kernels each call's device time sums (None: every kernel)
DEVICE_KEYS = {"shift": "conv3x3", "halo": "conv3x3", "dh_fold": "dh_fold",
               "mosaic": "mosaic_op", "cudnn": None, "torch_op": None,
               "fold": None, "wgrad": None}


def cuda_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, key, reps=10):
    """Device milliseconds a call of the CUDA kernels whose names hold `key`
    (every kernel when None), by torch.profiler over reps calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kernels
               if key is None or key in e.key) / reps / 1e3


def digest(out) -> str:
    """A digest of the bits of a call's output tensors (nested tuples too):
    per tensor, the sum of its 16- or 32-bit words and of each word times
    its position modulo a prime, as hex."""
    if isinstance(out, (tuple, list)):
        return "-".join(digest(t) for t in out)
    words = out.contiguous().view(-1).view(torch.int16 if out.element_size() == 2
                                           else torch.int32).to(torch.int64)
    pos = torch.arange(words.numel(), device=words.device) % 65521 + 1
    return f"{int(words.sum()) & 0xffffffff:08x}{int((words * pos).sum()) & 0xffffffff:08x}"


def make_call(kernels, kernel, shape, o, mode, dtype, gen):
    if kernel in ("dh_fold", "cudnn"):
        return make_probe_call(kernel, mode)
    if kernel in ("fold", "wgrad"):
        return make_wgrad_call(kernels[2], kernel, shape, o, mode, dtype, gen)
    if kernel in ("mosaic", "torch_op"):
        from hyperpri_tpu_torch.ops.kernels import probe_mosaic_ops

        x = probe_mosaic_ops.probe_input("cuda")
        if kernel == "mosaic":
            return lambda: probe_mosaic_ops.run_case(mode, x)
        return lambda: probe_mosaic_ops.run_case_reference(mode, x)
    conv3x3_bias_act_shift, conv3x3_bias_act = kernels[:2]
    n, h, w, c = shape
    x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    pa = 0.5 + torch.rand((c,), generator=gen, device="cuda")
    pb = 0.5 * torch.randn((c,), generator=gen, device="cuda")
    wk = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (9 * c) ** 0.5).to(dtype)
    b = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    if kernel == "shift":
        return lambda: conv3x3_bias_act_shift(x, wk, b, relu=False)
    if mode == "adjoint":
        zero = torch.zeros_like(b)
        return lambda: conv3x3_bias_act(x, wk, zero, relu=False)
    if mode == "prologue":
        return lambda: conv3x3_bias_act(x, wk, b, pa, pb, relu=False, with_stats=True)
    return lambda: conv3x3_bias_act(x, wk, b, relu=False, with_stats=True)


def make_wgrad_call(conv3x3_wgrad, kernel, shape, o, mode, dtype, gen):
    """The fold mode of conv3x3_wgrad ("fold") or the non-fold kernel on the
    materialized g_eff ("wgrad") at one call: x (in the pre-padded ingest
    buffer for mode "pre_padded"), gy and y (N, H, W, O), gsum and gsumsq,
    pa and pb for mode "prologue"."""
    from hyperpri_tpu_torch.ops.kernels import _plain, framing

    n, h, w, c = shape
    x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    gy, y = (torch.randn((n, h, w, o), generator=gen, device="cuda").to(dtype) for _ in range(2))
    gsum = torch.randn((o,), generator=gen, device="cuda")
    gsumsq = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    pa = pb = None
    kw = {}
    if mode == "prologue":
        pa = 0.5 + torch.rand((c,), generator=gen, device="cuda")
        pb = 0.5 * torch.randn((c,), generator=gen, device="cuda")
    if mode == "pre_padded":
        (hp, wp, cp), _, _ = framing.ingest_spec(h, w, c)
        buf = torch.zeros((n, hp, wp, cp), dtype=dtype, device="cuda")
        buf[:, 1:1 + h, 1:1 + w, :c] = x
        x, kw = buf, dict(pre_padded_c=c)
    if kernel == "fold":
        return lambda: conv3x3_wgrad(x, gy, pa, pb, y=y, gsum=gsum, gsumsq=gsumsq, **kw)
    g_eff = _plain.fold_stats_cotangent(gy, gsum, gsumsq, y, dtype)
    return lambda: conv3x3_wgrad(x, g_eff, pa, pb, **kw)


def make_probe_call(kernel, mode):
    """A dh-fold probe kernel through its public function on the probe's
    inputs (`build`, seed 0), or the cuDNN call of the same function."""
    import torch.nn.functional as F

    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold

    n, h, w = PROBE_SHAPE
    (cur, a_cur), (fold, a_fold) = probe_dh_fold.build(n=n, h=h, w=w, device="cuda")
    if kernel == "dh_fold":
        return (lambda: cur(*a_cur)) if mode == "current" else (lambda: fold(*a_fold))
    x64 = a_fold[0]
    wo = x64.shape[2] - 8
    # W[dh][c, dw*64 + o] -> OIHW weights of the real 64 lanes
    w_oihw = (a_cur[1][:, :64].reshape(3, 64, 3, 64).permute(3, 1, 0, 2)
              .contiguous(memory_format=torch.channels_last))
    x_cl = x64.permute(0, 3, 1, 2)[..., :wo + 2]
    return lambda: F.conv2d(x_cl, w_oihw)


def main():
    args = sys.argv[1:]
    groups = {call[-1] for call in CALLS}
    if not args or not set(args[1:]) <= groups or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    wanted = set(args[1:]) or groups
    root = os.path.abspath(args[0])
    sys.path.insert(0, root)
    os.chdir(root)
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import conv3x3_bias_act_shift

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    kernels = (conv3x3_bias_act_shift, conv3x3_bias_act, conv3x3_wgrad)
    print(f"{args[0]} on {card}", flush=True)
    sums = {}
    for label, kernel, shape, o, mode, dtype, count, group in CALLS:
        if group not in wanted:
            continue
        fn = make_call(kernels, kernel, shape, o, mode, DTYPES[dtype], gen)
        bits = digest(fn())
        ms, dev = cuda_ms(fn), device_ms(fn, DEVICE_KEYS[kernel])
        name = f"{kernel} {mode}" if kernel == "dh_fold" else kernel
        total = sums.setdefault(f"{name} {dtype} {group}", [0.0, 0.0, 0])
        total[0] += ms * count
        total[1] += dev * count
        total[2] += count
        print(f"  {label:34s} {kernel:8s} {dtype:4s} x{count} wrapper {ms:.4f} ms, device "
              f"{dev:.4f} ms, bits {bits}", flush=True)
        del fn
        torch.cuda.empty_cache()
    for key, (ms, dev, count) in sums.items():
        print(f"  sum {key:32s} over {count:2d} calls: wrapper {ms:.4f} ms, device {dev:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
