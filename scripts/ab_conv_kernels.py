"""Time the port's 3x3 conv kernels at the training steps' and serving's
calls for one source tree, to compare two commits of hyperpri_tpu_torch on the
same card within one job:

    git archive <parent> | tar -x -C build/parent      # a gitignored directory
    python3 scripts/ab_conv_kernels.py build/parent
    python3 scripts/ab_conv_kernels.py .
    python3 scripts/ab_conv_kernels.py .
    python3 scripts/ab_conv_kernels.py build/parent

Each run imports hyperpri_tpu_torch from the given tree (building its kernels
there) and calls, on seeded inputs: the targets, every distinct float32 call
of conv3x3_packed (8 a UNET step, 9 a CubeNET-64 step, the first reading the
host pre-padded ingest buffer) of the CLI's default run, a UNET step on RGB
and a CubeNET-64 step on HSI, each with its multiplicity; as controls, every
distinct bf16 call of conv3x3_packed in a product-loop step (9 at batch 2,
the first reading the ingest buffer) and in a served cube (4 at batch 1),
and every distinct float32 call of conv3x3_bias_act (12 a step) and
conv3x3_wgrad (11 a CubeNET-64 step). Per call it prints the median wrapper
time by CUDA events (20 timed calls after 3 warm-ups), the device time of
the call's kernels from torch.profiler over 10 calls and a digest of the
call's output bits (two trees whose digests agree computed the same bits);
then, per kernel, dtype and group (unet_f32, cubenet_f32, control), the sums
over the calls (time x multiplicity). The card's name and power limit come
first. Needs a CUDA device; imports no JAX.
"""

import os
import statistics
import subprocess
import sys

import torch

H, W = 608, 968
# (label, kernel, shape (N, H, W, C), O, mode, dtype, calls, group)
CALLS = [
    # targets: the float32 calls of conv3x3_packed of a UNET step (608x968x3)
    # and of a CubeNET-64 step (608x968x238, ingest buffer)
    ("inc/up4.conv2 stats+prologue", "packed", (2, H, W, 64), 64, "prologue", "f32", 2,
     "unet_f32"),
    ("inc/up4.conv2 bwd_x", "packed", (2, H, W, 64), 64, "bwd_x", "f32", 2, "unet_f32"),
    ("down1.conv1 adjoint", "packed", (2, 304, 484, 128), 64, "adjoint", "f32", 1, "unet_f32"),
    ("down2.conv1 adjoint", "packed", (2, 152, 242, 256), 128, "adjoint", "f32", 1,
     "unet_f32"),
    ("up4.conv1 stats", "packed", (2, H, W, 128), 64, "stats", "f32", 1, "unet_f32"),
    ("up4.conv1 adjoint", "packed", (2, H, W, 64), 128, "adjoint", "f32", 1, "unet_f32"),
    # the CubeNET-64 step makes the same calls and the first conv: timed once,
    # counted in both groups by the sums below
    ("first_conv stats pre-padded", "packed", (2, H, W, 238), 64, "pre_padded", "f32", 1,
     "cubenet_f32"),
    # controls: kernels and forms this comparison does not target (kernel 1
    # in bf16; kernels 2 and 3 in float32, whose shared pieces moved)
    ("first_conv stats pre-padded", "packed", (2, H, W, 238), 64, "pre_padded", "bf16", 1,
     "control"),
    ("inc2/up4.conv2 stats+prologue", "packed", (2, H, W, 64), 64, "prologue", "bf16", 2,
     "control"),
    ("inc2/up4.conv2 bwd_x", "packed", (2, H, W, 64), 64, "bwd_x", "bf16", 2, "control"),
    ("down1.conv1 adjoint", "packed", (2, 304, 484, 128), 64, "adjoint", "bf16", 1, "control"),
    ("down2.conv1 adjoint", "packed", (2, 152, 242, 256), 128, "adjoint", "bf16", 1, "control"),
    ("up4.conv1 stats", "packed", (2, H, W, 128), 64, "stats", "bf16", 1, "control"),
    ("up4.conv1 adjoint", "packed", (2, H, W, 64), 128, "adjoint", "bf16", 1, "control"),
    ("serving first_conv", "packed", (1, H, W, 238), 64, "relu", "bf16", 1, "control"),
    ("serving inc2/up4.conv2", "packed", (1, H, W, 64), 64, "relu", "bf16", 2, "control"),
    ("serving up4.conv1", "packed", (1, H, W, 128), 64, "relu", "bf16", 1, "control"),
    ("down1.conv1 stats", "halo", (2, 304, 484, 64), 128, "stats", "f32", 1, "control"),
    ("down1/up3.conv2 stats+prologue", "halo", (2, 304, 484, 128), 128, "prologue", "f32", 2,
     "control"),
    ("down1/up3.conv2 adjoint", "halo", (2, 304, 484, 128), 128, "adjoint", "f32", 2,
     "control"),
    ("up3.conv1 stats", "halo", (2, 304, 484, 256), 128, "stats", "f32", 1, "control"),
    ("up3.conv1 adjoint", "halo", (2, 304, 484, 128), 256, "adjoint", "f32", 1, "control"),
    ("down2.conv1 stats", "halo", (2, 152, 242, 128), 256, "stats", "f32", 1, "control"),
    ("down2/up2.conv2 stats+prologue", "halo", (2, 152, 242, 256), 256, "prologue", "f32", 2,
     "control"),
    ("down2/up2.conv2 adjoint", "halo", (2, 152, 242, 256), 256, "adjoint", "f32", 2,
     "control"),
    ("inc/up4.conv2 wgrad prologue", "wgrad", (2, H, W, 64), 64, "prologue", "f32", 2,
     "control"),
    ("up4.conv1 wgrad", "wgrad", (2, H, W, 128), 64, "plain", "f32", 1, "control"),
    ("down1.conv1 wgrad", "wgrad", (2, 304, 484, 64), 128, "plain", "f32", 1, "control"),
    ("down1/up3.conv2 wgrad prologue", "wgrad", (2, 304, 484, 128), 128, "prologue", "f32", 2,
     "control"),
    ("up3.conv1 wgrad", "wgrad", (2, 304, 484, 256), 128, "plain", "f32", 1, "control"),
    ("down2.conv1 wgrad", "wgrad", (2, 152, 242, 128), 256, "plain", "f32", 1, "control"),
    ("down2/up2.conv2 wgrad prologue", "wgrad", (2, 152, 242, 256), 256, "prologue", "f32", 2,
     "control"),
    ("first_conv wgrad pre-padded", "wgrad", (2, H, W, 238), 64, "pre_padded", "f32", 1,
     "control"),
]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


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


def device_ms(fn, reps=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "conv3x3" in e.key) / reps / 1e3


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


def ingest_buffer(x):
    """x (N, H, W, C) inside the host pre-padded ingest buffer: logical (0, 0)
    at (1, 1), channel pitch rounded up to 32, zeros around."""
    n, h, w, c = x.shape
    buf = torch.zeros((n, h + 2, w + 2, -(-c // 32) * 32), dtype=x.dtype, device=x.device)
    buf[:, 1:1 + h, 1:1 + w, :c] = x
    return buf


def make_call(kernels, kernel, shape, o, mode, dtype, gen):
    conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad = kernels
    n, h, w, c = shape

    def rand(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    x = rand(n, h, w, c)
    pa = 0.5 + torch.rand((c,), generator=gen, device="cuda")
    pb = 0.5 * torch.randn((c,), generator=gen, device="cuda")
    if kernel == "wgrad":
        g = rand(n, h, w, o)
        if mode == "pre_padded":
            xb = ingest_buffer(x)
            return lambda: conv3x3_wgrad(xb, g, pre_padded_c=c)
        return (lambda: conv3x3_wgrad(x, g, pa, pb)) if mode == "prologue" else (
            lambda: conv3x3_wgrad(x, g))
    wk = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (9 * c) ** 0.5).to(dtype)
    b = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    fn = conv3x3_packed if kernel == "packed" else conv3x3_bias_act
    if mode == "pre_padded":
        xb = ingest_buffer(x)
        return lambda: fn(xb, wk, b, relu=False, with_stats=True, pre_padded=True,
                          logical_hw=(h, w))
    if mode == "relu":
        return lambda: fn(x, wk, b)
    if mode == "bwd_x":
        r = rand(n, h, w, o)
        qa = 0.5 + torch.rand((o,), generator=gen, device="cuda")
        qb = 0.5 * torch.randn((o,), generator=gen, device="cuda")
        return lambda: fn(x, wk, torch.zeros_like(b), qa, qb, r, relu=False)
    if mode == "adjoint":
        zero = torch.zeros_like(b)
        return lambda: fn(x, wk, zero, relu=False)
    if mode == "prologue":
        return lambda: fn(x, wk, b, pa, pb, relu=False, with_stats=True)
    return lambda: fn(x, wk, b, relu=False, with_stats=True)


def main():
    args = sys.argv[1:]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    root = os.path.abspath(args[0])
    sys.path.insert(0, root)
    os.chdir(root)
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    kernels = (conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad)
    print(f"{args[0]} on {card}", flush=True)
    sums = {}
    for label, kernel, shape, o, mode, dtype, count, group in CALLS:
        fn = make_call(kernels, kernel, shape, o, mode, DTYPES[dtype], gen)
        bits = digest(fn())
        ms, dev = cuda_ms(fn), device_ms(fn)
        # a UNET step's float32 calls are also calls of the CubeNET-64 step
        for g in ((group, "cubenet_f32") if group == "unet_f32" else (group,)):
            total = sums.setdefault(f"{kernel} {dtype} {g}", [0.0, 0.0, 0])
            total[0] += ms * count
            total[1] += dev * count
            total[2] += count
        print(f"  {label:34s} {kernel:6s} {dtype:4s} x{count} wrapper {ms:.4f} ms, device "
              f"{dev:.4f} ms, bits {bits}", flush=True)
        del fn
        torch.cuda.empty_cache()
    for key, (ms, dev, count) in sums.items():
        print(f"  sum {key:22s} over {count:2d} calls: wrapper {ms:.4f} ms, device {dev:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
