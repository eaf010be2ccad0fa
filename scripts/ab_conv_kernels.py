"""Time the port's conv kernels at CubeNET-64's training-step shapes for one
source tree, to compare two commits of hyperpri_tpu_torch on the same card
within one job:

    git archive <parent> | tar -x -C build/parent      # a gitignored directory
    python3 scripts/ab_conv_kernels.py build/parent
    python3 scripts/ab_conv_kernels.py .
    python3 scripts/ab_conv_kernels.py .
    python3 scripts/ab_conv_kernels.py build/parent

Each run imports hyperpri_tpu_torch from the given tree (building its kernels
there) and calls the unframed modes both trees have, on seeded bf16 inputs at
batch 2 (batch 1 for the serving call): per call it prints the median
wrapper time by CUDA events (20 timed calls after 3 warm-ups) and the device
time of the call's kernels from torch.profiler over 10 calls. Needs a CUDA
device; imports no JAX.
"""

import os
import statistics
import subprocess
import sys

import torch

H, W = 608, 968
CALLS = [  # (label, kernel, shape (N, H, W, C), O, mode)
    ("first_conv stats", "packed", (2, H, W, 238), 64, "stats"),
    ("inc2 stats+prologue", "packed", (2, H, W, 64), 64, "prologue"),
    ("inc2 bwd_x", "packed", (2, H, W, 64), 64, "bwd_x"),
    ("up4.conv1 stats", "packed", (2, H, W, 128), 64, "stats"),
    ("serving 64->64 relu", "packed", (1, H, W, 64), 64, "relu"),
    ("down1.conv2 stats+prologue", "halo", (2, 304, 484, 128), 128, "prologue"),
    ("down1.conv1 stats", "halo", (2, 304, 484, 64), 128, "stats"),
    ("first_conv wgrad", "wgrad", (2, H, W, 238), 64, "plain"),
    ("inc2 wgrad prologue", "wgrad", (2, H, W, 64), 64, "prologue"),
]


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


def make_call(kernels, kernel, shape, o, mode, gen):
    conv3x3_packed, conv3x3_bias_act, conv3x3_wgrad = kernels
    n, h, w, c = shape

    def rand(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)

    x = rand(n, h, w, c)
    pa = 0.5 + torch.rand((c,), generator=gen, device="cuda")
    pb = 0.5 * torch.randn((c,), generator=gen, device="cuda")
    if kernel == "wgrad":
        g = rand(n, h, w, o)
        return (lambda: conv3x3_wgrad(x, g, pa, pb)) if mode == "prologue" else (
            lambda: conv3x3_wgrad(x, g))
    wk = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (9 * c) ** 0.5).to(
        torch.bfloat16)
    b = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    fn = conv3x3_packed if kernel == "packed" else conv3x3_bias_act
    if mode == "bwd_x":
        r = rand(n, h, w, o)
        qa = 0.5 + torch.rand((o,), generator=gen, device="cuda")
        qb = 0.5 * torch.randn((o,), generator=gen, device="cuda")
        return lambda: fn(x, wk, torch.zeros_like(b), qa, qb, r, relu=False)
    if mode == "relu":
        return lambda: fn(x, wk, b, relu=True)
    if mode == "prologue":
        return lambda: fn(x, wk, b, pa, pb, relu=False, with_stats=True)
    return lambda: fn(x, wk, b, relu=False, with_stats=True)


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1])
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
    print(f"{sys.argv[1]} on {card}", flush=True)
    for label, kernel, shape, o, mode in CALLS:
        fn = make_call(kernels, kernel, shape, o, mode, gen)
        print(f"  {label:28s} wrapper {cuda_ms(fn):.4f} ms, device {device_ms(fn):.4f} ms",
              flush=True)
        del fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
