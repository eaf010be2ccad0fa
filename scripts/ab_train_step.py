"""Time the port's CubeNET-64 training step for one source tree, to compare
two commits of hyperpri_tpu_torch on the same card within one job:

    git archive <other> | tar -x -C build/other      # a gitignored directory
    python3 scripts/ab_train_step.py build/other
    python3 scripts/ab_train_step.py .
    python3 scripts/ab_train_step.py .
    python3 scripts/ab_train_step.py build/other

Each run imports hyperpri_tpu_torch from the given tree (building its kernels
there), builds the kernel-route trainer from seed 0 (batch 2, 608x968x238
bf16 compute, float32 parameters, masked BCE, Adam(1e-3)) and prints the card,
the median ms per step over 10 steps after 3 warm-ups on one seeded batch,
the peak memory of a step, and, from torch.profiler over 3 steps, the device
time per step in all kernels and in the port's own kernels. Needs a CUDA
device; imports no JAX.
"""

import os
import statistics
import subprocess
import sys

import torch


def cuda_ms(fn, reps=10, warmup=3):
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


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyperpri_tpu_torch.train.step import build_cubenet_trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"image": torch.randn((2, 608, 968, 238), generator=gen,
                                  device="cuda").to(torch.bfloat16),
             "mask": (torch.rand((2, 608, 968, 1), generator=gen, device="cuda") < 0.3).float(),
             "valid": torch.ones(2, device="cuda")}
    _, _, step = build_cubenet_trainer(0, use_kernels=True)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 3e3
    own = sum(e.self_device_time_total for e in kernels
              if any(k in e.key for k in ("conv3x3", "reduce_rows", "pool_bwd"))) / 3e3
    print(f"{sys.argv[1]} on {card}: training step {ms:.4f} ms, peak {peak:.4f} GiB, "
          f"device busy {busy:.4f} ms/step, of which the port's kernels {own:.4f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
