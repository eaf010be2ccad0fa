"""Time the port's CubeNET-64 serving forward for one source tree, to compare
two commits of hyperpri_tpu_torch on the same card within one job:

    git archive <parent> | tar -x -C build/parent      # a gitignored directory
    python3 scripts/ab_serving_forward.py build/parent
    python3 scripts/ab_serving_forward.py .
    python3 scripts/ab_serving_forward.py .
    python3 scripts/ab_serving_forward.py build/parent

Each run imports hyperpri_tpu_torch from the given tree (building its kernels
there), and prints the card, the median ms per 608x968x238 bf16 forward with
kernels off, on, on, off (20 timed forwards each after 3 warm-ups, three
cubes in turn), and, from torch.profiler over three forwards, the device time
per forward in all kernels and in the port's own conv kernels. Needs a CUDA
device; imports no JAX.
"""

import os
import statistics
import subprocess
import sys

import torch


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


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyperpri_tpu_torch.serve import build_cubenet_server

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(2)
    cubes = [torch.randn((1, 608, 968, 238), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(3)]
    on = build_cubenet_server(0, folded=True, use_kernels=True)
    off = build_cubenet_server(0, folded=True, use_kernels=False)
    turn = [0]

    def forward(server):
        def run():
            turn[0] += 1
            with torch.inference_mode():
                server.model(cubes[turn[0] % 3])
        return run

    times = [cuda_ms(forward(s)) for s in (off, on, on, off)]
    print(f"{sys.argv[1]} on {card}: ms/cube kernels off {times[0]:.4f}, on {times[1]:.4f}, "
          f"on {times[2]:.4f}, off {times[3]:.4f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            forward(on)()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 3e3
    own = sum(e.self_device_time_total for e in kernels if "conv3x3" in e.key) / 3e3
    print(f"{sys.argv[1]}: device busy {busy:.4f} ms/forward, of which the port's conv "
          f"kernels {own:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
