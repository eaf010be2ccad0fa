"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  (a) environment: card name and power limit, torch / CUDA / nvcc versions;
  (b) build every CUDA kernel of the serving path from hyperpri_tpu_torch/csrc;
  (c) each kernel against its plain PyTorch version on the card, at the main
      path's shapes and at ragged ones;
  (d) the slice: CubeNET-64 serving four full-resolution 608x968x238 bf16
      cubes through the folded, kernel-routed model, with the kernel launch
      counts read around that run and the logits held against the same folded
      model on F.conv2d and against the unfolded model in float32;
  (e) times (CUDA events, median of repeated runs after warm-up): each kernel
      layer beside its plain version, one cuDNN call and its bound, and the
      whole model with kernels on and off;
  (f) a torch.profiler breakdown of the kernel-route forward by device kernel.
The line before the last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# Published H100 SXM peaks (dense bf16 tensor rate, HBM3 bandwidth); bound_ms
# is the larger of ops / PEAK_BF16_FLOPS and bytes / PEAK_BYTES.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

H, W, D, FD = 608, 968, 238, 64
N_REQUESTS = 4
TIMING_REPS = 10

# The four layers of folded CubeNET-64 that take conv3x3_packed.
PACKED_LAYERS = [
    ("first_conv", 238, 64),
    ("inc2_conv", 64, 64),
    ("up4.conv.conv1", 128, 64),
    ("up4.conv.conv2", 64, 64),
]
# Ragged shapes: odd H/W, C=238 (4-byte loads), O=48 and O=128, ReLU off; and
# odd C (element loads).
RAGGED = [((1, 37, 53, 238), 48, False), ((2, 29, 71, 238), 128, False),
          ((1, 17, 33, 61), 64, True)]
# Kernel vs plain version: one bf16 ulp of max(|kernel|, |plain|, 2**-6). The
# floor covers outputs that cancel to below the float32 round-off of their
# 9*C-term sums, where the two summation orders may differ by more than an
# ulp of the tiny result.
ULP_FLOOR = 2.0 ** -6
# Whole model: the folded bf16 kernel route against the same folded model on
# F.conv2d ("plain") and against the unfolded model in float32 ("unfolded",
# the most exact reference: folding in float32 changes logits by ~1e-6). bf16
# rounding compounds through ~two dozen convs; on an H100 the measured worst
# cases were rel L2 6.5e-3 and 4.9e-3, sign agreement 0.99908 and 0.99933.
MODEL_REL_L2 = 1e-2
MODEL_SIGN_AGREE = 0.999


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def phase(name: str):
    print(f"== {name}", flush=True)


def bf16_ulp_error(out: torch.Tensor, ref: torch.Tensor):
    """(max error in bf16 ulps, max abs error)."""
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (o - r).abs()
    return (diff / ulp).max().item(), diff.max().item()


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the current stream, by CUDA events."""
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


def conv_bound(n, h, w, c, o):
    """(bound_ms, bound_by, flops, bytes) of one conv3x3_packed call:
    x, w (bf16), b (f32) read once and y (bf16) written once."""
    flops = 2.0 * n * h * w * c * o * 9
    nbytes = 2.0 * n * h * w * c + 2.0 * 9 * c * o + 4.0 * o + 2.0 * n * h * w * o
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def conv_inputs(shape, o, gen):
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    wk = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (9 * c) ** 0.5
          ).to(torch.bfloat16)
    b = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    return x, wk, b


def forward_flops():
    """(all, conv3x3_packed-route) FLOPs of one 608x968 forward, from the
    layer shapes (a forward on the meta device, no device work)."""
    from hyperpri_tpu_torch.models import parts
    from hyperpri_tpu_torch.models.cubenet import CubeNET

    counts = {"all": 0, "packed": 0}

    def hook(mod, inputs, _):
        n, h, w, c = inputs[0].shape
        if isinstance(mod, parts.ConvTransposeUp):
            flops = 2 * n * h * w * c * mod.weight.shape[1] * 4
        else:
            o, _, kh, kw = mod.weight.shape
            flops = 2 * n * h * w * c * o * kh * kw
        counts["all"] += flops
        if isinstance(mod, parts.ServingConv3x3) and parts.packed_serving_route(
                h, w, c, mod.weight.shape[0]):
            counts["packed"] += flops

    meta = CubeNET(fused_bn=True).to("meta")
    handles = [m.register_forward_hook(hook) for m in meta.modules()
               if isinstance(m, parts._Conv)]
    meta(torch.empty((1, H, W, D), device="meta"))
    for handle in handles:
        handle.remove()
    return counts["all"], counts["packed"]


def phase_env():
    phase("(a) environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    from hyperpri_tpu_torch.ops.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc: {nvcc[-1]}")
    print(f"device: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    return card


def phase_build():
    phase("(b) build")
    from hyperpri_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _, log = _build.build("conv3x3_packed", force=True)
    print(f"built conv3x3_packed in {time.perf_counter() - t0:.2f} s")
    print(log.strip())
    _build.load("conv3x3_packed")


def phase_kernel_check():
    phase("(c) conv3x3_packed vs conv3x3_packed_reference on the card")
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import (
        conv3x3_packed, conv3x3_packed_reference)

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [((1, H, W, c), o, True, name) for name, c, o in PACKED_LAYERS]
    cases += [(shape, o, relu, "ragged") for shape, o, relu in RAGGED]
    errors = {}
    for shape, o, relu, name in cases:
        x, wk, b = conv_inputs(shape, o, gen)
        out = conv3x3_packed(x, wk, b, relu=relu)
        ref = conv3x3_packed_reference(x, wk, b, relu=relu)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == torch.bfloat16,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        ulps, abs_err = bf16_ulp_error(out, ref)
        n_diff = int((out != ref).sum())
        print(f"{name:16s} x{tuple(shape)} O={o} relu={relu}: max {ulps:.3f} bf16 ulp, "
              f"max abs {abs_err:.3e}, {n_diff} of {out.numel()} elements differ")
        check(ulps <= 1.0, f"{name} {shape}->{o}: {ulps} ulp > 1")
        errors[name] = max(errors.get(name, 0.0), abs_err)
    return errors


def make_requests(gen):
    reqs = []
    for _ in range(N_REQUESTS):
        image = torch.randn((1, H, W, D), generator=gen, device="cuda").to(torch.bfloat16)
        mask = (torch.rand((1, H, W, 1), generator=gen, device="cuda") < 0.3).float()
        reqs.append({"image": image, "mask": mask,
                     "valid": torch.ones(1, device="cuda")})
    return reqs


def phase_slice():
    phase("(d) CubeNET-64 serving, 608x968x238 bf16, batch 1")
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed
    from hyperpri_tpu_torch.ops.metrics import dice_from_stats
    from hyperpri_tpu_torch.serve import build_cubenet_server

    unfolded = build_cubenet_server(0, folded=False, dtype=torch.float32)
    server = build_cubenet_server(0, folded=True, use_kernels=True)
    plain = build_cubenet_server(0, folded=True, use_kernels=False)
    reqs = make_requests(torch.Generator(device="cuda").manual_seed(2))

    conv3x3_packed.launches = 0
    results = []
    for i, req in enumerate(reqs):
        before = conv3x3_packed.launches
        out = server.serve(req)
        torch.cuda.synchronize()
        got = conv3x3_packed.launches - before
        check(got == len(PACKED_LAYERS), f"request {i}: {got} conv3x3_packed launches")
        results.append(out)
    launches = conv3x3_packed.launches

    worst = {"plain": [0.0, 1.0], "unfolded": [0.0, 1.0]}  # max rel L2, min agreement
    for i, (req, out) in enumerate(zip(reqs, results)):
        logits = out["logits"]
        check(tuple(logits.shape) == (1, H, W, 1) and logits.dtype == torch.float32,
              f"logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), f"request {i}: non-finite logits")
        dice = float(dice_from_stats(out["stats"]))
        loss = float(out["loss_sum"] / out["n"])
        line = f"request {i}: loss {loss:.6f} dice {dice:.6f}"
        for name, other in (("plain", plain), ("unfolded", unfolded)):
            ref = other.serve(req)["logits"]
            rel = float((logits - ref).norm() / ref.norm())
            agree = float(((logits > 0) == (ref > 0)).float().mean())
            line += f" | vs {name}: rel L2 {rel:.3e}, sign agreement {agree:.6f}"
            check(rel <= MODEL_REL_L2 and agree >= MODEL_SIGN_AGREE,
                  f"request {i} vs {name}: rel L2 {rel}, agreement {agree}")
            worst[name] = [max(worst[name][0], rel), min(worst[name][1], agree)]
        print(line)
    for name, (rel, agree) in worst.items():
        print(f"worst vs {name}: rel L2 {rel:.4e}, sign agreement {agree:.6f} "
              f"(limits {MODEL_REL_L2}, {MODEL_SIGN_AGREE})")
    print(f"conv3x3_packed launches during the {N_REQUESTS} requests: {launches}")
    return launches, server, plain, reqs


def phase_times(server, plain, reqs, card):
    phase(f"(e) times on {card}")
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import (
        conv3x3_packed, conv3x3_packed_reference)

    gen = torch.Generator(device="cuda").manual_seed(3)
    layers = []
    for name, c, o in PACKED_LAYERS:
        x, wk, b = conv_inputs((1, H, W, c), o, gen)
        w_oihw = wk.permute(3, 2, 0, 1).contiguous()
        b16 = b.to(torch.bfloat16)
        x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view of the same buffer
        ms = cuda_ms(lambda: conv3x3_packed(x, wk, b, relu=True))
        plain_ms = cuda_ms(lambda: conv3x3_packed_reference(x, wk, b, relu=True))
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_oihw, b16, padding=1))
        bound_ms, bound_by, flops, nbytes = conv_bound(1, H, W, c, o)
        layers.append({"layer": name, "c": c, "o": o, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "flops": flops, "bytes": nbytes})
        print(f"layer {name:16s} {c:3d}->{o}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms, F.conv2d {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")

    def forward_ms(srv):
        cubes = itertools.cycle([req["image"] for req in reqs])
        with torch.inference_mode():
            return cuda_ms(lambda: srv.model(next(cubes)))

    total, packed = forward_flops()
    print(f"forward: {total / 1e9:.3f} GFLOP per cube, of which {packed / 1e9:.3f} "
          f"GFLOP ({100 * packed / total:.1f}%) in the conv3x3_packed layers")
    model = {}  # in turns on one card: off, on, on, off
    for label, srv in (("kernels_off", plain), ("kernels_on", server),
                       ("kernels_on_again", server), ("kernels_off_again", plain)):
        model[label] = forward_ms(srv)
        print(f"model {label}: {model[label]:.4f} ms/cube, "
              f"{1e3 / model[label]:.3f} cubes/s, {total / model[label] / 1e9:.1f} TFLOP/s")
    return layers, model


def phase_profile(server, reqs):
    phase("(f) where the time goes: torch.profiler over three kernel-route forwards")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        server.model(reqs[0]["image"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for req in reqs[:3]:
                server.model(req["image"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("the profiler recorded no device time")
        return
    print(f"device busy {busy_ms / 3:.4f} ms per forward of {wall_ms / 3:.4f} ms wall "
          f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, profiler on)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 3e3:9.4f} ms/forward  {e.count // 3:4d} calls  "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}%  {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import hyperpri_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version stays float32
    torch.backends.cudnn.allow_tf32 = False
    card = phase_env()
    phase_build()
    errors = phase_kernel_check()
    launches, server, plain, reqs = phase_slice()
    layers, model = phase_times(server, plain, reqs, card)
    phase_profile(server, reqs)
    t_ops = sum(l["flops"] for l in layers) / PEAK_BF16_FLOPS
    t_bytes = sum(l["bytes"] for l in layers) / PEAK_BYTES
    kernels = [{
        "name": "conv3x3_packed",
        "route": "cuda",
        "source": "hyperpri_tpu_torch/csrc/conv3x3_packed.cu",
        "replaces": "hyperpri_tpu/ops/pallas/conv3x3_packed.py:308",
        "launches": launches,
        "max_abs_err": max(errors.values()),
        "ms": sum(l["ms"] for l in layers),
        "plain_ms": sum(l["plain_ms"] for l in layers),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(l["library_ms"] for l in layers),
        "layers": layers,
        "model_ms_per_cube": model,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
