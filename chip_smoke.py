"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  (a) environment: card name and power limit, torch / CUDA / nvcc versions;
  (b) build every CUDA kernel from hyperpri_tpu_torch/csrc, one nvcc each, all
      started together; ptxas's register and spill report is printed;
  (c) each kernel and each of its modes against its plain PyTorch version on
      the card, at the shapes the two main paths give it and at ragged ones;
      every reducing kernel twice, for identical bits;
  (d) serving: CubeNET-64 answering two full-resolution 608x968x238 bf16 cubes
      through the folded, kernel-routed model, with the launch count read
      around that run and the logits held against the same folded model on
      F.conv2d and against the unfolded model in float32;
  (e) training: three steps of CubeNET-64 at batch 2, 608x968x238, bf16
      compute, float32 parameters, masked BCE, Adam(1e-3), through the
      trainable kernel convs and the pool-backward kernel, with the launch
      counts read around those steps and held against the counts the routing
      predicts (derived by walking the model), the loss finite and falling on
      a repeated batch, the BatchNorm running statistics moving, and step 1's
      loss, logits and gradients held against the same model on cuDNN and
      autograd in bf16 and in float32;
  (f) times (CUDA events, median of repeated runs after warm-up): every kernel
      call of a training step and of a serving forward beside its bound, its
      plain version and one library call; the serving forward and the training
      step with kernels on and off; peak memory of a step;
  (g) a torch.profiler breakdown of one kernel-route training step.
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

# Published H100 SXM peaks (dense bf16 tensor rate, float32 rate outside the
# tensor cores, HBM3 bandwidth); bound_ms is the larger of ops / peak and
# bytes / PEAK_BYTES.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

H, W, D = 608, 968, 238
N_REQUESTS = 2
TRAIN_BATCH = 2
TRAIN_STEPS = 3
TIMING_REPS = 10

# Ragged conv shapes: odd H/W, C=238 (4-byte loads), C not a multiple of 8
# (element loads), O = 48 / 96 / 128 / 256 and an odd O.
RAGGED_CONV = [((1, 37, 53, 238), 48), ((2, 29, 71, 238), 128), ((1, 17, 33, 61), 64),
               ((1, 37, 53, 238), 96), ((2, 29, 71, 64), 256), ((1, 17, 33, 61), 131)]
RAGGED_POOL = [(1, 10, 14, 238), (1, 6, 8, 7), (2, 16, 24, 64)]
# Kernel vs plain version, bf16 outputs: one bf16 ulp of max(|kernel|, |plain|,
# 2**-6). The floor covers outputs that cancel to below the float32 round-off
# of their 9*C-term sums, where the two summation orders may differ by more
# than an ulp of the tiny result.
ULP_FLOOR = 2.0 ** -6
# Float32 per-channel sums (sum y, sum y*y, dpa, dpb, dW): kernel and plain
# version add the same float32 terms in different orders. With K terms of
# absolute sum A, a sequential float32 sum errs by at most K * 2**-24 * A and a
# blocked one (both are blocked: per tile, then over tiles) by roughly
# sqrt(K) * 2**-24 * A. K is N*H*W <= 1.18e6 here, so sqrt(K) * 2**-24 = 6.5e-5;
# the largest error measured on an H100 was 5.6e-6 * A.
SUM_REL = 2e-5
# Whole serving model: the folded bf16 kernel route against the same folded
# model on F.conv2d ("plain") and against the unfolded model in float32
# ("unfolded"). bf16 rounding compounds through ~two dozen convs; on an H100
# the measured worst cases were rel L2 6.5e-3 and 4.9e-3, sign agreement
# 0.99908 and 0.99933.
MODEL_REL_L2 = 1e-2
MODEL_SIGN_AGREE = 0.999
# Training step 1 from the same seeded weights on the same batch: the kernel
# route in bf16 and the stock route (cuDNN + autograd) in bf16, each against the
# stock route in float32: relative loss difference, rel L2 of the logits, rel
# L2 of all gradients taken together, and the worst leaf's error over max(its
# norm, 1e-2 of the largest leaf norm). Two bf16 runs round at different places
# (the kernels add the bias and take the statistics in float32 before rounding),
# so each is held against float32, and the kernel route may be at most
# TRAIN_VS_STOCK times as far from it as the stock bf16 route is.
# Measured on an H100 (the same digits in three runs): kernel route 1.47e-4,
# 2.52e-2, 4.26e-2, 0.541; stock bf16 route 1.48e-4, 2.52e-2, 4.21e-2, 0.537.
TRAIN_LOSS_REL = 1e-3
TRAIN_LOGIT_REL_L2 = 4e-2
TRAIN_GRAD_REL_L2 = 7e-2
TRAIN_LEAF_REL = 0.8
TRAIN_VS_STOCK = 1.2


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


def sum_error(out: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """max |out - ref| / scale, scale being the sum of the absolute terms."""
    err = (out.double() - ref.double()).abs() / scale.double().clamp_min(1e-30)
    return err.max().item()


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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(bound_ms, bound_by)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# The kernel calls of the two main paths, derived by walking the models.

def _conv_input_shapes(model, batch):
    """{module name: (n, h, w, c)} of every 3x3 conv, from an eval forward on
    the meta device (no device work; the shapes are those of training)."""
    from hyperpri_tpu_torch.models import parts

    shapes = {}
    handles = [
        m.register_forward_hook(lambda mod, inp, _, name=name: shapes.__setitem__(
            name, tuple(inp[0].shape)))
        for name, m in model.named_modules()
        if isinstance(m, (parts.Conv3x3, parts.ServingConv3x3))]
    model(torch.empty((batch, H, W, D), device="meta"))
    for handle in handles:
        handle.remove()
    return shapes


def serving_calls():
    """conv3x3_packed calls of one folded serving forward at batch 1."""
    from hyperpri_tpu_torch.models import parts
    from hyperpri_tpu_torch.models.cubenet import CubeNET

    meta = CubeNET(fused_bn=True).to("meta")   # F.conv2d route: same shapes
    calls = []
    for name, (n, h, w, c) in _conv_input_shapes(meta, 1).items():
        o = meta.get_submodule(name).weight.shape[0]
        if parts.packed_serving_route(h, w, c, o):
            calls.append(dict(kernel="conv3x3_packed", path="serving", layer=name, mode="relu",
                              shape=(n, h, w, c), o=o))
    return calls


def training_calls():
    """Every kernel call of one training step at batch 2, by the routing
    rules: Conv3x3's gates choose the layers; forward O <= 64 is packed, else
    halo; the adjoint of a statistics conv is packed up to 128 outputs, that
    of a BatchNorm-ReLU boundary takes the packed epilogue up to 64 channels
    and the halo kernel above; one weight gradient per layer; the first conv
    has no adjoint; pools with even maps and whole channel vectors take the
    pool-backward kernel."""
    from hyperpri_tpu_torch.models.cubenet import CubeNET
    from hyperpri_tpu_torch.ops.pool import pool_bwd_kernel_route

    meta = CubeNET(use_kernels=True).to("meta")
    shapes = _conv_input_shapes(meta, TRAIN_BATCH)
    calls = []
    for name, (n, h, w, c) in shapes.items():
        conv = meta.get_submodule(name)
        if not conv.kernel_route(h, w):
            continue
        o = conv.weight.shape[0]
        bnact = name.endswith("conv2") or name == "inc2_conv"   # reads relu(pa*x + pb)
        common = dict(path="training", layer=name)
        calls.append(dict(kernel="conv3x3_packed" if o <= 64 else "conv3x3_bias_act",
                          mode="stats+prologue" if bnact else "stats",
                          shape=(n, h, w, c), o=o, **common))
        calls.append(dict(kernel="conv3x3_wgrad", mode="prologue" if bnact else "plain",
                          shape=(n, h, w, c), o=o, **common))
        if name == "first_conv":
            continue
        adjoint = dict(shape=(n, h, w, o), o=c, **common)   # cotangent in, dx out
        if bnact and c <= conv.bnact_packed_max_bc:
            calls.append(dict(kernel="conv3x3_packed", mode="bwd_x", **adjoint))
        elif bnact:
            calls.append(dict(kernel="conv3x3_packed" if c <= 64 else "conv3x3_bias_act",
                              mode="adjoint", **adjoint))
        else:
            calls.append(dict(kernel="conv3x3_packed" if c <= 128 else "conv3x3_bias_act",
                              mode="adjoint", **adjoint))
    # each pool reads the block before it: same map, that block's output channels
    feeds = {"down1": "inc2_conv", "down2": "down1.conv.conv2", "down3": "down2.conv.conv2",
             "down4": "down3.conv.conv2"}
    for name, feed in feeds.items():
        n, h, w, _ = shapes[feed]
        c = meta.get_submodule(feed).weight.shape[0]
        if pool_bwd_kernel_route(h, w, c):
            calls.append(dict(kernel="max_pool_2x2_bwd", path="training", layer=f"{name}.pool",
                              mode="first-max", shape=(n, h, w, c), o=c))
    return calls


def count_by_kernel(calls):
    counts = {}
    for call in calls:
        counts[call["kernel"]] = counts.get(call["kernel"], 0) + 1
    return counts


# ---------------------------------------------------------------------------
# One kernel call: inputs, kernel, plain version, library call, bound.

def conv_inputs(shape, o, gen):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    wk = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (9 * c) ** 0.5
          ).to(torch.bfloat16)
    b = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    return x, wk, b


def affine_inputs(channels, gen):
    pa = 0.5 + torch.rand((channels,), generator=gen, device="cuda")
    pb = 0.5 * torch.randn((channels,), generator=gen, device="cuda")
    return pa, pb


class Case:
    """One kernel call on seeded inputs: `run()` launches the kernel, `plain()`
    its plain version, `library()` one PyTorch call of the same function (a
    yardstick only); `flops`, `nbytes` give the bound."""

    def __init__(self, call, gen):
        from hyperpri_tpu_torch.ops.kernels import conv3x3, conv3x3_grad, conv3x3_packed, pool_bwd

        self.call = call
        kernel, mode, shape, o = call["kernel"], call["mode"], call["shape"], call["o"]
        n, h, w, c = shape
        pixels = n * h * w
        self.peak = PEAK_BF16_FLOPS
        if kernel == "max_pool_2x2_bwd":
            x = torch.randn(shape, generator=gen, device="cuda").relu().to(torch.bfloat16)
            g = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda").to(torch.bfloat16)
            self.fn, self.ref = pool_bwd.max_pool_2x2_bwd, pool_bwd.max_pool_2x2_bwd_reference
            self.args, self.kwargs = (x, g), {}
            x_cl = x.permute(0, 3, 1, 2)
            pooled, idx = F.max_pool2d(x_cl, 2, 2, return_indices=True)
            g_cl = g.permute(0, 3, 1, 2)
            self.library = lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g_cl, x_cl, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
            self.flops = 4.0 * pixels * c                      # compares
            self.nbytes = 2.0 * pixels * c * (1 + 0.25 + 1)    # x, g read; dx written
            self.peak = PEAK_F32_FLOPS
            return
        self.flops = 2.0 * pixels * 9 * c * o
        if kernel == "conv3x3_wgrad":
            x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            g = torch.randn((n, h, w, o), generator=gen, device="cuda").to(torch.bfloat16)
            pa, pb = affine_inputs(c, gen) if mode == "prologue" else (None, None)
            self.fn, self.ref = conv3x3_grad.conv3x3_wgrad, conv3x3_grad.conv3x3_wgrad_reference
            self.args, self.kwargs = (x, g, pa, pb), {}
            x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            w_oihw = torch.empty((o, c, 3, 3), device="cuda", dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            self.library = lambda: torch.ops.aten.convolution_backward(
                g_cl, x_cl, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False])
            self.nbytes = 2.0 * pixels * (c + o) + 4.0 * 9 * c * o
            return
        packed = kernel == "conv3x3_packed"
        module = conv3x3_packed if packed else conv3x3
        self.fn = module.conv3x3_packed if packed else module.conv3x3_bias_act
        self.ref = (module.conv3x3_packed_reference if packed
                    else module.conv3x3_bias_act_reference)
        x, wk, b = conv_inputs(shape, o, gen)
        self.nbytes = 2.0 * pixels * (c + o) + 2.0 * 9 * c * o + 4.0 * o
        pa = pb = r = None
        if "prologue" in mode:
            pa, pb = affine_inputs(c, gen)
            self.nbytes += 8.0 * c
        if mode == "bwd_x":
            pa, pb = affine_inputs(o, gen)
            r = torch.randn((n, h, w, o), generator=gen, device="cuda").to(torch.bfloat16)
            b = torch.zeros_like(b)
            self.nbytes += 2.0 * pixels * o + 8.0 * o
        if mode == "adjoint":
            b = torch.zeros_like(b)
        self.kwargs = dict(relu=mode == "relu", with_stats=mode.startswith("stats"))
        self.args = (x, wk, b, pa, pb) + ((r,) if packed else ())
        w_oihw = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_cl, b16 = x.permute(0, 3, 1, 2), b.to(torch.bfloat16)
        self.library = lambda: F.conv2d(x_cl, w_oihw, b16, padding=1)

    def run(self):
        return self.fn(*self.args, **self.kwargs)

    def plain(self):
        return self.ref(*self.args, **self.kwargs)

    def label(self) -> str:
        c = self.call
        n, h, w, ch = c["shape"]
        return (f"{c['kernel']:17s} {c['mode']:15s} {c.get('layer', 'ragged'):15s} "
                f"{n}x{h}x{w} {ch:3d}->{c['o']:3d}")

    def verify(self):
        """Kernel vs plain version; reducing modes twice for identical bits.
        -> (max abs error of the main output, max relative error of the sums)."""
        kernel, mode = self.call["kernel"], self.call["mode"]
        out, ref = self.run(), self.plain()
        torch.cuda.synchronize()
        if kernel == "max_pool_2x2_bwd":
            check(torch.equal(out, ref), f"{self.label()}: differs from the plain version")
            return 0.0, 0.0
        if kernel == "conv3x3_wgrad":
            x, g, pa, pb = self.args
            scale = self.ref(x.abs() if pa is None else x, g.abs(), pa, pb)
            again = self.run()
            check(torch.equal(out, again), f"{self.label()}: two runs differ")
            check(bool(torch.isfinite(out).all()), f"{self.label()}: non-finite dW")
            rel = sum_error(out, ref, scale)
            check(rel <= SUM_REL, f"{self.label()}: dW off by {rel} of its absolute sum")
            return (out - ref).abs().max().item(), rel
        sums = ref_sums = None
        if isinstance(out, tuple):
            (out, sums), (ref, ref_sums) = out, ref
        check(out.shape == ref.shape and out.dtype == torch.bfloat16,
              f"{self.label()}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{self.label()}: non-finite output")
        ulps, abs_err = bf16_ulp_error(out, ref)
        check(ulps <= 1.0, f"{self.label()}: {ulps} bf16 ulp > 1")
        rel = 0.0
        if sums is not None:
            rf = ref.float()
            if mode == "bwd_x":
                pa, r = self.args[3], self.args[5].float()
                mdz = rf.abs() / pa   # |m*dz| up to the rounding of dx
                scales = ((mdz * r.abs()).sum(dim=(0, 1, 2)), mdz.sum(dim=(0, 1, 2)))
            else:
                scales = (rf.abs().sum(dim=(0, 1, 2)), (rf * rf).sum(dim=(0, 1, 2)))
            rel = max(sum_error(s, rs, sc) for s, rs, sc in zip(sums, ref_sums, scales))
            check(rel <= SUM_REL, f"{self.label()}: sums off by {rel} of their absolute sum")
            out2, sums2 = self.run()
            check(torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(sums, sums2)),
                  f"{self.label()}: two runs differ")
        return abs_err, rel


def distinct(calls):
    """Calls with distinct (kernel, mode, shape, o), each with its multiplicity
    and the layers that make it."""
    groups = {}
    for call in calls:
        key = (call["kernel"], call["mode"], call["shape"], call["o"], call["path"])
        group = groups.setdefault(key, dict(call, count=0, layers=[]))
        group["count"] += 1
        group["layers"].append(call["layer"])
    return list(groups.values())


# ---------------------------------------------------------------------------

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
    built = _build.build_all(force=True)
    print(f"built {', '.join(built)} in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, (_, log) in built.items():
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
        print(f"-- {name}\n" + "\n".join(report))
        _build.load(name)


def phase_kernel_check(calls):
    phase("(c) every kernel and mode vs its plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    ragged = []
    for shape, o in RAGGED_CONV:
        kernels = ["conv3x3_bias_act"] + (["conv3x3_packed"] if o <= 128 else [])
        for kernel in kernels:
            for mode in ("relu", "stats", "stats+prologue"):
                ragged.append(dict(kernel=kernel, mode=mode, shape=shape, o=o))
        if o <= 128:
            ragged.append(dict(kernel="conv3x3_packed", mode="bwd_x", shape=shape, o=o))
        for mode in ("plain", "prologue"):
            ragged.append(dict(kernel="conv3x3_wgrad", mode=mode, shape=shape, o=o))
    ragged += [dict(kernel="max_pool_2x2_bwd", mode="first-max", shape=s, o=s[-1])
               for s in RAGGED_POOL]
    errors = {}
    for call in distinct(calls) + [dict(c, path="ragged", layer="ragged") for c in ragged]:
        case = Case(call, gen)
        abs_err, rel = case.verify()
        print(f"{case.label()}: max abs {abs_err:.3e}, sums rel {rel:.2e}")
        worst = errors.setdefault(call["kernel"], [0.0, 0.0])
        worst[0], worst[1] = max(worst[0], abs_err), max(worst[1], rel)
        del case
    check_pool_ties()
    torch.cuda.empty_cache()
    for kernel, (abs_err, rel) in errors.items():
        print(f"worst {kernel}: max abs {abs_err:.3e}, sums rel {rel:.2e} (limit {SUM_REL})")
    return errors


def check_pool_ties():
    """max_pool_2x2_bwd exactly, ties included: a constant input, an input with
    duplicated maxima, and windows of -inf."""
    from hyperpri_tpu_torch.ops.kernels.pool_bwd import (
        max_pool_2x2_bwd, max_pool_2x2_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (2, 64, 96, 64)
    g = torch.randn((2, 32, 48, 64), generator=gen, device="cuda").to(torch.bfloat16)
    dup = torch.randint(0, 2, shape, generator=gen, device="cuda").to(torch.bfloat16)
    holes = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.7,
                        torch.full(shape, -float("inf"), device="cuda"),
                        torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)
    for name, x in (("constant", torch.full(shape, 1.5, device="cuda", dtype=torch.bfloat16)),
                    ("duplicated maxima", dup), ("-inf windows", holes)):
        dx = max_pool_2x2_bwd(x, g)
        check(torch.equal(dx, max_pool_2x2_bwd_reference(x, g)), f"pool backward, {name}")
        routed = dx.float().reshape(2, 32, 2, 48, 2, 64).sum(dim=(2, 4))
        check(torch.equal(routed, g.float()), f"pool backward, {name}: not one element a window")
        if name == "constant":
            check(torch.equal(dx[:, ::2, ::2], g) and int((dx != 0).sum()) == int((g != 0).sum()),
                  "pool backward, constant input: not the first element")
        print(f"max_pool_2x2_bwd   {name}: exact")


def make_requests(gen, n_requests, batch):
    reqs = []
    for _ in range(n_requests):
        image = torch.randn((batch, H, W, D), generator=gen, device="cuda").to(torch.bfloat16)
        mask = (torch.rand((batch, H, W, 1), generator=gen, device="cuda") < 0.3).float()
        reqs.append({"image": image, "mask": mask,
                     "valid": torch.ones(batch, device="cuda")})
    return reqs


def kernel_wrappers():
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
    from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import conv3x3_packed
    from hyperpri_tpu_torch.ops.kernels.pool_bwd import max_pool_2x2_bwd

    return {"conv3x3_packed": conv3x3_packed, "conv3x3_bias_act": conv3x3_bias_act,
            "conv3x3_wgrad": conv3x3_wgrad, "max_pool_2x2_bwd": max_pool_2x2_bwd}


def zero_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_serving(calls):
    phase("(d) CubeNET-64 serving, 608x968x238 bf16, batch 1")
    from hyperpri_tpu_torch.ops.metrics import dice_from_stats
    from hyperpri_tpu_torch.serve import build_cubenet_server

    unfolded = build_cubenet_server(0, folded=False, dtype=torch.float32)
    server = build_cubenet_server(0, folded=True, use_kernels=True)
    plain = build_cubenet_server(0, folded=True, use_kernels=False)
    reqs = make_requests(torch.Generator(device="cuda").manual_seed(2), N_REQUESTS, 1)
    expected = count_by_kernel(calls)

    zero_launches()
    results = [server.serve(req) for req in reqs]
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"launches during the {N_REQUESTS} requests: {launches}; "
          f"the routing predicts {expected} a request")
    for name, count in launches.items():
        check(count == N_REQUESTS * expected.get(name, 0),
              f"serving: {count} {name} launches, predicted {expected.get(name, 0)} a request")

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

    def forward_ms(srv):
        cubes = itertools.cycle([req["image"] for req in reqs])
        with torch.inference_mode():
            return cuda_ms(lambda: srv.model(next(cubes)))

    model_ms = {}  # in turns on one card: off, on, on, off
    for label, srv in (("kernels_off", plain), ("kernels_on", server),
                       ("kernels_on_again", server), ("kernels_off_again", plain)):
        model_ms[label] = forward_ms(srv)
        print(f"serving forward {label}: {model_ms[label]:.4f} ms/cube, "
              f"{1e3 / model_ms[label]:.3f} cubes/s")
    del unfolded, server, plain, results
    torch.cuda.empty_cache()
    return launches, model_ms


def step_errors(run, ref):
    """A training step's record {"loss", "logits", "grads"} against another:
    relative loss difference, rel L2 of the logits, sign agreement, rel L2 over
    all gradients, and the worst leaf's error over max(its norm, 1e-2 of the
    largest leaf norm) with that leaf's name."""
    num = den = 0.0
    leaves = {}
    for name, g in run["grads"].items():
        d = (g.double() - ref["grads"][name].double()).norm().item()
        r = ref["grads"][name].double().norm().item()
        num, den = num + d * d, den + r * r
        leaves[name] = (d, r)
    floor = 1e-2 * max(r for _, r in leaves.values())
    worst = max(leaves, key=lambda k: leaves[k][0] / max(leaves[k][1], floor))
    return {
        "loss": abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
        "logits": float((run["logits"] - ref["logits"]).norm() / ref["logits"].norm()),
        "agree": float(((run["logits"] > 0) == (ref["logits"] > 0)).float().mean()),
        "grads": (num / den) ** 0.5,
        "leaf": leaves[worst][0] / max(leaves[worst][1], floor), "leaf_name": worst,
    }


def phase_training(calls):
    phase(f"(e) CubeNET-64 training, batch {TRAIN_BATCH}, 608x968x238 bf16, Adam(1e-3)")
    from hyperpri_tpu_torch.train.step import build_cubenet_trainer

    expected = count_by_kernel(calls)
    print(f"the routing predicts per step: {expected}")
    batches = make_requests(torch.Generator(device="cuda").manual_seed(4), 2, TRAIN_BATCH)
    batches[1]["valid"] = torch.tensor([1.0, 0.0], device="cuda")   # a padded entry
    order = [batches[0], batches[1], batches[0]][:TRAIN_STEPS]

    model, opt, step = build_cubenet_trainer(0, use_kernels=True, return_logits=True)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, first = [], None
    for i, batch in enumerate(order):
        logs = step(batch)
        torch.cuda.synchronize()
        loss = float(logs["loss_sum"] / logs["n"])
        check(loss == loss and abs(loss) != float("inf"), f"step {i + 1}: loss {loss}")
        check(bool(torch.isfinite(logs["logits"]).all()), f"step {i + 1}: non-finite logits")
        check(tuple(logs["logits"].shape) == (TRAIN_BATCH, H, W, 1), "logits shape")
        losses.append(loss)
        if i == 0:
            first = {"loss": loss, "logits": logs["logits"].clone(),
                     "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
        print(f"step {i + 1}: loss {loss:.6f}  n {float(logs['n']):.0f}  "
              f"stats {[int(v) for v in logs['stats']]}")
    launches = read_launches()
    peak_on = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"launches during the {TRAIN_STEPS} steps: {launches}")
    for name, count in launches.items():
        check(count == TRAIN_STEPS * expected.get(name, 0),
              f"training: {count} {name} launches, predicted {expected.get(name, 0)} a step")
    check(losses[2] < losses[0], f"the loss did not fall on the repeated batch: {losses}")
    moved = [k for k, v in model.state_dict().items() if "running" in k
             and not torch.equal(v, before[k])]
    check(len(moved) == len(before), "some BatchNorm running statistics did not move")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "non-finite parameter")
    print(f"loss on the repeated batch: {losses[0]:.6f} -> {losses[2]:.6f}; all "
          f"{len(before)} running statistics moved; peak memory {peak_on:.3f} GiB")

    # Step 1 against cuDNN + autograd, same seeded weights, same batch.
    records = {"kernels": first}
    for label, dtype in (("stock_bf16", torch.bfloat16), ("stock_f32", torch.float32)):
        ref_model, _, ref_step = build_cubenet_trainer(0, use_kernels=False, dtype=dtype,
                                                       return_logits=True)
        zero_launches()
        logs = ref_step(order[0])
        check(sum(read_launches().values()) == 0, "the reference model launched a kernel")
        records[label] = {"loss": float(logs["loss_sum"] / logs["n"]), "logits": logs["logits"],
                          "grads": {n: p.grad for n, p in ref_model.named_parameters()}}
        del ref_model, ref_step, logs
    errs = {}
    for run, ref in (("kernels", "stock_f32"), ("stock_bf16", "stock_f32"),
                     ("kernels", "stock_bf16")):
        e = errs[run, ref] = step_errors(records[run], records[ref])
        print(f"step 1, {run} vs {ref}: loss {records[run]['loss']:.6f} vs "
              f"{records[ref]['loss']:.6f} (rel {e['loss']:.2e}), logits rel L2 "
              f"{e['logits']:.3e}, sign agreement {e['agree']:.6f}, gradients rel L2 "
              f"{e['grads']:.3e}, worst leaf {e['leaf']:.3e} ({e['leaf_name']})")
    ours, stock = errs["kernels", "stock_f32"], errs["stock_bf16", "stock_f32"]
    check(ours["loss"] <= TRAIN_LOSS_REL and ours["logits"] <= TRAIN_LOGIT_REL_L2
          and ours["grads"] <= TRAIN_GRAD_REL_L2 and ours["leaf"] <= TRAIN_LEAF_REL,
          f"step 1, kernels vs float32: limits {TRAIN_LOSS_REL}, {TRAIN_LOGIT_REL_L2}, "
          f"{TRAIN_GRAD_REL_L2}, {TRAIN_LEAF_REL}")
    for key in ("logits", "grads", "leaf"):
        check(ours[key] <= TRAIN_VS_STOCK * stock[key],
              f"step 1: the kernel route is {ours[key] / stock[key]:.2f}x as far from float32 "
              f"as the stock bf16 route in {key} (limit {TRAIN_VS_STOCK}x)")
    del records, first
    torch.cuda.empty_cache()

    # Step time, kernels on and off in turns on one card: off, on, on, off.
    off_model, _, off_step = build_cubenet_trainer(0, use_kernels=False)
    step_ms = {}
    peak = {"kernels_on": peak_on}
    for label, fn in (("kernels_off", off_step), ("kernels_on", step),
                      ("kernels_on_again", step), ("kernels_off_again", off_step)):
        torch.cuda.reset_peak_memory_stats()
        step_ms[label] = cuda_ms(lambda: fn(order[0]), reps=5)
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"training step {label}: {step_ms[label]:.3f} ms "
              f"({TRAIN_BATCH * 1e3 / step_ms[label]:.2f} cubes/s), peak {peak[label]:.3f} GiB")
    del off_model, off_step
    torch.cuda.empty_cache()
    return launches, step_ms, peak, step, order[0]


def phase_times(calls, card):
    phase(f"(f) kernel times on {card}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for call in distinct(calls):
        case = Case(call, gen)
        ms = cuda_ms(case.run)
        plain_ms = cuda_ms(case.plain, reps=3, warmup=1)
        library_ms = cuda_ms(case.library)
        bound_ms, bound_by = bound(case.flops, case.nbytes, case.peak)
        n, h, w, c = call["shape"]
        rows.append({"kernel": call["kernel"], "path": call["path"], "mode": call["mode"],
                     "layers": call["layers"], "count": call["count"], "shape": [n, h, w, c],
                     "o": call["o"], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "flops": case.flops,
                     "bytes": case.nbytes})
        rate = (f"{case.flops / ms / 1e9:6.1f} TFLOP/s" if call["kernel"] != "max_pool_2x2_bwd"
                else f"{case.nbytes / ms / 1e9:6.3f} TB/s")
        print(f"{case.label()} x{call['count']} ({call['path']}): kernel {ms:.4f} ms ({rate}), "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, "
              f"library {library_ms:.4f} ms")
        del case
    torch.cuda.empty_cache()
    return rows


def phase_profile(step, batch):
    phase("(g) where the time goes: torch.profiler over one kernel-route training step")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("the profiler recorded no device time")
        return
    print(f"device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall for the step "
          f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, profiler on); "
          f"{sum(e.count for e in kernels)} device kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {e.count:4d} calls  "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}%  {e.key[:90]}")


REPLACES = {
    "conv3x3_packed": ("hyperpri_tpu_torch/csrc/conv3x3_packed.cu",
                       "hyperpri_tpu/ops/pallas/conv3x3_packed.py:308"),
    "conv3x3_bias_act": ("hyperpri_tpu_torch/csrc/conv3x3.cu",
                         "hyperpri_tpu/ops/pallas/conv3x3.py:125"),
    "conv3x3_wgrad": ("hyperpri_tpu_torch/csrc/conv3x3_grad.cu",
                      "hyperpri_tpu/ops/pallas/conv3x3_grad.py:184"),
    "max_pool_2x2_bwd": ("hyperpri_tpu_torch/csrc/pool_bwd.cu",
                         "hyperpri_tpu/ops/pallas/pool_bwd.py:82"),
}


def kernel_summary(rows, errors, serving_launches, training_launches):
    """One entry per kernel. ms, plain_ms, library_ms and bound_ms are sums over
    the kernel's calls in one pass of each main path (one training step, and
    for conv3x3_packed one serving forward); launches are those counted during
    the paths' runs."""
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        mine = [r for r in rows if r["kernel"] == name]
        flops = sum(r["flops"] * r["count"] for r in mine)
        nbytes = sum(r["bytes"] * r["count"] for r in mine)
        peak = PEAK_F32_FLOPS if name == "max_pool_2x2_bwd" else PEAK_BF16_FLOPS
        bound_ms, bound_by = bound(flops, nbytes, peak)
        by_path = {"serving": serving_launches.get(name, 0),
                   "training": training_launches.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errors[name][0], "max_sum_rel_err": errors[name][1],
            "ms": sum(r["ms"] * r["count"] for r in mine),
            "plain_ms": sum(r["plain_ms"] * r["count"] for r in mine),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(r["library_ms"] * r["count"] for r in mine),
            "calls": mine,
        })
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import hyperpri_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay float32
    torch.backends.cudnn.allow_tf32 = False        # and so does the float32 reference model
    card = phase_env()
    phase_build()
    serve_calls, train_calls = serving_calls(), training_calls()
    errors = phase_kernel_check(serve_calls + train_calls)
    serving_launches, serving_ms = phase_serving(serve_calls)
    training_launches, step_ms, peak, step, batch = phase_training(train_calls)
    rows = phase_times(serve_calls + train_calls, card)
    phase_profile(step, batch)
    kernels = kernel_summary(rows, errors, serving_launches, training_launches)
    print(card)
    print(json.dumps({"kernels": kernels, "serving_ms_per_cube": serving_ms,
                      "training_ms_per_step": step_ms, "training_peak_gib": peak}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
