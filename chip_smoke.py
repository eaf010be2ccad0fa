"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  (a) environment: card name and power limit, torch / CUDA / nvcc versions;
  (b) build every CUDA kernel from hyperpri_tpu_torch/csrc, one nvcc each, all
      started together; ptxas's register and spill report is printed, each
      kernel by name, with any wgmma serialization (C75xx) it reports;
  (c) each kernel and each of its modes and framings, in bf16 and in float32,
      against its plain PyTorch version on the card (TF32 off), at the shapes
      the main paths give it and at ragged ones; every conv call twice,
      for identical bits (the bf16 and float32 calls of conv3x3_packed,
      conv3x3_bias_act and conv3x3_wgrad take their Hopper kernels, "sm90":
      TMA staging and wgmma, 3xTF32 in float32, conv3x3_packed with
      persistent blocks, in every mode and framing at ragged shapes too,
      C = 61 and 238 included; layouts TMA cannot address take the
      synchronous ones, "legacy"; each check of the three conv kernels holds
      the body it took against the plan's, and each float32 Hopper call is
      also held against the synchronous body on the same inputs; the float32
      convs' weight split, with the pitch C and with whole 32-channel
      chunks, bit for bit against its plain version);
      the kernels on no model path too: the weight
      gradient's fold mode (every framing, on the body its plan names: the
      Hopper one, "sm90", wherever TMA can address x, g and y; its dW
      bit-equal to the non-fold kernel on the same body on the materialized
      g_eff, and where it took "sm90" the synchronous fold's dW bit-equal to
      the synchronous non-fold kernel's), the shift conv (at the
      ragged shapes and every conv3x3_bias_act call shape of the paths, bf16
      x also written as float32; its Hopper body, "sm90", wherever TMA can
      address x and the weights, C = 238 and 61 on the synchronous one, each
      check's body held against its plan and each Hopper call against the
      synchronous body, within one bf16 ulp or 2e-5 of |terms|), the dh-fold
      probe's two kernels at the probe's shapes (on their Hopper body, "sm90",
      as the plan names it, each within one bf16 ulp of its plain version
      and of the synchronous body, twice bit-equal) and the eight Mosaic-op
      kernels (exactly);
  (d) serving: CubeNET-64 answering two full-resolution 608x968x238 bf16 cubes
      through the folded, kernel-routed model, with the launch count read
      around that run and the
      logits held against the same folded model on F.conv2d and against the
      unfolded model in float32;
  (e) training: three steps of CubeNET-64 at batch 2, 608x968x238, bf16
      compute, float32 parameters, masked BCE, Adam(1e-3), through the
      trainable kernel convs and the pool-backward kernel, with the launch
      counts read around those steps and held against the counts the routing
      predicts (derived by walking the model) and, for conv3x3_packed,
      conv3x3_bias_act and conv3x3_wgrad, by kernel body as their plans
      choose it, the loss finite and falling on
      a repeated batch, the BatchNorm running statistics moving, and step 1's
      loss, logits and gradients held against the same model on cuDNN and
      autograd in bf16 and in float32;
  (f) times (CUDA events, median of repeated runs after warm-up): every kernel
      call of a training step and of a serving forward beside its bound, its
      plain version and one library call (float32 convs also with cuDNN's TF32
      on, and with cudnn.benchmark on, labelled; conv3x3_packed calls and
      float32 conv3x3_bias_act and conv3x3_wgrad calls and the shift conv's
      also on the synchronous body); the serving forward and the training
      step with kernels on and off; peak memory of a step; the element probe
      beside one PyTorch op; the kernels on no model path (the weight
      gradient's fold mode at the step's conv3x3_wgrad calls, the shift conv
      at its conv3x3_bias_act calls, beside the halo kernel on the same
      inputs, both also on the synchronous body: bf16 at the product-loop
      step's, float32 at the UNET and the
      CubeNET-64 step's; the dh-fold probe's two kernels on both bodies
      beside cuDNN's VALID conv; the eight Mosaic-op kernels and their
      PyTorch ops by CUDA events and by the profiler's device time);
  (l) the fold mode against today's route at each conv3x3_wgrad call of one
      bf16 product-loop step and one CubeNET-64 float32 step, in turns: g_eff
      materialized, then dW and db, against dW and db from the raw cotangent
      in one kernel (on its Hopper body, and on the synchronous one), with
      and without the g_eff pass the adjoint conv still needs; summed per
      step; both routes' dW held against float64 (at every float32
      weight-gradient shape of the UNET and CubeNET-64 steps);
  (g) a torch.profiler breakdown of one kernel-route training step;
  (h) the product loop: a synthetic experiment tree of 608x968 cubes with 299
      stored bands, train_net in bf16 for three epochs of one batch-2 step
      (the first conv reads the host pre-padded buffer; launches by framing
      held against the routing; every conv3x3_packed, conv3x3_bias_act and
      conv3x3_wgrad call, 9, 12 and 11 a step, on the Hopper kernels), a
      resumed fourth epoch held bit-equal to an
      uninterrupted run, validate_net and test_net, with seconds per epoch,
      steps per second, the device idle share of a profiled epoch, the host
      seconds per batch, and each framed kernel mode at the main path's
      shapes timed against the same call unframed, in turns;
  (j) training: three steps of UNET on RGB at batch 2, 608x968x3, float32,
      masked BCE, Adam(1e-3), through the float32 kernels (3xTF32), with the
      launch counts held against the routing, step 1 of the kernel route and
      of the stock float32 route (cuDNN + autograd, TF32 off) each held
      against a float64 run of the stock route, the loss falling on a
      repeated batch, the running statistics moving, ms per step with kernels
      on and off in turns and peak memory;
  (k) the same for CubeNET-64 at 608x968x238 in float32, the first conv
      reading a float32 host pre-padded buffer;
  (i) the CLI's kfold_train --validate at its default precision, fp32, as two
      subprocesses: --dataset RGB (UNET) and no flag (CubeNET on HSI), with
      the route each took and its float32 kernel launches;
  (m) SpectralUNET-1650 training at batch 2, 608x968x238, Adam(1e-3), on one
      pre-staged batch, in float32 (matmul TF32 off) and bf16: the smallest
      pixel chunk count of 8 and 16 that fits the card, with ms/step (median
      of 3 after 2 warm-ups), peak memory and TFLOP/s on the model FLOPs, and
      a profiled step (device busy time, its matrix products' share); the
      same with the saved residuals offloaded to pinned host memory (one
      step, timed with the pinned allocation), held bit for bit against the
      plain step; the
      offloaded per-image run (2 chunks) where MemAvailable covers its
      estimate, else the skip and the MemAvailable that caused it; the loss
      falling over 3 steps, all 18 running statistics moving, no kernel
      launched;
  (n) SpectralUNET-1650 eval of one 608x968x238 cube through
      apply_pixelwise_chunked: chunked against unchunked at 1x152x242
      (float32), ms/cube and peak memory at chunks of 65536 and 262144 pixels
      for the unfolded float32 and the folded bf16 model, the float32 fold
      against the unfolded model, and the bf16 fold's sign flips against
      those of the unfolded model in bf16;
  (o) the CLI on phase h's tree: kfold_train --model SpectralUNET --chunks K
      --validate (K from m, no kernel launched), kfold_validate over the
      three runs (phase i's UNET and CubeNET and this one), kfold_segmaps at
      the published split-1 thresholds, with seconds, the test_net results
      and the segmentation maps read back.
  (p) the host data path on phase h's tree: the native reader (built with g++
      from hyperpri_tpu_torch/native/envi_reader.cc) byte-equal to the numpy
      reader in float32 and bit-equal to torch's cast in bf16, decoded-cube
      cache entries read back equal; one batch's two cubes read by numpy
      float32, native float32, native bf16, the cache cold and warm (median
      of 3); train_net in bf16 for three epochs without and with a warm
      decoded-cube cache, with seconds per epoch, steps/s, the idle share of
      the profiled epoch and the host seconds a batch by stage;
  (q) checkpoint import: seeded UNET and CubeNET-64 at full width written by
      train/torch_export.py as a Lightning .ckpt, a raw best_wts.pt and a
      two-rank ZeRO-2 directory (bf16 module copies, float32 master shards),
      each loaded by evaluate._load_eval_state into a fresh trainer on the
      card, its logits on one 608x968 image bit-equal to the source model's;
      kfold_validate for CubeNET on phase h's tree reading the ZeRO-2
      directory;
  (r) UNET's options: the folded bf16 UNET serving two 1x608x968x3 images
      through conv3x3_packed (3 launches an image, as the routing walk
      predicts; each of those layers within one bf16 ulp of a float32 conv
      of its own input), within phase d's rel L2 of the same folded model on
      F.conv2d and of the unfolded float32 model, its sign flips against
      float32 at most 1.2x the F.conv2d model's (as in n), ms/image with
      kernels on and off in turns; UNET+ taking three float32 steps as phase j does
      (launches held against the routing walk, step 1 against float64, ms
      per step with kernels on and off, cuDNN's TF32 at torch's default);
      `analyze`'s (logits, logits, sigmoid) on the card;
  (s) the mesh path on one card: a world-1 NCCL group and
      train_net(model_parallel=True) on phase h's tree (bf16, ZeRO-sharded
      Adam on a (1, 1) mesh), three epochs of one step, without and with
      test_deepspeed (the Adam moments in pinned host memory between steps):
      the launches per step held against phase h's routing (a data-only mesh
      keeps the single-device route), the two fits' parameters bit-equal, ms
      per step on a staged batch, the device peak of each fit and the
      offload's saving; then the spatial conv's shard geometry one shard at a
      time at spatial 2 and 4: the local conv conv3x3_spatial runs on each
      halo-extended block (what the exchange delivers), stitched, against the
      unsharded kernel conv for a 64->64 conv at 608x968 (kernel 1) and a
      64->128 conv at 304x484 (kernel 2), bf16 and float32: forward bit-equal,
      dX within one bf16 ulp (1.5 on the rows that sum two shards' bf16
      partials; float32: 2e-5 of the sum of |terms|), dW within 2e-5 of the
      sum of |terms|.
The phases run in the order a-f, l, g, j, k, m, n, h, s, i, o, p, q, r. In (c) the framed modes read
buffers whose frames hold NaN. The script's elapsed seconds and the card's
name and power limit come next; the line before
the last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

# Published H100 SXM peaks (dense bf16 tensor rate, dense TF32 tensor rate,
# float32 rate outside the tensor cores, HBM3 bandwidth); bound_ms is the
# larger of ops / peak and bytes / PEAK_BYTES. The float32 convs are bounded by
# the TF32 rate: no float32-accurate route (3xTF32 spends three TF32 products
# on one) beats it, while the SIMT rate would put them over 100%.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# The conv kernels with two bodies, "sm90" and "legacy", chosen by their plans
# (hyperpri_tpu_torch/ops/kernels/sm90_plan.py).
BODIES = ("conv3x3_packed", "conv3x3_bias_act", "conv3x3_wgrad", "conv3x3_bias_act_shift")

H, W, D = 608, 968, 238
N_REQUESTS = 2
TRAIN_BATCH = 2
TRAIN_STEPS = 3
TIMING_REPS = 10

# Ragged conv shapes: odd H/W, C=238 (4-byte loads), C not a multiple of 8
# (element loads), O = 48 / 96 / 128 / 256 and an odd O.
RAGGED_CONV = [((1, 37, 53, 238), 48), ((2, 29, 71, 238), 128), ((1, 17, 33, 61), 64),
               ((1, 37, 53, 238), 96), ((2, 29, 71, 64), 256), ((1, 17, 33, 61), 131),
               ((1, 13, 37, 64), 128), ((1, 13, 37, 128), 256)]
# (the last two: the Hopper kernels' TMA box and pixel tile overhang every edge)
RAGGED_POOL = [(1, 10, 14, 238), (1, 6, 8, 7), (2, 16, 24, 64)]
# The fold mode of conv3x3_wgrad in each framing the non-fold mode takes, at
# RAGGED_FRAMED's shapes; framed g and y sit on NaN frames.
FOLD_FRAMED = [("fold", ("pre_padded",)), ("fold", ("arena_g",)),
               ("fold+prologue", ("arena_in",)), ("fold+prologue", ("arena_in", "arena_g"))]
# Framed modes at ragged shapes: the ingest buffer at C = 238 (16-byte loads
# through the 256-channel pitch) and C = 61, arenas at O = 20 and 24 (pitch 24:
# channels not a multiple of 8), as the JAX package's tests/test_arena.py and
# test_ingest.py take them.
RAGGED_FRAMED = [((1, 37, 53, 238), 48), ((2, 29, 71, 64), 20), ((1, 17, 33, 24), 64),
                 ((1, 13, 21, 61), 24)]
# conv3x3_packed's Hopper bodies at ragged shapes, where pixel tiles, two-tile
# units and TMA boxes overhang every edge: resident weights (C <= 64),
# streamed weights with two-tile units (C = 128) and 128 outputs in bf16, one
# or two O tiles of 64 in float32; C = 61 and 238, whose framed views TMA
# addresses (arena pitch 64 and 240, ingest pitch 64 and 256) and unframed
# ones it cannot; every mode in every framing, framed inputs on NaN frames.
PACKED_SM90_RAGGED = [((1, 13, 37, 64), 64), ((2, 29, 71, 128), 48), ((1, 21, 40, 96), 128),
                      ((1, 13, 21, 61), 24), ((1, 11, 45, 238), 64)]
PACKED_SM90_MODES = [
    ("relu", ()), ("stats", ()), ("stats+prologue", ()), ("bwd_x", ()), ("adjoint", ()),
    ("stats", ("pre_padded",)), ("stats", ("pre_padded", "arena_out")),
    ("stats", ("arena_out",)), ("relu", ("arena_g",)), ("stats+prologue", ("arena_in",)),
    ("adjoint", ("arena_g",)), ("bwd_x", ("arena_in", "arena_out")),
    ("bwd_x", ("arena_in", "arena_out", "arena_g")),
]
FRAMED_MODES = [
    ("conv3x3_packed", "stats", ("pre_padded",)),
    ("conv3x3_packed", "stats", ("pre_padded", "arena_out")),
    ("conv3x3_packed", "stats", ("arena_out",)),
    ("conv3x3_packed", "relu", ("arena_out",)),
    ("conv3x3_packed", "relu", ("arena_g",)),
    ("conv3x3_packed", "stats+prologue", ("arena_in",)),
    ("conv3x3_packed", "adjoint", ("arena_g",)),
    ("conv3x3_packed", "bwd_x", ("arena_in", "arena_out")),
    ("conv3x3_packed", "bwd_x", ("arena_in", "arena_out", "arena_g")),
    ("conv3x3_wgrad", "plain", ("pre_padded",)),
    ("conv3x3_wgrad", "plain", ("arena_g",)),
    ("conv3x3_wgrad", "prologue", ("arena_in",)),
    ("conv3x3_wgrad", "prologue", ("arena_in", "arena_g")),
]
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
# Float32 training step 1 (phases j and k): the kernel route (3xTF32 products,
# float32 sums in other orders) and the stock float32 route (cuDNN + autograd,
# TF32 off) each against a float64 run of the stock route from the same
# weights on the same batch. The kernel route may be at most F32_VS_STOCK
# times as far from float64 as the stock float32 route, in the loss, the
# logits and the gradients. A single-TF32 route (2**-11 a product) would be
# orders of magnitude further. The loss is one number, the mean of 1.18 M
# terms: its distance is counted from F32_LOSS_FLOOR up, a few float32 ulps,
# so that a stock route that lands on float64 by chance sets no limit of 0.
F32_VS_STOCK = 2.0
F32_LOSS_FLOOR = 1e-6


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


def cuda_times(fn, reps: int = TIMING_REPS, warmup: int = 2):
    """([CUDA-event ms], [host ms]) of each of `reps` calls of fn() on the
    current stream, after `warmup` calls. The host ms is what fn() took to
    return, the time to issue its work: where it comes near the event ms,
    the host's launch path, not the card, sets the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, host


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the current stream, by CUDA events."""
    return statistics.median(cuda_times(fn, reps, warmup)[0])


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(bound_ms, bound_by)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# The kernel calls of the two main paths, derived by walking the models.

def _conv_input_shapes(model, batch, channels=D):
    """{module name: (n, h, w, c)} of every 3x3 conv, in call order, from an
    eval forward on the meta device (no device work; the shapes are those of
    training)."""
    from hyperpri_tpu_torch.models import parts

    shapes = {}
    handles = [
        m.register_forward_hook(lambda mod, inp, _, name=name: shapes.__setitem__(
            name, tuple(inp[0].shape)))
        for name, m in model.named_modules()
        if isinstance(m, (parts.Conv3x3, parts.ServingConv3x3))]
    model(torch.empty((batch, H, W, channels), device="meta"))
    for handle in handles:
        handle.remove()
    return shapes


def serving_calls(model_name: str = "CubeNET"):
    """conv3x3_packed calls of one folded serving forward at batch 1 of
    CubeNET-64 or of UNET (bilinear=False, as build_unet_server builds it)."""
    from hyperpri_tpu_torch.models import parts
    from hyperpri_tpu_torch.models.cubenet import CubeNET
    from hyperpri_tpu_torch.models.unet import UNet

    if model_name == "UNET":   # F.conv2d route: same shapes
        meta, channels, path = UNet(3, 1, False, fused_bn=True).to("meta"), 3, "unet_serving"
    else:
        meta, channels, path = CubeNET(fused_bn=True).to("meta"), D, "serving"
    calls = []
    for name, (n, h, w, c) in _conv_input_shapes(meta, 1, channels).items():
        o = meta.get_submodule(name).weight.shape[0]
        if parts.packed_serving_route(h, w, c, o):
            calls.append(dict(kernel="conv3x3_packed", path=path, layer=name, mode="relu",
                              framing=(), shape=(n, h, w, c), o=o, dtype="bf16"))
    return calls


def _train_model(model_name: str):
    """(model with kernels on, its input channels, the conv whose output the
    first Down's pool reads) for a training path."""
    from hyperpri_tpu_torch.models.cubenet import CubeNET
    from hyperpri_tpu_torch.models.unet import UNet

    if model_name in ("UNET", "UNET+"):
        return (UNet(3, 1, bilinear=False, use_attention=model_name == "UNET+",
                     use_kernels=True), 3, "inc.conv2")
    return CubeNET(use_kernels=True), D, "inc2_conv"


def training_calls(model_name: str = "CubeNET", ingest: bool = False, dtype: str = "bf16",
                   path: str = "training"):
    """Every kernel call of one training step at batch 2, by the routing
    rules: Conv3x3's gates choose the layers; forward O <= 64 is packed, else
    halo; the adjoint of a statistics conv is packed up to 128 outputs, that
    of a BatchNorm-ReLU boundary takes the packed epilogue up to 64 channels
    and the halo kernel above; one weight gradient per layer; the network's
    first conv (the one that reads the image) has no adjoint; pools with even
    maps and whole channel vectors take the pool-backward kernel. With
    `ingest` the first conv reads the host pre-padded buffer, forward and in
    its weight gradient; every other call is unframed."""
    from hyperpri_tpu_torch.ops.pool import pool_bwd_kernel_route

    model, channels, first_feed = _train_model(model_name)
    meta = model.to("meta")
    shapes = _conv_input_shapes(meta, TRAIN_BATCH, channels)
    first = next(iter(shapes))
    calls = []
    for name, (n, h, w, c) in shapes.items():
        conv = meta.get_submodule(name)
        if not conv.kernel_route(h, w):
            continue
        o = conv.weight.shape[0]
        bnact = name.endswith("conv2") or name == "inc2_conv"   # reads relu(pa*x + pb)
        framing = ("pre_padded",) if ingest and name == first else ()
        common = dict(path=path, layer=name, framing=framing, dtype=dtype)
        calls.append(dict(kernel="conv3x3_packed" if o <= 64 else "conv3x3_bias_act",
                          mode="stats+prologue" if bnact else "stats",
                          shape=(n, h, w, c), o=o, **common))
        calls.append(dict(kernel="conv3x3_wgrad", mode="prologue" if bnact else "plain",
                          shape=(n, h, w, c), o=o, **common))
        if name == first:
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
    feeds = {"down1": first_feed, "down2": "down1.conv.conv2", "down3": "down2.conv.conv2",
             "down4": "down3.conv.conv2"}
    for name, feed in feeds.items():
        n, h, w, _ = shapes[feed]
        c = meta.get_submodule(feed).weight.shape[0]
        if pool_bwd_kernel_route(h, w, c):
            calls.append(dict(kernel="max_pool_2x2_bwd", path=path, layer=f"{name}.pool",
                              mode="first-max", framing=(), shape=(n, h, w, c), o=c,
                              dtype=dtype))
    return calls


def count_by_framing(calls):
    """{kernel: {framing flag or "unframed": count}} as the wrappers count."""
    counts = {}
    for call in calls:
        if call["kernel"] in ("conv3x3_packed", "conv3x3_wgrad"):
            by = counts.setdefault(call["kernel"], {})
            for name in call["framing"] or ("unframed",):
                by[name] = by.get(name, 0) + 1
    return counts


def count_by_body(calls):
    """{kernel: {"sm90" or "legacy": count}} for conv3x3_packed,
    conv3x3_bias_act and conv3x3_wgrad: the body each call's plan
    (ops/kernels/sm90_plan.py) takes. bf16 takes the Hopper kernels wherever
    TMA can address the views; the bf16 exceptions on a path are the unframed
    first conv of phase e and of serving (C = 238: 476-byte pixels), forward
    and weight gradient, which the product loop's ingest buffer (channel
    pitch 256) avoids. float32 takes them for all three (every call of the
    UNET and CubeNET-64 steps: 8 / 9 conv3x3_packed, 12 conv3x3_bias_act and
    10 / 11 conv3x3_wgrad, CubeNET-64's first conv, forward and weight
    gradient, through the float32 ingest buffer's 1,024-byte pixels)."""
    from hyperpri_tpu_torch.ops.kernels import framing, sm90_plan

    counts = {"conv3x3_packed": {}, "conv3x3_bias_act": {}, "conv3x3_wgrad": {}}
    for call in calls:
        n, h, w, c = call["shape"]
        o, dtype = call["o"], DTYPES[call["dtype"]]
        pitch = (framing.ingest_spec(h, w, c)[0][2] if "pre_padded" in call["framing"]
                 else c)
        if call["kernel"] == "conv3x3_packed":
            body = sm90_plan.packed_plan(n, h, w, c, o, dtype, pitch,
                                         bwd=call["mode"] == "bwd_x").path
        elif call["kernel"] == "conv3x3_bias_act":
            body = sm90_plan.bias_act_plan(n, h, w, c, o, dtype).path
        elif call["kernel"] == "conv3x3_wgrad":
            body = sm90_plan.wgrad_plan(n, h, w, c, o, dtype, pitch, o).path
        else:
            continue
        counts[call["kernel"]][body] = counts[call["kernel"]].get(body, 0) + 1
    return counts


def count_by_kernel(calls):
    counts = {}
    for call in calls:
        counts[call["kernel"]] = counts.get(call["kernel"], 0) + 1
    return counts


# ---------------------------------------------------------------------------
# One kernel call: inputs, kernel, plain version, library call, bound.

def conv_inputs(shape, o, gen, dtype=torch.bfloat16):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    wk = (torch.randn((3, 3, c, o), generator=gen, device="cuda") / (9 * c) ** 0.5).to(dtype)
    b = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    return x, wk, b


def affine_inputs(channels, gen):
    pa = 0.5 + torch.rand((channels,), generator=gen, device="cuda")
    pb = 0.5 * torch.randn((channels,), generator=gen, device="cuda")
    return pa, pb


def framed_copy(t, offset, nan_frame=True):
    """t (N, H, W, C) inside a buffer of the JAX package's framings: an arena
    (offset 8) or the host pre-padded ingest buffer (offset 1, channel pitch
    256 for C = 238). The frame is NaN, so a kernel that reads it fails the
    check; the lanes past C of logical pixels are zero, as the framings
    promise."""
    from hyperpri_tpu_torch.ops.kernels import framing

    n, h, w, c = t.shape
    if offset == framing.ARENA_OFFSET:
        shape = framing.arena_shape(n, h, w, c)
    else:
        (hp, wp, cp), _, _ = framing.ingest_spec(h, w, c)
        shape = (n, hp, wp, cp)
    buf = torch.full(shape, float("nan") if nan_frame else 0.0, dtype=t.dtype, device=t.device)
    buf[:, offset:offset + h, offset:offset + w, :] = 0
    buf[:, offset:offset + h, offset:offset + w, :c] = t
    return buf


def with_tf32(fn):
    """fn with cuDNN allowed TF32 for float32 convolutions (torch's default,
    which this script turns off), for the labelled TF32 library time."""
    def run():
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = before
    return run


def wgrad_f64(z, g):
    """dW of a 3x3 SAME conv in float64 from the conv's input z (a prologue,
    if any, already applied) and its cotangent g, both NHWC."""
    _, h, w, c = z.shape
    zp = F.pad(z.double(), (0, 0, 1, 1, 1, 1))
    g2 = g.double().reshape(-1, g.shape[-1])
    return torch.stack([zp[:, dh:dh + h, dw:dw + w, :].reshape(-1, c).t() @ g2
                        for dh in range(3) for dw in range(3)]).reshape(3, 3, c, -1)


def with_cudnn_benchmark(fn):
    """fn with cudnn.benchmark on (cuDNN times its algorithms and keeps the
    fastest; the warm-up calls pay for that), for the labelled library time
    that no heuristic pick distorts."""
    def run():
        before = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.benchmark = before
    return run


class Case:
    """One kernel call on seeded inputs of the call's dtype: `run()` launches
    the kernel, `plain()` its plain version, `library()` one PyTorch call of
    the same function on the logical tensors (a yardstick only; cuDNN's TF32
    is off, `library_tf32` the same call with it on); `flops`, `nbytes` give
    the bound. Framed operands (call["framing"]) are built with NaN frames."""

    def __init__(self, call, gen):
        from hyperpri_tpu_torch.ops.kernels import conv3x3, conv3x3_grad, conv3x3_packed, pool_bwd

        self.call = call
        kernel, mode, shape, o = call["kernel"], call["mode"], call["shape"], call["o"]
        flags = call.get("framing", ())
        self.dtype = DTYPES[call.get("dtype", "bf16")]
        dt, esize = self.dtype, (2.0 if self.dtype == torch.bfloat16 else 4.0)
        n, h, w, c = shape
        pixels = n * h * w
        self.peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS
        self.kwargs = {}
        self.out_dtype = dt
        self.out_view = lambda t: t
        self.library_tf32 = None
        if kernel == "max_pool_2x2_bwd":
            x = torch.randn(shape, generator=gen, device="cuda").relu().to(dt)
            g = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda").to(dt)
            self.fn, self.ref = pool_bwd.max_pool_2x2_bwd, pool_bwd.max_pool_2x2_bwd_reference
            self.args = (x, g)
            x_cl = x.permute(0, 3, 1, 2)
            pooled, idx = F.max_pool2d(x_cl, 2, 2, return_indices=True)
            g_cl = g.permute(0, 3, 1, 2)
            self.library = lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g_cl, x_cl, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
            self.flops = 4.0 * pixels * c                        # compares
            self.nbytes = esize * pixels * c * (1 + 0.25 + 1)    # x, g read; dx written
            self.peak = PEAK_F32_FLOPS
            return
        self.flops = 2.0 * pixels * 9 * c * o
        if flags:
            self.kwargs["logical_hw"] = (h, w)
        if kernel == "conv3x3_wgrad_fold":
            self._init_fold(mode, shape, o, flags, gen, dt, esize)
            return
        if kernel == "conv3x3_bias_act_shift":
            from hyperpri_tpu_torch.ops.kernels import conv3x3_shift

            x, wk, b = conv_inputs(shape, o, gen, dt)
            self.fn = conv3x3_shift.conv3x3_bias_act_shift
            self.ref = conv3x3_shift.conv3x3_bias_act_shift_reference
            # "conv+f32out": bf16 x written as float32
            self.out_dtype = torch.float32 if mode.endswith("f32out") else dt
            self.args = (x, wk, b)
            self.kwargs = dict(relu=mode == "relu", out_dtype=self.out_dtype)
            w_oihw = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            x_cl, b_dt = x.permute(0, 3, 1, 2), b.to(dt)
            self.library = lambda: F.conv2d(x_cl, w_oihw, b_dt, padding=1)
            if dt == torch.float32:
                self.library_tf32 = with_tf32(self.library)
            # the function's bytes: x read once (the kernel reads it three times)
            self.nbytes = esize * pixels * (c + o) + esize * 9 * c * o + 4.0 * o
            return
        if kernel == "conv3x3_wgrad":
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            g = torch.randn((n, h, w, o), generator=gen, device="cuda").to(dt)
            pa, pb = affine_inputs(c, gen) if mode == "prologue" else (None, None)
            self.fn, self.ref = conv3x3_grad.conv3x3_wgrad, conv3x3_grad.conv3x3_wgrad_reference
            x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            if "pre_padded" in flags:
                x = framed_copy(x, 1)
                self.kwargs["pre_padded_c"] = c
            if "arena_in" in flags:
                x = framed_copy(x, 8)
                self.kwargs["arena_in"] = True
            if "arena_g" in flags:
                g = framed_copy(g, 8)
                self.kwargs["arena_g"] = True
            self.args = (x, g, pa, pb)
            w_oihw = torch.empty((o, c, 3, 3), device="cuda", dtype=dt).contiguous(
                memory_format=torch.channels_last)
            self.library = lambda: torch.ops.aten.convolution_backward(
                g_cl, x_cl, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False])
            self.nbytes = esize * pixels * (c + o) + 4.0 * 9 * c * o
            if dt == torch.float32:
                self.library_tf32 = with_tf32(self.library)
            return
        packed = kernel == "conv3x3_packed"
        module = conv3x3_packed if packed else conv3x3
        self.fn = module.conv3x3_packed if packed else module.conv3x3_bias_act
        self.ref = (module.conv3x3_packed_reference if packed
                    else module.conv3x3_bias_act_reference)
        x, wk, b = conv_inputs(shape, o, gen, dt)
        self.nbytes = esize * pixels * (c + o) + esize * 9 * c * o + 4.0 * o
        pa = pb = r = None
        if "prologue" in mode:
            pa, pb = affine_inputs(c, gen)
            self.nbytes += 8.0 * c
        if mode == "bwd_x":
            pa, pb = affine_inputs(o, gen)
            r = torch.randn((n, h, w, o), generator=gen, device="cuda").to(dt)
            b = torch.zeros_like(b)
            self.nbytes += esize * pixels * o + 8.0 * o
        if mode == "adjoint":
            b = torch.zeros_like(b)
        w_oihw = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_cl, b_dt = x.permute(0, 3, 1, 2), b.to(dt)
        self.library = lambda: F.conv2d(x_cl, w_oihw, b_dt, padding=1)
        if dt == torch.float32:
            self.library_tf32 = with_tf32(self.library)
        self.logical_r = r
        if "pre_padded" in flags:
            x = framed_copy(x, 1)
            self.kwargs["pre_padded"] = True
        if "arena_g" in flags or ("arena_in" in flags and mode != "bwd_x"):
            x = framed_copy(x, 8)
            self.kwargs["arena_g" if "arena_g" in flags else "arena_in"] = True
        if "arena_in" in flags and mode == "bwd_x":
            r = framed_copy(r, 8)
            self.kwargs["arena_in"] = True
        if "arena_out" in flags:
            self.kwargs["arena_out"] = True
            self.out_view = lambda t: t[:, 8:8 + h, 8:8 + w, :o]
        self.kwargs.update(relu=mode == "relu", with_stats=mode.startswith("stats"))
        self.args = (x, wk, b, pa, pb) + ((r,) if packed else ())

    def _init_fold(self, mode, shape, o, flags, gen, dt, esize):
        """conv3x3_wgrad in fold mode: raw gy and the statistics conv's
        output y (framed alike with arena_g), gsum and gsumsq; no single
        PyTorch call computes (dW, db) of g_eff, so no library time."""
        from hyperpri_tpu_torch.ops.kernels import conv3x3_grad

        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        gy, y = (torch.randn((n, h, w, o), generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        gsum = torch.randn((o,), generator=gen, device="cuda")
        gsumsq = 0.1 * torch.randn((o,), generator=gen, device="cuda")
        pa, pb = affine_inputs(c, gen) if "prologue" in mode else (None, None)
        self.logical = dict(x=x, gy=gy, y=y, gsum=gsum, gsumsq=gsumsq, pa=pa, pb=pb)
        self.fn, self.ref = conv3x3_grad.conv3x3_wgrad, conv3x3_grad.conv3x3_wgrad_reference
        # a materialized g_eff goes to the non-fold kernel framed as gy is
        self.frame_g = lambda t: t
        if "pre_padded" in flags:
            x = framed_copy(x, 1)
            self.kwargs["pre_padded_c"] = c
        if "arena_in" in flags:
            x = framed_copy(x, 8)
            self.kwargs["arena_in"] = True
        if "arena_g" in flags:
            gy, y = framed_copy(gy, 8), framed_copy(y, 8)
            self.kwargs["arena_g"] = True
            self.frame_g = lambda t: framed_copy(t, 8)
        self.materialized_kwargs = dict(self.kwargs)
        self.args = (x, gy, pa, pb)
        self.kwargs.update(y=y, gsum=gsum, gsumsq=gsumsq)
        self.library = None
        pixels = n * h * w
        self.flops += 5.0 * pixels * o        # g_eff (4) and its column sum (1)
        self.nbytes = esize * pixels * (c + 2 * o) + 4.0 * (9 * c * o + o) + 8.0 * o

    def verify_fold(self):
        """Fold mode against its plain version on the body its plan names,
        launched there: dW and db within SUM_REL of their absolute terms, the
        same bits twice, and dW bit-equal to the non-fold kernel on the same
        body on the materialized g_eff, framed alike (the same rounded tiles,
        summed in the same order; a non-fold arena_g call's O is the arena's
        channel width, and its columns past O, the zero lanes', are not
        compared). Where the plan takes the Hopper body, the
        synchronous fold (`_legacy=True`) too: within SUM_REL, and its dW
        bit-equal to the synchronous non-fold kernel's. self.fold_report
        names the body and the synchronous fold's error."""
        from hyperpri_tpu_torch.ops.kernels import _plain

        body = self.body()
        before = dict(self.fn.launches_by_path)
        (dw, db), (dw2, db2) = self.run(), self.run()
        taken = {k for k, v in self.fn.launches_by_path.items() if v != before.get(k, 0)}
        check(taken == {body}, f"{self.label()}: launched {taken}, the plan says {body}")
        rdw, rdb = self.plain()
        lg = self.logical
        g_eff = _plain.fold_stats_cotangent(lg["gy"], lg["gsum"], lg["gsumsq"], lg["y"],
                                            self.dtype)
        g_effk = self.frame_g(g_eff)
        o = self.call["o"]
        materialized = self.fn(self.args[0], g_effk, lg["pa"], lg["pb"],
                               _legacy=body == "legacy", **self.materialized_kwargs)[..., :o]
        z = _plain.prologue_act(lg["x"], lg["pa"], lg["pb"])
        scale = self.ref(z.abs(), g_eff.abs())
        db_scale = g_eff.float().abs().sum(dim=(0, 1, 2))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(dw).all()) and bool(torch.isfinite(db).all()),
              f"{self.label()}: non-finite dW or db")
        check(torch.equal(dw, dw2) and torch.equal(db, db2), f"{self.label()}: two runs differ")
        check(torch.equal(dw, materialized),
              f"{self.label()}: dW differs from the non-fold kernel ({body}) on the "
              f"materialized g_eff")
        rel = max(sum_error(dw, rdw, scale), sum_error(db, rdb, db_scale))
        check(rel <= SUM_REL, f"{self.label()}: dW or db off by {rel} of its absolute sum")
        self.fold_report = body
        if body == "sm90":
            sdw, sdb = self.fn(*self.args, _legacy=True, **self.kwargs)
            sync = self.fn(self.args[0], g_effk, lg["pa"], lg["pb"], _legacy=True,
                           **self.materialized_kwargs)[..., :o]
            torch.cuda.synchronize()
            check(torch.equal(sdw, sync), f"{self.label()}: the synchronous fold's dW differs "
                                          f"from the synchronous non-fold kernel's")
            rel_s = max(sum_error(sdw, rdw, scale), sum_error(sdb, rdb, db_scale))
            check(rel_s <= SUM_REL,
                  f"{self.label()}: the synchronous fold off by {rel_s} of its absolute sum")
            self.fold_report += f", synchronous fold {rel_s:.2e}"
        return max((dw - rdw).abs().max().item(), (db - rdb).abs().max().item()), rel

    def run(self):
        return self.fn(*self.args, **self.kwargs)

    def body(self) -> str:
        """The kernel body ("sm90" or "legacy") a conv3x3_packed,
        conv3x3_bias_act, conv3x3_wgrad (fold mode too) or
        conv3x3_bias_act_shift call takes, by its plan."""
        from hyperpri_tpu_torch.ops.kernels import conv3x3_shift, sm90_plan
        from hyperpri_tpu_torch.ops.kernels.conv3x3_packed import call_plan

        kernel = self.call["kernel"]
        if kernel == "conv3x3_packed":
            x, wk, _, pa, _, r = self.args
            return call_plan(x, wk, pa, r, **self.kwargs).path
        if kernel == "conv3x3_bias_act_shift":
            x, wk, _ = self.args
            return conv3x3_shift.call_plan(x, wk.to(x.dtype).contiguous()).path
        if kernel in ("conv3x3_wgrad", "conv3x3_wgrad_fold"):
            from hyperpri_tpu_torch.ops.kernels import conv3x3_grad

            x, g, pa, _ = self.args
            return conv3x3_grad.call_plan(x, g, pa, **self.kwargs).path
        n, h, w, c = self.call["shape"]
        x, wk = self.args[:2]   # (x, w) as the wrapper sees them
        aligned = x.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0
        return sm90_plan.bias_act_plan(n, h, w, c, self.call["o"], self.dtype, aligned).path

    def versus_legacy(self):
        """A Hopper call against the synchronous body on the same inputs
        (`_legacy=True`) -> (error, limit): a bf16 main output in bf16 ulps
        of max(|a|, |b|, 2**-6), limit 1; a float32 one (or dW) as its
        largest difference over the sum of the absolute values of its terms,
        limit SUM_REL."""
        out = self.run()
        sync = self.fn(*self.args, _legacy=True, **self.kwargs)
        if self.call["kernel"] == "conv3x3_wgrad":
            x, g, pa, pb = self.args
            scale = self.ref(x.abs() if pa is None else x, g.abs(), pa, pb, **self.kwargs)
        else:
            out, sync = (t[0] if isinstance(t, tuple) else t for t in (out, sync))
            if out.dtype == torch.bfloat16:
                torch.cuda.synchronize()
                return bf16_ulp_error(out, sync)[0], 1.0
            scale = self.abs_terms()
        torch.cuda.synchronize()
        return sum_error(out, sync, scale), SUM_REL

    def plain(self):
        return self.ref(*self.args, **self.kwargs)

    def abs_terms(self):
        """The plain version on the absolute values of the inputs (a
        prologue's relu(pa*x + pb) is non-negative already): per output, the
        sum of the absolute values of its terms."""
        if self.call["kernel"] == "conv3x3_bias_act_shift":
            x, wk, b = self.args
            return self.ref(x.abs(), wk.abs(), b.abs(), relu=False, out_dtype=self.out_dtype)
        x, wk, b, pa, pb = self.args[:5]
        prologue = pa is not None and self.call["mode"] != "bwd_x"
        out = self.ref(x if prologue else x.abs(), wk.abs(), b.abs(), pa, pb, *self.args[5:],
                       **dict(self.kwargs, relu=False, with_stats=False))
        return out[0] if isinstance(out, tuple) else out

    def label(self) -> str:
        c = self.call
        n, h, w, ch = c["shape"]
        flags = "+".join(c.get("framing", ())) or "-"
        return (f"{c['kernel']:17s} {c.get('dtype', 'bf16'):4s} {c['mode']:15s} {flags:26s} "
                f"{c.get('layer', 'ragged'):17s} {n}x{h}x{w} {ch:3d}->{c['o']:3d}")

    def verify(self):
        """Kernel vs plain version; every conv call twice for identical bits.
        bf16 outputs within one bf16 ulp; float32 outputs, and every float32
        sum, within SUM_REL of the sum of the absolute values of its terms.
        -> (max abs error of the main output, the largest error against the
        absolute terms: of the sums, and in float32 of the outputs too)."""
        kernel, mode = self.call["kernel"], self.call["mode"]
        if kernel == "conv3x3_wgrad_fold":
            return self.verify_fold()
        out, ref = self.run(), self.plain()
        torch.cuda.synchronize()
        if kernel == "max_pool_2x2_bwd":
            check(torch.equal(out, ref), f"{self.label()}: differs from the plain version")
            return 0.0, 0.0
        if kernel == "conv3x3_wgrad":
            x, g, pa, pb = self.args
            scale = self.ref(x.abs() if pa is None else x, g.abs(), pa, pb, **self.kwargs)
            again = self.run()
            check(torch.equal(out, again), f"{self.label()}: two runs differ")
            check(bool(torch.isfinite(out).all()), f"{self.label()}: non-finite dW")
            rel = sum_error(out, ref, scale)
            check(rel <= SUM_REL, f"{self.label()}: dW off by {rel} of its absolute sum")
            return (out - ref).abs().max().item(), rel
        sums = ref_sums = None
        if isinstance(out, tuple):
            (out, sums), (ref, ref_sums) = out, ref
        check(out.shape == ref.shape and out.dtype == self.out_dtype,
              f"{self.label()}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{self.label()}: non-finite output")
        terms, rel_out = None, 0.0
        if self.out_dtype == torch.bfloat16:
            ulps, abs_err = bf16_ulp_error(out, ref)
            check(ulps <= 1.0, f"{self.label()}: {ulps} bf16 ulp > 1")
        else:
            terms = self.abs_terms()
            abs_err = (out - ref).abs().max().item()
            rel_out = sum_error(out, ref, terms)
            check(rel_out <= SUM_REL,
                  f"{self.label()}: output off by {rel_out} of its absolute terms")
        rel = 0.0
        if sums is not None:
            if mode == "bwd_x":
                pa, r = self.args[3], self.logical_r.float()
                # |m*dz|: from the rounded dx in bf16, from its absolute terms in float32
                mdz = (self.out_view(ref).float().abs() if terms is None
                       else self.out_view(terms)) / pa
                scales = ((mdz * r.abs()).sum(dim=(0, 1, 2)), mdz.sum(dim=(0, 1, 2)))
            else:
                rf = self.out_view(ref if terms is None else terms).float()
                scales = (rf.abs().sum(dim=(0, 1, 2)), (rf * rf).sum(dim=(0, 1, 2)))
            rel = max(sum_error(s, rs, sc) for s, rs, sc in zip(sums, ref_sums, scales))
            check(rel <= SUM_REL, f"{self.label()}: sums off by {rel} of their absolute sum")
            out2, sums2 = self.run()
            check(torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(sums, sums2)),
                  f"{self.label()}: two runs differ")
        else:
            check(torch.equal(out, self.run()), f"{self.label()}: two runs differ")
        return abs_err, max(rel, rel_out)


def distinct(calls):
    """Calls with distinct (kernel, mode, shape, o), each with its multiplicity
    and the layers that make it."""
    groups = {}
    for call in calls:
        key = (call["kernel"], call.get("dtype", "bf16"), call["mode"], call.get("framing", ()),
               call["shape"], call["o"], call["path"])
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
        # C75xx: ptxas serialized a kernel's wgmmas ("Potential Performance Loss")
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "warning" in ln.lower()
                  or "Compiling entry" in ln or "(C75" in ln]
        print(f"-- {name}\n" + "\n".join(report))
        if name == "conv3x3_grad":
            check_fold_report(log)
        _build.load(name)


def check_fold_report(log: str):
    """The weight gradient's Hopper fold instantiations (FOLD = true:
    `conv3x3_wgrad_sm90_kernel<true>`, `conv3x3_wgrad_sm90_f32_kernel<true>`)
    in ptxas's report: 0 spill bytes and no wgmma serialization (C75xx)."""
    entries, current = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            current = line.split("'")[1] if "'" in line else line
            entries[current] = []
        elif current is not None:
            entries[current].append(line)
    fold = {k: v for k, v in entries.items() if "conv3x3_wgrad_sm90" in k and "ILb1E" in k}
    check(len(fold) == 2, f"ptxas: {len(fold)} fold instantiations of the Hopper bodies, not 2")
    for entry, lines in fold.items():
        text = "\n".join(lines)
        kind = "f32" if "f32" in entry else "bf16"
        regs = [ln.split("Used ")[1].split(" registers")[0] for ln in lines if "registers" in ln]
        # a C75xx warning names its function, wherever ptxas prints it
        serial = [ln for ln in log.splitlines() if "(C75" in ln and (entry in ln or ln in lines)]
        check("0 bytes spill stores, 0 bytes spill loads" in text and not serial,
              f"ptxas: the {kind} Hopper fold body spills or serializes its wgmmas:\n{text}"
              + "\n".join(serial))
        print(f"fold instantiation ({kind}): {regs[0] if regs else '?'} registers, "
              f"0 spill bytes, no C75xx")


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
    ragged += [dict(kernel=kernel, mode=mode, framing=flags, shape=shape, o=o)
               for shape, o in RAGGED_FRAMED for kernel, mode, flags in FRAMED_MODES]
    # kernels on no model path: the fold mode of the weight gradient at its
    # ragged shapes, unframed and in each framing, and the shift conv at
    # kernel 2's ragged shapes
    ragged += [dict(kernel="conv3x3_wgrad_fold", mode=mode, shape=shape, o=o)
               for shape, o in RAGGED_CONV for mode in ("fold", "fold+prologue")]
    ragged += [dict(kernel="conv3x3_wgrad_fold", mode=mode, framing=flags, shape=shape, o=o)
               for shape, o in RAGGED_FRAMED for mode, flags in FOLD_FRAMED]
    ragged += [dict(kernel="conv3x3_bias_act_shift", mode=mode, shape=shape, o=o)
               for shape, o in RAGGED_CONV for mode in ("relu", "conv")]
    # the shift conv at every conv3x3_bias_act call shape of the paths (once a
    # dtype), and bf16 x written as float32 at the ragged shapes
    shift = {}
    for call in unrouted_calls(calls):
        if call["kernel"] == "conv3x3_bias_act_shift":
            shift.setdefault((call["dtype"], call["shape"], call["o"]),
                             dict(call, count=1, layers=[call["layer"]]))
    shift_f32out = [dict(kernel="conv3x3_bias_act_shift", mode="conv+f32out", shape=shape, o=o,
                         path="ragged", layer="ragged", dtype="bf16") for shape, o in RAGGED_CONV]
    ragged += [dict(kernel="conv3x3_packed", mode=mode, framing=flags, shape=shape, o=o)
               for shape, o in PACKED_SM90_RAGGED for mode, flags in PACKED_SM90_MODES]
    errors = {}   # {(kernel, dtype): [max abs error, max sums rel error]}
    for call in (distinct(calls) + list(shift.values()) + shift_f32out
                 + [dict(c, path="ragged", layer="ragged", dtype=dtype)
                    for dtype in DTYPES for c in ragged]):
        case = Case(call, gen)
        before = dict(getattr(case.fn, "launches_by_path", {}))
        abs_err, rel = case.verify()
        body = ""
        if call["kernel"] in BODIES:
            # every launch of the check took the body the plan names
            body = case.body()
            taken = {k for k, v in case.fn.launches_by_path.items() if v != before.get(k, 0)}
            check(taken == {body}, f"{case.label()}: launched {taken}, the plan says {body}")
            if body == "sm90" and (call["dtype"] == "f32"
                                   or call["kernel"] == "conv3x3_bias_act_shift"):
                vs, limit = case.versus_legacy()
                check(vs <= limit, f"{case.label()}: {vs} (limit {limit}) off the synchronous body")
                body += f", vs synchronous {vs:.2e}"
            body = f" [{body}]"
        elif call["kernel"] == "conv3x3_wgrad_fold":
            body = f" [{case.fold_report}]"
        print(f"{case.label()}{body}: max abs {abs_err:.3e}, rel to |terms| {rel:.2e}")
        worst = errors.setdefault((call["kernel"], call["dtype"]), [0.0, 0.0])
        worst[0], worst[1] = max(worst[0], abs_err), max(worst[1], rel)
        del case
    for dtype in DTYPES:
        check_pool_ties(DTYPES[dtype])
    check_split_weights(calls)
    errors["probe_element_out", "f32"] = [check_element_out(), 0.0]
    errors.update(check_dh_fold())
    errors["probe_mosaic_ops", "f32"] = [check_mosaic_ops(), 0.0]
    torch.cuda.empty_cache()
    for (kernel, dtype), (abs_err, rel) in errors.items():
        print(f"worst {kernel} {dtype}: max abs {abs_err:.3e}, rel to |terms| {rel:.2e} "
              f"(limit {SUM_REL})")
    return errors


ELEMENT_OUT_SHAPES = [(2, H, W, 64), (1, 13, 21, 5), (1, 16, 24, 128)]


def check_split_weights(calls):
    """The float32 Hopper convs' weight split (the TF32 hi and lo planes they
    write before each call: conv3x3_bias_act's with the pitch C,
    conv3x3_packed's with C rounded up to whole 32-channel chunks, zero past
    C) on the card, bit for bit its plain version, at the weight shapes of
    the float32 steps' calls and ragged ones."""
    from hyperpri_tpu_torch.ops.kernels import _plain
    from hyperpri_tpu_torch.ops.kernels.conv3x3 import split_weights_tf32

    gen = torch.Generator(device="cuda").manual_seed(7)
    f32 = [c for c in calls if c["dtype"] == "f32"]
    shapes = sorted({(c["shape"][-1], c["o"], c["shape"][-1]) for c in f32
                     if c["kernel"] == "conv3x3_bias_act"} | {(5, 12, 5)}
                    | {(c["shape"][-1], c["o"], -(-c["shape"][-1] // 32) * 32) for c in f32
                       if c["kernel"] == "conv3x3_packed"} | {(61, 24, 64)})
    for c, o, pitch in shapes:
        w = torch.randn((3, 3, c, o), generator=gen, device="cuda")
        planes = split_weights_tf32(w, pitch)
        torch.cuda.synchronize()
        check(torch.equal(planes, _plain.split_weights_tf32_reference(w, pitch)),
              f"split_weights_tf32 {c}->{o}, pitch {pitch}: differs from the plain version")
    print(f"split_weights_tf32 at (C, O, pitch) {shapes}: exact")


def check_dh_fold():
    """Both dh-fold probe kernels at the probe's shapes (2x610x1032 buffers)
    on the body their plan names (the Hopper one, "sm90"), against their
    plain versions and against the synchronous body on the same inputs,
    each within one bf16 ulp; each kernel twice with identical bits; and the
    two kernels against each other (the TPU probe's max |cur - folded|)."""
    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold

    (cur, a_cur), (fold, a_fold) = probe_dh_fold.build(n=2, h=H, w=W, device="cuda")
    out_shape = (2, H // 8 * 8, -(-W // 64) * 64, 64)
    errors = {}
    outs = {}
    for name, fn, ref, args in (("current", cur, probe_dh_fold.current_reference, a_cur),
                                ("folded", fold, probe_dh_fold.folded_reference, a_fold)):
        body = probe_dh_fold.call_plan(*args).path
        before = dict(fn.launches_by_path)
        out = outs[name] = fn(*args)
        again = fn(*args)
        taken = {k: v - before.get(k, 0) for k, v in fn.launches_by_path.items()
                 if v != before.get(k, 0)}
        check(body == "sm90" and taken == {body: 2},
              f"dh-fold {name}: launched {taken}, the plan says {body}")
        legacy = fn(*args, _legacy=True)
        expect = ref(*args)
        torch.cuda.synchronize()
        check(tuple(out.shape) == out_shape, f"dh-fold {name}: {tuple(out.shape)}")
        check(torch.equal(out.view(torch.int16), again.view(torch.int16)),
              f"dh-fold {name}: two runs differ")
        ulps, abs_err = bf16_ulp_error(out, expect)
        check(ulps <= 1.0, f"dh-fold {name}: {ulps} bf16 ulp > 1")
        vs_ulps, vs_abs = bf16_ulp_error(out, legacy)
        check(vs_ulps <= 1.0, f"dh-fold {name}: {vs_ulps} bf16 ulp off the synchronous body")
        print(f"probe_dh_fold      {name:7s} {tuple(args[0].shape)} -> {tuple(out.shape)} "
              f"[{body}]: max abs {abs_err:.3e} ({ulps:.2f} bf16 ulp), vs synchronous "
              f"{vs_abs:.3e} ({vs_ulps:.2f} ulp), two runs bit-equal")
        errors[f"probe_dh_fold_{name}", "bf16"] = [abs_err, 0.0]
        del again, legacy, expect
    diff = (outs["current"].float() - outs["folded"].float()).abs().max().item()
    print(f"probe_dh_fold      max |cur - folded| = {diff:.3e}")
    return errors


def check_mosaic_ops() -> float:
    """The eight Mosaic-op probe kernels exactly (inf-aware) against their
    PyTorch ops."""
    from hyperpri_tpu_torch.ops.kernels import probe_mosaic_ops

    x = probe_mosaic_ops.probe_input("cuda")
    for name in probe_mosaic_ops.OPS:
        out = probe_mosaic_ops.run_case(name, x)
        torch.cuda.synchronize()
        check(torch.equal(out, probe_mosaic_ops.run_case_reference(name, x)),
              f"mosaic op {name}: differs from the PyTorch op")
        print(f"probe_mosaic_ops   {name:20s} OK (exact)")
    return 0.0


def check_element_out() -> float:
    """The arena-output probe exactly against its plain version (y = 2x is
    exact in float32), the frame included."""
    from hyperpri_tpu_torch.ops.kernels.probe_element_out import (
        element_out, element_out_reference)

    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape in ELEMENT_OUT_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        y = element_out(x)
        torch.cuda.synchronize()
        check(torch.equal(y, element_out_reference(x)), f"element_out {shape}: differs")
        print(f"probe_element_out  {shape} -> {tuple(y.shape)}: exact")
    return 0.0


def check_pool_ties(dtype):
    """max_pool_2x2_bwd exactly, ties included: a constant input, an input with
    duplicated maxima, and windows of -inf."""
    from hyperpri_tpu_torch.ops.kernels.pool_bwd import (
        max_pool_2x2_bwd, max_pool_2x2_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (2, 64, 96, 64)
    g = torch.randn((2, 32, 48, 64), generator=gen, device="cuda").to(dtype)
    dup = torch.randint(0, 2, shape, generator=gen, device="cuda").to(dtype)
    holes = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.7,
                        torch.full(shape, -float("inf"), device="cuda"),
                        torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    for name, x in (("constant", torch.full(shape, 1.5, device="cuda", dtype=dtype)),
                    ("duplicated maxima", dup), ("-inf windows", holes)):
        dx = max_pool_2x2_bwd(x, g)
        check(torch.equal(dx, max_pool_2x2_bwd_reference(x, g)), f"pool backward, {name}")
        routed = dx.float().reshape(2, 32, 2, 48, 2, 64).sum(dim=(2, 4))
        check(torch.equal(routed, g.float()), f"pool backward, {name}: not one element a window")
        if name == "constant":
            check(torch.equal(dx[:, ::2, ::2], g) and int((dx != 0).sum()) == int((g != 0).sum()),
                  "pool backward, constant input: not the first element")
        print(f"max_pool_2x2_bwd   {name} ({dtype}): exact")


def make_requests(gen, n_requests, batch, channels=D, dtype=torch.bfloat16):
    reqs = []
    for _ in range(n_requests):
        image = torch.randn((batch, H, W, channels), generator=gen, device="cuda").to(dtype)
        mask = (torch.rand((batch, H, W, 1), generator=gen, device="cuda") < 0.3).float()
        reqs.append({"image": image, "mask": mask,
                     "valid": torch.ones(batch, device="cuda")})
    return reqs


def kernel_wrappers():
    from hyperpri_tpu_torch.ops.kernels import training_kernels

    return training_kernels()


def unrouted_wrappers():
    """The wrappers of the kernels no model path launches, by name: the shift
    conv and the probes (the fold mode is counted by conv3x3_wgrad's
    launches_by_mode)."""
    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold, probe_mosaic_ops
    from hyperpri_tpu_torch.ops.kernels.conv3x3_shift import conv3x3_bias_act_shift
    from hyperpri_tpu_torch.ops.kernels.probe_element_out import element_out

    return {"conv3x3_bias_act_shift": conv3x3_bias_act_shift,
            "probe_dh_fold_current": probe_dh_fold.current,
            "probe_dh_fold_folded": probe_dh_fold.folded,
            "probe_mosaic_ops": probe_mosaic_ops.run_case, "probe_element_out": element_out}


def zero_launches():
    for fn in list(kernel_wrappers().values()) + list(unrouted_wrappers().values()):
        fn.launches = 0
        for counter in ("launches_by_dtype", "launches_by_framing", "launches_by_mode",
                        "launches_by_path"):
            if hasattr(fn, counter):
                getattr(fn, counter).clear()


def read_launches():
    """Launches since zero_launches() of every kernel: the training kernels,
    the fold mode and the kernels no model path routes to."""
    counts = {name: fn.launches for name, fn in kernel_wrappers().items()}
    counts["conv3x3_wgrad_fold"] = kernel_wrappers()["conv3x3_wgrad"].launches_by_mode.get(
        "fold", 0)
    counts.update({name: fn.launches for name, fn in unrouted_wrappers().items()})
    return counts


def read_framings():
    return {name: dict(fn.launches_by_framing) for name, fn in kernel_wrappers().items()
            if hasattr(fn, "launches_by_framing")}


def check_launches(label, calls, times):
    """The launches (and, for the framed kernels, the launches by framing)
    since zero_launches() against `times` passes of the predicted calls, all
    of them in the calls' dtype."""
    expected = count_by_kernel(calls)
    launches = read_launches()
    dtypes = {call["dtype"] for call in calls}
    for name, count in launches.items():
        check(count == times * expected.get(name, 0),
              f"{label}: {count} {name} launches, predicted {expected.get(name, 0)} a pass")
        if name in kernel_wrappers():
            by_dtype = {k: v for k, v in kernel_wrappers()[name].launches_by_dtype.items() if v}
            check(set(by_dtype) <= dtypes,
                  f"{label}: {name} launched in {by_dtype}, not {dtypes}")
    framings = read_framings()
    for name, by in count_by_framing(calls).items():
        want = {k: times * v for k, v in by.items()}
        check(framings.get(name, {}) == want,
              f"{label}: {name} launches by framing {framings.get(name)}, predicted {want}")
    # kernel bodies of the conv kernels, as their plans choose them for each call
    bodies = {}
    for name, want in count_by_body(calls).items():
        by_path = {k: v for k, v in kernel_wrappers()[name].launches_by_path.items() if v}
        want = {k: times * v for k, v in want.items()}
        check(by_path == want, f"{label}: {name} launches by body {by_path}, predicted {want}")
        bodies[name] = by_path
    print(f"{label}: launches {launches}, by framing {framings}, by body {bodies} = {times} x "
          f"the routing's prediction")
    return launches, framings


def phase_serving(calls):
    phase("(d) CubeNET-64 serving, 608x968x238 bf16, batch 1")
    from hyperpri_tpu_torch.ops.metrics import dice_from_stats
    from hyperpri_tpu_torch.serve import build_cubenet_server

    unfolded = build_cubenet_server(0, folded=False, dtype=torch.float32)
    server = build_cubenet_server(0, folded=True, use_kernels=True)
    plain = build_cubenet_server(0, folded=True, use_kernels=False)
    reqs = make_requests(torch.Generator(device="cuda").manual_seed(2), N_REQUESTS, 1)

    zero_launches()
    results = [server.serve(req) for req in reqs]
    torch.cuda.synchronize()
    launches, framings = check_launches(f"serving, {N_REQUESTS} requests", calls, N_REQUESTS)

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
    return launches, framings, model_ms


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


def step_record(model, logs):
    """Step 1 of a run: its loss, logits and gradients, kept off the model."""
    return {"loss": float(logs["loss_sum"] / logs["n"]), "logits": logs["logits"].float().clone(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}


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
            first = step_record(model, logs)
        print(f"step {i + 1}: loss {loss:.6f}  n {float(logs['n']):.0f}  "
              f"stats {[int(v) for v in logs['stats']]}")
    launches, framings = check_launches(f"training, {TRAIN_STEPS} steps", calls, TRAIN_STEPS)
    peak_on = torch.cuda.max_memory_allocated() / 2 ** 30
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
        records[label] = step_record(ref_model, logs)
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
    return launches, framings, step_ms, peak, step, order[0]


def phase_training_f32(model_name, calls, letter, full=True):
    """UNET on RGB (phase j), CubeNET-64 on HSI with the host pre-padded
    ingest (phase k) or UNET+ (phase r), three float32 steps through the
    float32 kernels. Without `full`, the step is timed with cuDNN's TF32 at
    torch's default only, and not profiled."""
    import functools

    from hyperpri_tpu_torch.data.pipeline import pre_pad_images
    from hyperpri_tpu_torch.train.step import (
        build_cubenet_trainer, build_unet_trainer, make_train_step)

    ingest = model_name == "CubeNET"
    channels = D if ingest else 3
    build = (build_cubenet_trainer if ingest else
             functools.partial(build_unet_trainer, use_attention=model_name == "UNET+"))
    phase(f"({letter}) {model_name} training, batch {TRAIN_BATCH}, {H}x{W}x{channels} float32, "
          f"Adam(1e-3)" + (", host pre-padded ingest" if ingest else ""))
    expected = count_by_kernel(calls)
    print(f"the routing predicts per step: {expected}, by framing {count_by_framing(calls)}")
    batches = make_requests(torch.Generator(device="cuda").manual_seed(9), 2, TRAIN_BATCH,
                            channels, torch.float32)
    batches[1]["valid"] = torch.tensor([1.0, 0.0], device="cuda")   # a padded entry
    order = [batches[0], batches[1], batches[0]][:TRAIN_STEPS]

    model, opt, _ = build(0, use_kernels=True, dtype=torch.float32)
    feed, ingest_hw = order, None
    if ingest:
        spec = model.ingest_spec(H, W)
        check(spec is not None, "CubeNET-64's first conv does not take the ingest at 608x968")
        ingest_hw = (H, W)
        padded = [dict(b, image=pre_pad_images(b["image"], spec)) for b in batches]
        feed = [padded[0], padded[1], padded[0]][:TRAIN_STEPS]
    step = make_train_step(model, opt, 0.5, return_logits=True, ingest_hw=ingest_hw)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, first = [], None
    for i, batch in enumerate(feed):
        logs = step(batch)
        torch.cuda.synchronize()
        loss = float(logs["loss_sum"] / logs["n"])
        check(loss == loss and abs(loss) != float("inf"), f"step {i + 1}: loss {loss}")
        check(bool(torch.isfinite(logs["logits"]).all()), f"step {i + 1}: non-finite logits")
        check(tuple(logs["logits"].shape) == (TRAIN_BATCH, H, W, 1), "logits shape")
        losses.append(loss)
        if i == 0:
            first = step_record(model, logs)
        print(f"step {i + 1}: loss {loss:.6f}  n {float(logs['n']):.0f}  "
              f"stats {[int(v) for v in logs['stats']]}")
    launches, framings = check_launches(f"{model_name} float32, {TRAIN_STEPS} steps", calls,
                                        TRAIN_STEPS)
    peak_on = torch.cuda.max_memory_allocated() / 2 ** 30
    check(losses[2] < losses[0], f"the loss did not fall on the repeated batch: {losses}")
    moved = [k for k, v in model.state_dict().items() if "running" in k
             and not torch.equal(v, before[k])]
    check(len(moved) == len(before), "some BatchNorm running statistics did not move")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "non-finite parameter")
    print(f"loss on the repeated batch: {losses[0]:.6f} -> {losses[2]:.6f}; all "
          f"{len(before)} running statistics moved; peak memory {peak_on:.3f} GiB")

    # Step 1 against the stock route (cuDNN + autograd) in float32 and float64
    # (TF32 off), same seeded weights, same batch of logical images.
    records = {"kernels": first}
    for label, dtype in (("stock_f32", torch.float32), ("stock_f64", torch.float64)):
        ref_model, _, ref_step = build(0, use_kernels=False, dtype=dtype, return_logits=True)
        zero_launches()
        logs = ref_step(order[0])
        check(sum(read_launches().values()) == 0, "the reference model launched a kernel")
        records[label] = step_record(ref_model, logs)
        del ref_model, ref_step, logs
        torch.cuda.empty_cache()
    errs = {}
    for run in ("kernels", "stock_f32"):
        e = errs[run] = step_errors(records[run], records["stock_f64"])
        print(f"step 1, {run} vs stock_f64: loss {records[run]['loss']:.9f} vs "
              f"{records['stock_f64']['loss']:.9f} (rel {e['loss']:.3e}), logits rel L2 "
              f"{e['logits']:.3e}, sign agreement {e['agree']:.6f}, gradients rel L2 "
              f"{e['grads']:.3e}, worst leaf {e['leaf']:.3e} ({e['leaf_name']})")
    ours, stock = errs["kernels"], errs["stock_f32"]
    for key in ("loss", "logits", "grads"):
        limit = F32_VS_STOCK * (max(stock[key], F32_LOSS_FLOOR) if key == "loss" else stock[key])
        check(ours[key] <= limit,
              f"step 1: the float32 kernel route is {ours[key]:.3e} from float64 in {key}, "
              f"over {F32_VS_STOCK} x the stock float32 route's {stock[key]:.3e}")
    print(f"step 1: the kernel route is {ours['loss'] / max(stock['loss'], F32_LOSS_FLOOR):.3f}x, "
          f"{ours['logits'] / stock['logits']:.3f}x and {ours['grads'] / stock['grads']:.3f}x as "
          f"far from float64 as the stock float32 route in loss, logits and gradients "
          f"(limit {F32_VS_STOCK}x)")
    del records, first
    torch.cuda.empty_cache()

    # Step time, kernels on and off in turns on one card: with cuDNN's TF32 as
    # torch sets it by default (the production setting for the convs off the
    # kernel route), then once each with TF32 off.
    off_model, _, off_step = build(0, use_kernels=False, dtype=torch.float32)
    off_feed = order[0]
    step_ms, peak = {}, {"kernels_on": peak_on}
    runs = (("kernels_off", off_step, off_feed, True), ("kernels_on", step, feed[0], True),
            ("kernels_on_again", step, feed[0], True),
            ("kernels_off_again", off_step, off_feed, True),
            ("kernels_on_tf32_off", step, feed[0], False),
            ("kernels_off_tf32_off", off_step, off_feed, False))[:6 if full else 4]
    for label, fn, batch, tf32 in runs:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.reset_peak_memory_stats()
        step_ms[label] = cuda_ms(lambda: fn(batch), reps=5)
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{model_name} float32 step {label} (cuDNN TF32 {'on' if tf32 else 'off'}): "
              f"{step_ms[label]:.3f} ms ({TRAIN_BATCH * 1e3 / step_ms[label]:.2f} images/s), "
              f"peak {peak[label]:.3f} GiB")
    profile = None
    if full:
        print(f"where the time goes: torch.profiler over one kernel-route {model_name} "
              "float32 step (cuDNN TF32 on)")
        torch.backends.cudnn.allow_tf32 = True
        profile = profile_step(step, feed[0])
    torch.backends.cudnn.allow_tf32 = False
    del off_model, off_step, model, opt, step, feed, batches, order
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_framing": framings, "step_ms": step_ms,
            "peak_gib": peak, "losses": losses, "profile": profile,
            "vs_f64": {k: {m: v for m, v in e.items() if m != "leaf_name"}
                       for k, e in errs.items()}}


def phase_times(calls, card):
    phase(f"(f) kernel times on {card}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for call in distinct(calls):
        case = Case(call, gen)
        ms = cuda_ms(case.run)
        plain_ms = cuda_ms(case.plain, reps=3, warmup=1)
        library_ms = cuda_ms(case.library) if case.library is not None else None
        library_tf32_ms = cuda_ms(case.library_tf32) if case.library_tf32 else None
        # float32 convs: the same library call with cudnn.benchmark on
        library_bench_ms = (cuda_ms(with_cudnn_benchmark(case.library))
                            if case.library_tf32 else None)
        bound_ms, bound_by = bound(case.flops, case.nbytes, case.peak)
        n, h, w, c = call["shape"]
        rows.append({"kernel": call["kernel"], "dtype": call["dtype"], "path": call["path"],
                     "mode": call["mode"], "framing": list(call.get("framing", ())),
                     "layers": call["layers"], "count": call["count"], "shape": [n, h, w, c],
                     "o": call["o"], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_tf32_ms": library_tf32_ms,
                     "library_benchmark_ms": library_bench_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "flops": case.flops, "bytes": case.nbytes})
        if (call["kernel"] in ("conv3x3_packed", "conv3x3_bias_act_shift", "conv3x3_wgrad_fold")
                or (call["kernel"] in ("conv3x3_bias_act", "conv3x3_wgrad")
                    and call["dtype"] == "f32")):
            # the body the plan chose, and the synchronous body on the same call
            rows[-1]["body"] = case.body()
            rows[-1]["legacy_ms"] = cuda_ms(lambda: case.fn(*case.args, _legacy=True,
                                                            **case.kwargs))
            print(f"  body {rows[-1]['body']}; the synchronous body on the same call: "
                  f"{rows[-1]['legacy_ms']:.4f} ms")
        if call["kernel"] == "conv3x3_bias_act_shift":
            # the halo kernel (kernel 2) on the same inputs in the same mode
            from hyperpri_tpu_torch.ops.kernels.conv3x3 import conv3x3_bias_act

            rows[-1]["halo_ms"] = cuda_ms(lambda: conv3x3_bias_act(
                *case.args, relu=case.kwargs["relu"]))
            print(f"  the halo kernel on the same inputs: {rows[-1]['halo_ms']:.4f} ms")
        rate = (f"{case.flops / ms / 1e9:6.1f} TFLOP/s" if call["kernel"] != "max_pool_2x2_bwd"
                else f"{case.nbytes / ms / 1e9:6.3f} TB/s")
        tf32 = (f", library with TF32 {library_tf32_ms:.4f} ms, with cudnn.benchmark "
                f"{library_bench_ms:.4f} ms" if library_tf32_ms is not None else "")
        library = f"{library_ms:.4f} ms" if library_ms is not None else "none (no one call)"
        print(f"{case.label()} x{call['count']} ({call['path']}): kernel {ms:.4f} ms ({rate}), "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, "
              f"library {library}{tf32}")
        del case
    rows.append(time_element_out())
    rows += time_dh_fold()
    rows.append(time_mosaic_ops())
    torch.cuda.empty_cache()
    return rows


def unrouted_calls(calls):
    """The calls of kernels on no model path, at the shapes of the step's
    calls they stand beside: the fold mode at every conv3x3_wgrad call, the
    shift conv at every conv3x3_bias_act call (all without ReLU there)."""
    out = []
    for call in calls:
        if call["kernel"] == "conv3x3_wgrad":
            mode = "fold+prologue" if call["mode"] == "prologue" else "fold"
            out.append(dict(call, kernel="conv3x3_wgrad_fold", mode=mode))
        elif call["kernel"] == "conv3x3_bias_act":
            out.append(dict(call, kernel="conv3x3_bias_act_shift",
                            mode="relu" if call["mode"] == "relu" else "conv", framing=()))
    return out


def time_dh_fold():
    """Both dh-fold probe kernels at the probe's shapes, one call each, on
    the Hopper body and on the synchronous one, beside one cuDNN call of the
    same function (probe_dh_fold.cudnn_conv: a VALID 3x3 conv of the 64 real
    lanes, cut to the output's 1024 columns); the Hopper kernel's and
    cuDNN's device time by the profiler beside their CUDA-event times (the
    wrapper's host path is in the latter). Bound: the function's operations
    (64 real input channels) and each kernel's own bytes."""
    from hyperpri_tpu_torch.ops.kernels import probe_dh_fold

    (cur, a_cur), (fold, a_fold) = probe_dh_fold.build(n=2, h=H, w=W, device="cuda")
    x64 = a_fold[0]
    n, hp, wp, _ = x64.shape
    ho, wo = hp - 2, wp - 8
    library = probe_dh_fold.cudnn_conv(x64, a_cur[1])
    y_lib, y_cur = library().permute(0, 2, 3, 1).float(), cur(*a_cur).float()
    check(float((y_lib - y_cur).norm() / y_cur.norm()) <= 1e-2,
          "dh-fold: cuDNN's conv is not the probe's function")
    flops = 2.0 * n * ho * wo * 64 * 9 * 64
    out_bytes = 2.0 * n * ho * wo * 64
    rows = []
    for name, fn, ref, args in (("current", cur, probe_dh_fold.current_reference, a_cur),
                                ("folded", fold, probe_dh_fold.folded_reference, a_fold)):
        body = probe_dh_fold.call_plan(*args).path
        ms = cuda_ms(lambda: fn(*args))
        legacy_ms = cuda_ms(lambda: fn(*args, _legacy=True))
        plain_ms = cuda_ms(lambda: ref(*args), reps=3, warmup=1)
        library_ms = cuda_ms(library)
        dev_ms, _ = device_ms(lambda: fn(*args))
        library_dev_ms, _ = device_ms(library)
        nbytes = sum(2.0 * t.numel() for t in args) + out_bytes
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"probe_dh_fold {name:7s} {tuple(args[0].shape)}: kernel [{body}] {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms, {flops / dev_ms / 1e9:.1f} TFLOP/s of the 64-lane "
              f"function), synchronous body {legacy_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.3f} ms, library (cuDNN VALID conv) "
              f"{library_ms:.4f} ms (device {library_dev_ms:.4f} ms)")
        rows.append({"kernel": f"probe_dh_fold_{name}", "dtype": "bf16", "path": "probe",
                     "mode": name, "framing": [], "library_tf32_ms": None, "layers": [],
                     "count": 1, "shape": list(args[0].shape), "o": 64, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "flops": flops, "bytes": nbytes, "body": body,
                     "legacy_ms": legacy_ms, "device_ms": dev_ms,
                     "library_device_ms": library_dev_ms})
    return rows


def device_ms(fn, reps: int = 20):
    """Device milliseconds a call of fn by torch.profiler (the sum of every
    CUDA kernel it launches, over reps calls after a warm-up, per call), and
    {kernel name: launches a call}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / reps / 1e3,
            {e.key: e.count / reps for e in kernels})


def time_mosaic_ops():
    """The eight Mosaic-op kernels, one call each, summed; their plain
    versions are the PyTorch ops themselves, so the library time is the
    plain time. Each op twice: the wrapper by CUDA events (at this size the
    host's launch path), and the device time by torch.profiler, the kernel's
    against the sum of the kernels the PyTorch op launches. Each moves
    8x16x128 float32 in and out (bytes)."""
    from hyperpri_tpu_torch.ops.kernels import probe_mosaic_ops

    x = probe_mosaic_ops.probe_input("cuda")
    ms = plain_ms = dev = plain_dev = 0.0
    per_op = {}
    for name in probe_mosaic_ops.OPS:
        kernel = lambda: probe_mosaic_ops.run_case(name, x)   # noqa: E731
        op = lambda: probe_mosaic_ops.run_case_reference(name, x)   # noqa: E731
        one = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(op)}
        one["device_ms"], names = device_ms(kernel)
        one["plain_device_ms"], plain_names = device_ms(op)
        check(one["device_ms"] > 0 and one["plain_device_ms"] > 0,
              f"mosaic op {name}: the profiler recorded no device time")
        per_op[name] = one
        ms += one["ms"]
        plain_ms += one["plain_ms"]
        dev += one["device_ms"]
        plain_dev += one["plain_device_ms"]
        verdict = "at or below" if one["device_ms"] <= one["plain_device_ms"] else "above"
        print(f"probe_mosaic_ops {name:20s} events: kernel {one['ms']:.4f} ms, PyTorch op "
              f"{one['plain_ms']:.4f} ms; device: kernel {one['device_ms'] * 1e3:.2f} us "
              f"{names}, PyTorch op {one['plain_device_ms'] * 1e3:.2f} us {plain_names} "
              f"({verdict} the PyTorch op's)")
    n_ops = len(probe_mosaic_ops.OPS)
    nbytes = n_ops * 8.0 * x.numel()
    bound_ms, bound_by = bound(n_ops * float(x.numel()), nbytes, PEAK_F32_FLOPS)
    print(f"probe_mosaic_ops {n_ops} ops on {tuple(x.shape)}: kernels {ms:.4f} ms in all "
          f"(device {dev * 1e3:.2f} us), bound {bound_ms:.6f} ms ({bound_by}), plain (the "
          f"PyTorch ops) {plain_ms:.4f} ms (device {plain_dev * 1e3:.2f} us)")
    return {"kernel": "probe_mosaic_ops", "dtype": "f32", "path": "probe", "mode": "8 ops",
            "framing": [], "library_tf32_ms": None, "layers": [], "count": 1,
            "shape": list(x.shape), "o": x.shape[-1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": n_ops * float(x.numel()), "bytes": nbytes, "device_ms": dev,
            "plain_device_ms": plain_dev, "library_device_ms": plain_dev, "per_op": per_op}


def phase_fold_ab(calls_by_dtype):
    """(l) The fold mode against today's route at each conv3x3_wgrad call of
    one step, in turns on one card (a, b, c, d, e, e, d, c, b, a):
      a) today's route: g_eff = fold_stats_cotangent(gy, gsum, gsumsq, y) in
         float32 rounded to the compute dtype, conv3x3_wgrad on it, db = its
         float32 sum;
      b) conv3x3_wgrad in fold mode: (dW, db) from the raw gy and y, on the
         body its plan takes (the Hopper body at every call of both steps);
      c) b plus the g_eff pass the adjoint conv still reads (none for the
         network's first conv, which has no adjoint);
      d) conv3x3_wgrad alone on the materialized g_eff (a's kernel), the
         yardstick of the fold mode's own cost;
      e) b on the synchronous body (`_legacy=True`).
    Also holds b's dW bit-equal to the non-fold kernel's on the same body on
    the materialized g_eff, e's to the synchronous non-fold kernel's, a's
    dW (the Hopper kernel's, bf16 and float32) and b's each within SUM_REL of
    a float64 evaluation (g_eff has a per-channel offset: one-signed terms,
    where float32 chains show), and b's db within SUM_REL of a's. The
    CubeNET-64 float32 step's calls hold every float32 weight-gradient shape
    of the UNET step too.
    Summed per step: ms of a, b, c, d and e."""
    phase("(l) the weight gradient's fold mode against today's route, per step")
    from hyperpri_tpu_torch.ops.kernels import _plain

    results = {}
    for dtype, calls in calls_by_dtype.items():
        gen = torch.Generator(device="cuda").manual_seed(10)
        sums = {"a": 0.0, "b": 0.0, "c": 0.0, "d": 0.0, "e": 0.0}
        for call in distinct([c for c in unrouted_calls(calls)
                              if c["kernel"] == "conv3x3_wgrad_fold"]):
            case = Case(call, gen)
            (x, gy, pa, pb), kw = case.args, case.kwargs
            lg = case.logical
            wgrad = case.fn
            first = "pre_padded" in call.get("framing", ())
            body = case.body()

            def today():
                g_eff = _plain.fold_stats_cotangent(gy, kw["gsum"], kw["gsumsq"], kw["y"],
                                                    case.dtype)
                dw = wgrad(x, g_eff, pa, pb, **case.materialized_kwargs)
                return dw, g_eff.float().sum(dim=(0, 1, 2))

            def fold():
                return case.run()

            g_mat = _plain.fold_stats_cotangent(gy, kw["gsum"], kw["gsumsq"], kw["y"], case.dtype)

            def kernel_only():
                return wgrad(x, g_mat, pa, pb, **case.materialized_kwargs)

            def fold_sync():
                return wgrad(*case.args, _legacy=True, **kw)

            def fold_and_adjoint_pass():
                out = case.run()
                if not first:
                    _plain.fold_stats_cotangent(gy, kw["gsum"], kw["gsumsq"], kw["y"],
                                                case.dtype)
                return out

            (dw_a, db_a), (dw_b, db_b), (dw_e, _) = today(), fold(), fold_sync()
            dw_body = wgrad(x, g_mat, pa, pb, _legacy=body == "legacy",
                            **case.materialized_kwargs)
            dw_sync = wgrad(x, g_mat, pa, pb, _legacy=True, **case.materialized_kwargs)
            torch.cuda.synchronize()
            check(torch.equal(dw_body, dw_b),
                  f"{case.label()}: fold dW differs from the non-fold kernel ({body}) on g_eff")
            check(torch.equal(dw_sync, dw_e), f"{case.label()}: the synchronous fold's dW "
                                              f"differs from the synchronous kernel on g_eff")
            g_log = _plain.fold_stats_cotangent(lg["gy"], lg["gsum"], lg["gsumsq"], lg["y"],
                                                case.dtype)
            z = _plain.prologue_act(lg["x"], lg["pa"], lg["pb"])
            exact, scale = wgrad_f64(z, g_log), wgrad_f64(z.abs(), g_log.abs())
            rels = {}
            for label, dw in (("today's route", dw_a), ("the fold mode", dw_b)):
                rel = rels[label] = sum_error(dw, exact, scale)
                check(rel <= SUM_REL, f"{case.label()}: dW of {label} off by {rel} of its "
                                      f"absolute terms (float64)")
            rel_a, rel_b = rels["today's route"], rels["the fold mode"]
            print(f"{case.label()}: dW off float64 by, of its absolute terms: today's route "
                  f"{rel_a:.3e}, the fold mode ({body} body) {rel_b:.3e}; limit "
                  f"{SUM_REL:.0e}")
            g_abs = g_log.float().abs().sum(dim=(0, 1, 2))
            check(sum_error(db_b, db_a, g_abs) <= SUM_REL, f"{case.label()}: fold db off")
            del g_log, z, exact, scale
            times = {"a": [], "b": [], "c": [], "d": [], "e": []}
            for key in ("a", "b", "c", "d", "e", "e", "d", "c", "b", "a"):
                fn = {"a": today, "b": fold, "c": fold_and_adjoint_pass, "d": kernel_only,
                      "e": fold_sync}[key]
                times[key].append(cuda_ms(fn))
            ms = {k: mean(v) for k, v in times.items()}
            for k in sums:
                sums[k] += ms[k] * call["count"]
            print(f"{case.label()} x{call['count']}: a (today) {ms['a']:.4f} ms, b (fold, "
                  f"{body}) {ms['b']:.4f} ms, c (fold + adjoint's g_eff) {ms['c']:.4f} ms"
                  + (" (no adjoint)" if first else "") + f", d (wgrad alone) {ms['d']:.4f} ms"
                  f", e (fold, synchronous body) {ms['e']:.4f} ms")
            del case, g_mat
        print(f"{dtype} step: a {sums['a']:.4f} ms, b {sums['b']:.4f} ms, c {sums['c']:.4f} ms, "
              f"d {sums['d']:.4f} ms, e {sums['e']:.4f} ms per step (a - c = "
              f"{sums['a'] - sums['c']:.4f} ms, b / d = {sums['b'] / sums['d']:.3f}, "
              f"e / b = {sums['e'] / sums['b']:.3f})")
        results[dtype] = sums
        torch.cuda.empty_cache()
    return results


def time_element_out():
    """The arena-output probe at a full-resolution 64-channel map, float32,
    beside one PyTorch op of the same function (torch.mul into the logical
    view of a zeroed arena). Bytes: x read once, the whole arena written
    once."""
    from hyperpri_tpu_torch.ops.kernels import framing
    from hyperpri_tpu_torch.ops.kernels.probe_element_out import (
        element_out, element_out_reference)

    shape = ELEMENT_OUT_SHAPES[0]
    n, h, w, c = shape
    x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")

    def library():
        y = x.new_zeros(framing.arena_shape(n, h, w, c))
        torch.mul(x, 2.0, out=y[:, 8:8 + h, 8:8 + w, :c])
        return y

    check(torch.equal(library(), element_out(x)), "element_out differs from its library op")
    ms = cuda_ms(lambda: element_out(x))
    plain_ms = cuda_ms(lambda: element_out_reference(x), reps=3, warmup=1)
    library_ms = cuda_ms(library)
    out_elems = 1
    for d in framing.arena_shape(n, h, w, c):
        out_elems *= d
    nbytes = 4.0 * (x.numel() + out_elems)
    bound_ms, bound_by = bound(x.numel(), nbytes, PEAK_F32_FLOPS)
    print(f"probe_element_out  {shape}: kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s), "
          f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, library "
          f"(torch.mul into a zeroed arena) {library_ms:.4f} ms")
    return {"kernel": "probe_element_out", "dtype": "f32", "path": "probe", "mode": "2x",
            "framing": ["arena_out"], "library_tf32_ms": None,
            "layers": [], "count": 1, "shape": list(shape), "o": shape[-1], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": float(x.numel()), "bytes": nbytes}


def phase_profile(step, batch):
    phase("(g) where the time goes: torch.profiler over one kernel-route training step")
    return profile_step(step, batch)


def profile_step(step, batch, warmup: bool = True):
    """torch.profiler over one training step (after a warm-up step unless the
    caller has warmed it up): the device's busy time against the step's wall
    time, the time of the matrix-product kernels (cuBLAS / CUTLASS by name),
    and the 20 kernels that took longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
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
        return None
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if any(k in e.key.lower() for k in GEMM_KERNEL_NAMES)) / 1e3
    print(f"device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall for the step "
          f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, profiler on); "
          f"{sum(e.count for e in kernels)} device kernels; matrix products {gemm_ms:.4f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {e.count:4d} calls  "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}%  {e.key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "gemm_ms": gemm_ms}


# ---------------------------------------------------------------------------
# (h) and (i): the product loop on a synthetic experiment tree.

LOOP_EPOCHS = 3
PARAMS_CUBENET64 = 31_178_881


def du_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def write_tree():
    """A synthetic experiment tree of 608x968 cubes with the real cubes' 299
    stored bands (the default 25:263 window, 238 bands): two boxes of two
    dates, so split 1 trains on 2 cubes (one batch-2 step an epoch) and
    validates on 2."""
    from hyperpri_tpu_torch.data.synthetic import make_experiment_tree

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tree_")
    t0 = time.perf_counter()
    make_experiment_tree(tmp, n_boxes=2, dates_per_box=2, size_hw=(H, W), bands=299, seed=0)
    print(f"synthetic tree: {du_bytes(tmp) / 2 ** 30:.3f} GiB on disk, written in "
          f"{time.perf_counter() - t0:.2f} s")
    return tmp


def mean(values):
    return sum(values) / max(len(values), 1)


# Each framed mode at the main path's shapes: (kernel, mode, framing, input
# shape, O). The ingest conv (pre_padded, forward and weight gradient) runs in
# the product loop; the arena modes are those of the JAX package's arena chain
# (first_conv -> inc2 and up4 in training, first_conv -> inc2 in serving),
# which the port's model does not wire (ops/kernels/conv_train.py says why).
FRAMED_MAIN = [
    ("conv3x3_packed", "stats", ("pre_padded",), (TRAIN_BATCH, H, W, D), 64),
    ("conv3x3_wgrad", "plain", ("pre_padded",), (TRAIN_BATCH, H, W, D), 64),
    ("conv3x3_packed", "stats", ("arena_out",), (TRAIN_BATCH, H, W, D), 64),
    ("conv3x3_packed", "stats+prologue", ("arena_in",), (TRAIN_BATCH, H, W, 64), 64),
    ("conv3x3_packed", "bwd_x", ("arena_in", "arena_out", "arena_g"), (TRAIN_BATCH, H, W, 64),
     64),
    ("conv3x3_wgrad", "prologue", ("arena_in", "arena_g"), (TRAIN_BATCH, H, W, 64), 64),
    ("conv3x3_packed", "adjoint", ("arena_g",), (TRAIN_BATCH, H, W, 64), 128),
    ("conv3x3_wgrad", "plain", ("arena_g",), (TRAIN_BATCH, H, W, 128), 64),
    ("conv3x3_packed", "relu", ("arena_out",), (1, H, W, D), 64),
    ("conv3x3_packed", "relu", ("arena_g",), (1, H, W, 64), 64),
]


def framing_times():
    """Each FRAMED_MAIN call against the same call unframed, on the same
    logical inputs, timed in turns in one run (framed, unframed, unframed,
    framed): the mean of each side's two medians, with the bound."""
    print("framed kernel modes at the main path's shapes against the same calls unframed:")
    rows = []
    for kernel, mode, flags, shape, o in FRAMED_MAIN:
        cases = {label: Case(dict(kernel=kernel, mode=mode, framing=f, shape=shape, o=o,
                                  layer="main"), torch.Generator(device="cuda").manual_seed(8))
                 for label, f in (("framed", flags), ("unframed", ()))}
        times = {"framed": [], "unframed": []}
        for label in ("framed", "unframed", "unframed", "framed"):
            times[label].append(cuda_ms(cases[label].run))
        ms = {label: mean(v) for label, v in times.items()}
        case = cases["framed"]
        bound_ms, bound_by = bound(case.flops, case.nbytes, case.peak)
        rows.append({"label": case.label(), "framed_ms": ms["framed"],
                     "unframed_ms": ms["unframed"], "framed_runs": times["framed"],
                     "unframed_runs": times["unframed"], "bound_ms": bound_ms,
                     "bound_by": bound_by})
        print(f"{case.label()}: framed {ms['framed']:.4f} ms, unframed {ms['unframed']:.4f} ms "
              f"({ms['framed'] / ms['unframed']:.3f}x), bound {bound_ms:.4f} ms ({bound_by})")
        del cases, case
    torch.cuda.empty_cache()
    return rows


def phase_product_loop(tree, calls, card):
    phase(f"(h) the product loop: train_net -> validate_net -> test_net, CubeNET-64, "
          f"batch {TRAIN_BATCH}, {H}x{W}x{D} bf16, on {card}")
    from hyperpri_tpu_torch.config import ExpHyperspectralPRI
    from hyperpri_tpu_torch.models.registry import count_params
    from hyperpri_tpu_torch.ops.metrics import best_threshold_from_pr
    from hyperpri_tpu_torch.train.evaluate import test_net, validate_net
    from hyperpri_tpu_torch.train.trainer import train_net

    def config(**kw):
        return ExpHyperspectralPRI(calling_path=tree, precision="bf16", device="cuda", **kw)

    cfg = config(profile_dir=os.path.join(tree, "profile"))
    saved = os.path.join(tree, "Saved_Models")
    # Bit-equal resume needs every kernel deterministic: the port's are, and
    # cuDNN (the convs off the kernel route) is asked to be.
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    zero_launches()
    t0 = time.perf_counter()
    trainer = train_net(cfg, max_epochs=LOOP_EPOCHS)
    fit_s = time.perf_counter() - t0
    fit = trainer.fit_result
    n_params = count_params(trainer.model)
    check(n_params == PARAMS_CUBENET64, f"CubeNET-64 has {n_params} parameters")
    steps = sum(h["steps"] for h in fit.history)
    check(steps == LOOP_EPOCHS, f"{steps} steps in {LOOP_EPOCHS} epochs of one batch")
    launches, framings = check_launches(f"product loop, {steps} steps", calls, steps)
    for name, count in (("conv3x3_packed", 9), ("conv3x3_bias_act", 12),
                        ("conv3x3_wgrad", 11)):
        by_path = kernel_wrappers()[name].launches_by_path
        check(by_path.get("sm90", 0) == count * steps and not by_path.get("legacy"),
              f"product loop: {name} by body {by_path}, not {count} Hopper launches a step")
    check(framings["conv3x3_packed"].get("pre_padded") == steps,
          f"the ingest conv launched {framings['conv3x3_packed'].get('pre_padded')} times in "
          f"{steps} steps")
    ckpts = sorted(os.listdir(os.path.join(cfg.save_path, "Checkpoints")))
    check("last.ckpt" in ckpts and any(c.startswith("epoch=") for c in ckpts)
          and os.listdir(os.path.join(cfg.save_path, "diceCheckpoints")),
          f"checkpoints written: {ckpts}")
    losses = [h["tr_loss"] for h in fit.history]
    check(all(v == v and abs(v) != float("inf") for v in losses), f"train losses {losses}")
    for h in fit.history:
        print(f"epoch {h['epoch']}: {h['epoch_time']:.3f} s ({h['train_time']:.3f} s of it "
              f"training, {h['steps'] / h['train_time']:.3f} steps/s), tr_loss "
              f"{h['tr_loss']:.6f}, val_loss {h['val_loss']:.6f}, val_dice {h['val_dice']:.6f}")
    print(f"fit: {fit_s:.2f} s for {LOOP_EPOCHS} epochs, {n_params} parameters, checkpoints "
          f"{ckpts}")
    prof = trainer.profile
    if prof is not None and prof["idle_share"] is not None:
        print(f"profiled epoch {prof['epoch']}: device busy {prof['busy_ms']:.2f} ms of "
              f"{prof['wall_ms']:.2f} ms wall, idle share {prof['idle_share']:.4f} "
              f"(profiler on)")
        for key, count, ms in prof["top"][:8]:
            print(f"  {ms:9.3f} ms  {count:4d} calls  {key[:90]}")
    else:
        print("the profiler recorded no device time for the profiled epoch")
    host = {split: {k: mean(v) for k, v in loader.timings.items()}
            for split, loader in trainer.loaders.items()}
    for split, t in host.items():
        print(f"host seconds per {split} batch: read {t['read']:.4f} (summed over samples), "
              f"cast {t['cast']:.4f}, pad/collate {t['pad']:.4f}, h2d {t['h2d']:.4f}")
    del trainer

    # Resume the 4th epoch from last.ckpt, then the same 4 epochs uninterrupted.
    resumed = train_net(config(), checkpoint=True, max_epochs=LOOP_EPOCHS + 1)
    resumed_loss = resumed.fit_result.history[-1]["tr_loss"]
    curve = validate_net(resumed.cfg.get_val_data(), resumed.cfg, trainer=resumed)
    check(len(curve[2]) == 500 and all(bool((c == c).all()) for c in curve),
          "validate_net: not a 500-threshold curve of numbers")
    thr = float(best_threshold_from_pr(*(torch.from_numpy(c) for c in curve))[0])
    results = test_net(resumed.cfg.get_test_data(), resumed.cfg, thr, trainer=resumed)
    check(all(v == v for k, v in results.items() if k != "conf_mat"), f"test_net {results}")
    del resumed
    shutil.move(saved, saved + "_resumed")
    fresh = train_net(config(), max_epochs=LOOP_EPOCHS + 1)
    fresh_loss = fresh.fit_result.history[-1]["tr_loss"]
    del fresh
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    print(f"epoch {LOOP_EPOCHS + 1} train loss: resumed {resumed_loss!r}, uninterrupted "
          f"{fresh_loss!r} (held bit-equal)")
    check(resumed_loss == fresh_loss, "the resumed epoch differs from the uninterrupted one")
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_framing": framings, "fit_s": fit_s,
            "history": fit.history, "profile": {k: v for k, v in (prof or {}).items()
                                                if k != "top"},
            "host_s_per_batch": host, "resume_loss": [resumed_loss, fresh_loss],
            "test": {k: v for k, v in results.items() if k != "conf_mat"},
            "framed_vs_unframed": framing_times()}


# ---------------------------------------------------------------------------
# (s) the mesh path on one card.

MESH_EPOCHS = 3
MESH_TIMED_STEPS = 3
# The spatial conv's shards at the two kernel routes of the training step:
# (input shape, O): kernel 1 (conv3x3_packed) and kernel 2 (conv3x3_bias_act).
SHARD_CONVS = [((TRAIN_BATCH, H, W, 64), 64), ((TRAIN_BATCH, H // 2, W // 2, 64), 128)]
SHARD_DEGREES = (2, 4)


def _mesh_fit(tree, calls, deepspeed: bool):
    """train_net(model_parallel=True) on phase h's tree, from a fresh run
    directory: -> (trainer, launches, peak GiB, ms a staged step)."""
    from hyperpri_tpu_torch.config import ExpHyperspectralPRI
    from hyperpri_tpu_torch.train.step import make_train_step
    from hyperpri_tpu_torch.train.trainer import train_net

    shutil.rmtree(os.path.join(tree, "Saved_Models"), ignore_errors=True)
    cfg = ExpHyperspectralPRI(calling_path=tree, device="cuda")
    cfg.test_deepspeed = deepspeed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    trainer = train_net(cfg, model_parallel=True, max_epochs=MESH_EPOCHS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = sum(h["steps"] for h in trainer.fit_result.history)
    check(steps == MESH_EPOCHS, f"{steps} steps in {MESH_EPOCHS} epochs of one batch")
    label = f"mesh path{' with test_deepspeed' if deepspeed else ''}, {steps} steps"
    launches, _ = check_launches(label, calls, steps)
    check(cfg.precision == "bf16" and cfg.zero_shard_opt and cfg.offload_opt_state == deepspeed
          and cfg.mesh_shape == {"data": 1, "spatial": 1} and trainer.mesh.shape == cfg.mesh_shape,
          f"model_parallel set {cfg.precision}, {cfg.zero_shard_opt}, {cfg.offload_opt_state}, "
          f"{cfg.mesh_shape}")
    params = [p.detach().clone() for p in trainer.model.parameters()]
    # the step alone, on one batch staged on the card (the fit's epochs wait for
    # the loader's read)
    loader = trainer.loaders["train"]
    pad_spec, ingest_hw = trainer._ingest_setup(loader.probe())
    batch = {k: v for k, v in next(iter(loader.batches(pad_spec))).items() if k != "names"}
    step = make_train_step(trainer.model, trainer.optimizer, cfg.threshold, ingest_hw=ingest_hw,
                           mesh=trainer.mesh)
    step(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(MESH_TIMED_STEPS):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return trainer, params, launches, peak, statistics.median(times), times


def _shard_blocks(x, s):
    """The s row blocks of x, each extended by the rows the halo exchange
    delivers (the neighbours' boundary rows, zero at the map's edges)."""
    h = x.shape[1] // s
    zero = torch.zeros_like(x[:, :1])
    return [torch.cat([x[:, j * h - 1:j * h] if j else zero, x[:, j * h:(j + 1) * h],
                       x[:, (j + 1) * h:(j + 1) * h + 1] if j < s - 1 else zero], dim=1)
            for j in range(s)]


def _shard_check(shape, o, dtype_name, gen):
    """One conv's shards against the unsharded kernel conv: forward bits, dX
    in bf16 ulps (float32: over the sum of |terms|), dW over the sum of
    |terms|, at each degree of SHARD_DEGREES."""
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad
    from hyperpri_tpu_torch.parallel.spatial_conv import local_conv

    dtype = DTYPES[dtype_name]
    x, w, b = conv_inputs(shape, o, gen, dtype)
    g = (torch.randn(shape[:3] + (o,), generator=gen, device="cuda") * 0.1).to(dtype)

    def conv(xin, gin):
        xin = xin.detach().requires_grad_()
        y = local_conv(xin, w, b, True)
        return y, xin, gin

    y_ref, x_ref, _ = conv(x, g)
    y_ref.backward(g)
    dx_ref, dw_ref = x_ref.grad.float(), conv3x3_wgrad(x, g)
    xt, gt = x.float().permute(0, 3, 1, 2).abs(), g.float().permute(0, 3, 1, 2).abs()
    wt = w.float().permute(3, 2, 0, 1).abs()
    dx_scale = torch.nn.grad.conv2d_input(xt.shape, wt, gt, padding=1).permute(0, 2, 3, 1)
    dw_scale = torch.nn.grad.conv2d_weight(xt, wt.shape, gt, padding=1).permute(2, 3, 1, 0)
    out = {}
    for s in SHARD_DEGREES:
        h = shape[1] // s
        ys, dxs, dws = [], torch.zeros_like(dx_ref), torch.zeros_like(dw_ref)
        mag, parts = torch.zeros_like(dx_ref), torch.zeros(shape[1], device="cuda")
        for j, (xe, ge) in enumerate(zip(_shard_blocks(x, s), _shard_blocks(g, s))):
            ge[:, 0].zero_()    # the cotangent of the halo output rows: sliced off
            ge[:, -1].zero_()
            y, xin, _ = conv(xe, ge)
            ys.append(y[:, 1:-1])
            y.backward(ge)
            # the exchange's transpose: each halo row's dX lands on the
            # neighbour's boundary row (summed in float32 here)
            lo, hi = j * h - 1, (j + 1) * h + 1
            part = xin.grad.float()
            keep = slice(max(lo, 0) - lo, part.shape[1] - max(hi - shape[1], 0))
            dxs[:, max(lo, 0):min(hi, shape[1])] += part[:, keep]
            mag[:, max(lo, 0):min(hi, shape[1])] += part[:, keep].abs()
            parts[max(lo, 0):min(hi, shape[1])] += 1
            dws += conv3x3_wgrad(xe, ge)
        y_sh = torch.cat(ys, dim=1)
        fwd_equal = torch.equal(y_sh, y_ref)
        if dtype_name == "bf16":
            # in ulps of max(|dX|, |dX ref|, |a| + |b|, 2**-6); a row that sums
            # two shards' bf16 partials a and b carries their two roundings
            # beside the reference's one: up to 1.5 ulps
            m = torch.maximum(torch.maximum(dxs.abs(), dx_ref.abs()), mag).clamp_min(ULP_FLOOR)
            ulps = (dxs - dx_ref).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)
            two = parts > 1
            dx_err = ulps[:, ~two].max().item()
            dx_err_two = ulps[:, two].max().item()
            dx_limit, dx_limit_two = 1.0, 1.5
        else:
            dx_err, dx_limit = sum_error(dxs, dx_ref, dx_scale), SUM_REL
            dx_err_two, dx_limit_two = dx_err, dx_limit
        dw_err = sum_error(dws, dw_ref, dw_scale)
        check(fwd_equal, f"spatial {s}, {shape}->{o} {dtype_name}: the shards' forward differs "
                         f"from the unsharded conv by {(y_sh.float() - y_ref.float()).abs().max()}")
        check(dx_err <= dx_limit and dx_err_two <= dx_limit_two and dw_err <= SUM_REL,
              f"spatial {s}, {shape}->{o} {dtype_name}: dX {dx_err:.3e} (limit {dx_limit}), "
              f"on the summed rows {dx_err_two:.3e} (limit {dx_limit_two}), dW {dw_err:.3e} "
              f"(limit {SUM_REL})")
        out[s] = {"forward_bit_equal": fwd_equal, "dx_err": dx_err, "dx_limit": dx_limit,
                  "dx_err_summed_rows": dx_err_two, "dx_limit_summed_rows": dx_limit_two,
                  "dw_err": dw_err}
        unit = " ulp" if dtype_name == "bf16" else " of |terms|"
        print(f"spatial {s}: {s} shards of {shape[0]}x{h}(+2)x{shape[2]}x{shape[3]} -> {o} "
              f"{dtype_name}: forward bit-equal {fwd_equal}, dX {dx_err:.3e} (limit "
              f"{dx_limit}{unit}), on the rows that sum two shards {dx_err_two:.3e} (limit "
              f"{dx_limit_two}{unit}), dW {dw_err:.3e} of |terms| (limit {SUM_REL})")
    return out


def phase_mesh(tree, calls, card):
    phase(f"(s) the mesh path on {card}: train_net(model_parallel=True) at a world of one "
          f"(NCCL), CubeNET-64, batch {TRAIN_BATCH}, {H}x{W}x{D} bf16, without and with "
          f"test_deepspeed; the spatial conv's shards")
    import torch.distributed as dist

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for deepspeed in (False, True):
            trainer, params, launches, peak, ms, times = _mesh_fit(tree, calls, deepspeed)
            opt = trainer.optimizer
            check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                  f"the mesh runs {dist.get_backend()} at a world of {dist.get_world_size()}")
            state_device = {t.device.type for *_, t in opt._state_tensors()}
            check(state_device == ({"cpu"} if deepspeed else {"cuda"}),
                  f"test_deepspeed {deepspeed}: the Adam moments live on {state_device}")
            runs[deepspeed] = {"params": params, "launches": launches, "peak_gib": peak,
                               "ms_per_step": ms, "step_ms_runs": times,
                               "moment_bytes": opt.state_bytes(),
                               "history": trainer.fit_result.history}
            print(f"test_deepspeed {deepspeed}: {ms:.2f} ms a staged step (runs {times}), "
                  f"device peak {peak:.3f} GiB over the fit, Adam moments "
                  f"{opt.state_bytes() / 1e9:.4f} GB on {state_device.pop()}, epochs "
                  f"{[round(h['epoch_time'], 3) for h in trainer.fit_result.history]} s")
            del trainer, opt
            torch.cuda.empty_cache()
        equal = all(torch.equal(a, b) for a, b in zip(runs[False]["params"],
                                                      runs[True]["params"]))
        check(equal, "the offloaded fit's parameters differ from the fit without offload")
        check(runs[False]["launches"] == runs[True]["launches"],
              "the two fits launched different kernels")
        moments = 2 * PARAMS_CUBENET64 * 4
        saving = runs[False]["peak_gib"] - runs[True]["peak_gib"]
        print(f"parameters after {MESH_EPOCHS} steps bit-equal with and without offload; the "
              f"offload saves {saving:.3f} GiB of device peak against the moments' "
              f"{moments / 2 ** 30:.3f} GiB (2 x {PARAMS_CUBENET64} x 4 B)")
        for r in runs.values():
            del r["params"]
    finally:
        shutil.rmtree(os.path.join(tree, "Saved_Models"), ignore_errors=True)
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()
    gen = torch.Generator(device="cuda").manual_seed(11)
    shards = {f"{dt}_{shape[1]}x{shape[2]}_{shape[3]}to{o}": _shard_check(shape, o, dt, gen)
              for shape, o in SHARD_CONVS for dt in DTYPES}
    torch.cuda.empty_cache()
    return {"without_offload": runs[False], "with_offload": runs[True],
            "offload_saving_gib": saving, "moments_gib": moments / 2 ** 30,
            "launches": runs[False]["launches"], "shards": shards}


def phase_cli(tree):
    phase("(i) the CLI: kfold_train --validate --dataset RGB, then with no flag")
    shutil.rmtree(os.path.join(tree, "Saved_Models"), ignore_errors=True)
    shutil.rmtree(os.path.join(tree, "Saved_Models_resumed"), ignore_errors=True)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    seconds, routes, launches = {}, {}, {}
    for flags, model in [(["--dataset", "RGB"], "UNET"), ([], "CubeNET_64")]:
        cmd = [sys.executable, "-m", "hyperpri_tpu_torch.cli", "kfold_train", "--calling-path",
               tree, "--num-splits", "1", "--max-epochs", "1", "--validate"] + flags
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                              timeout=600)
        seconds[model] = time.perf_counter() - t0
        lines = [ln.strip() for ln in proc.stdout.splitlines()]
        print(f"kfold_train {' '.join(flags)} ... exit {proc.returncode} in "
              f"{seconds[model]:.2f} s")
        print("\n".join(ln for ln in lines if "Model:" in ln or "route:" in ln
                        or "kernel launches" in ln or "epoch" in ln or "Threshold" in ln
                        or "DICE" in ln))
        check(proc.returncode == 0,
              f"the CLI failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        trained = [ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("Model:")]
        check(trained == [model], f"kfold_train {flags} trained {trained}, not {model}")
        check(sum("Best Threshold" in ln for ln in lines) == 1, f"{model} was not validated")
        routes[model] = [ln for ln in lines if ln.startswith("route:")]
        check(len(routes[model]) == 1
              and "fp32: gated 3x3 convs on the CUDA kernels" in routes[model][0],
              f"{model}: routes {routes[model]}")
        launch_lines = [ln for ln in lines if "kernel launches in this fit" in ln]
        check(len(launch_lines) == 1, f"{model}: kernel launch lines {launch_lines}")
        counts = {}
        for item in launch_lines[0].split(":", 1)[1].split(","):
            parts = item.split()
            if len(parts) == 3:
                counts[f"{parts[0]} {parts[1]}"] = int(parts[2])
        launches[model] = counts
        for kernel in kernel_wrappers():
            check(counts.get(f"{kernel} f32", 0) > 0 and counts.get(f"{kernel} bf16", 0) == 0,
                  f"{model}: float32 launches {counts}")
    return {"seconds": seconds, "route": routes, "launches": launches}


# ---------------------------------------------------------------------------
# (m), (n), (o): SpectralUNET (Dense layers on torch.matmul, no kernel of
# ops/kernels on its path), chunked training and eval, and the CLI's last
# command.

SPECTRAL_FEATS = 1650
PARAMS_SPECTRAL = 30_388_051
SPECTRAL_CHUNK_COUNTS = (8, 16)   # the smallest that fits the card is timed
SPECTRAL_PER_IMAGE_CHUNKS = TRAIN_BATCH
# One warm-up: the second plain step is already the steady one (2458.0
# against a median of 2457.5 ms in bf16 on an H100 machine).
SPECTRAL_WARMUP, SPECTRAL_TIMED = 1, 3
# Offloaded runs take this many steps and are held against the plain run's
# state after as many; the last is timed. Two: the second step reuses the
# pinned host blocks that the first allocated (18.9-26.5 s against the
# first's 26.2-38.8 s on an H100 machine).
OFFLOAD_STEPS = 2
SPECTRAL_EVAL_CHUNKS = (65536, 262144)
SPECTRAL_EVAL_SMALL = (152, 242)    # chunked against unchunked, float32
CHUNKED_EVAL_REL_L2 = 1e-6
# The fold itself, in float32, changes the logits by round-off only.
FOLD_F32_REL_L2 = 1e-5
# Host memory kept free beside the offloaded residuals, and the headroom of
# the pinned allocator's block sizes over the bytes it holds.
HOST_MARGIN_BYTES = 8 * 2 ** 30
PINNED_HEADROOM = 1.25


# Substrings of the matrix-product kernels' names (cuBLAS, CUTLASS).
GEMM_KERNEL_NAMES = ("gemm", "xmma", "nvjet", "cutlass")


def spectral_macs_per_pixel(depth: int = D, feats: int = SPECTRAL_FEATS) -> int:
    """Multiply-adds a pixel of one SpectralUNET forward: the tail, down1-4
    and up1 (feats wide in), up2-4 (2 feats in), the head (2 feats -> 1)."""
    return depth * feats + 5 * feats * feats + 3 * 2 * feats * feats + 2 * feats


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def empty_host_cache():
    """Hand the pinned host blocks the offloaded steps cached back to the
    system, so that the next run's estimate reads MemAvailable truly."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    check(empty is not None, "this torch cannot empty its pinned host cache")
    empty()


def pinned_host_peak_gib():
    """The pinned host allocator's peak since its last reset, or None where
    this torch does not report it."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    peak = stats().get("allocated_bytes.peak") if stats is not None else None
    return None if peak is None else peak / 2 ** 30


def offload_bytes_per_pixel(dtype) -> float:
    """Bytes a pixel of the tensors a SpectralUNET training forward saves for
    its backward, counted as save_on_cpu copies them (one copy a save),
    measured at full width on 4096 pixels."""
    from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET
    from hyperpri_tpu_torch.serve import masked_bce

    px = 4096
    model = SpectralUNET(D, 1, SPECTRAL_FEATS, dtype=dtype).cuda()
    x = torch.randn((1, px, 1, D), device="cuda")
    saved = []

    def pack(t):
        if t.dim() >= 1 and t.shape[0] == px:
            saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = model(x, train=True)
        masked_bce(y, torch.zeros_like(y), torch.ones(1, device="cuda"))
    del model, x, y
    return sum(saved) / px


def spectral_batch():
    """A pre-staged batch of the synthetic tree's kind (data/synthetic.py):
    root-like masks, each pixel the root or the soil spectrum plus noise, so
    that a per-pixel model has something to learn (on an H100, random masks
    at 1.18 M pixels: Adam's first steps raised the bf16 loss from 0.757 to
    0.909)."""
    import numpy as np

    from hyperpri_tpu_torch.data.synthetic import draw_roots, root_spectrum, soil_spectrum

    rng = np.random.default_rng(6)
    masks = np.stack([draw_roots(H, W, rng) for _ in range(TRAIN_BATCH)])[..., None]
    mask = torch.from_numpy(masks).cuda()
    root = torch.from_numpy(root_spectrum(D)).float().cuda()
    soil = torch.from_numpy(soil_spectrum(D)).float().cuda()
    noise = torch.randn((TRAIN_BATCH, H, W, D), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
    image = (torch.where(mask, root, soil) + 0.02 * noise).clamp(0, 1)
    return {"image": image, "mask": mask.float(), "valid": torch.ones(TRAIN_BATCH, device="cuda")}


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def spectral_run(dtype, n_chunks, offload, batch, label, steps, warmup, snapshot_at,
                 profile=False):
    """SpectralUNET-1650 from seed 0, `steps` chunked steps on one
    pre-staged batch: -> (record with the losses, the median step time after
    `warmup` steps, peak memory and the launches, and with `profile` a
    profiled step after them; the model's state after step `snapshot_at`)."""
    from hyperpri_tpu_torch.train.step import build_spectral_unet_trainer

    model, _, step = build_spectral_unet_trainer(0, device="cuda", dtype=dtype,
                                                 n_chunks=n_chunks, offload=offload)
    before = running_stats(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset = getattr(torch.cuda, "reset_peak_host_memory_stats", None)
    if reset is not None:
        reset()
    zero_launches()
    losses, times, state = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        logs = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["loss_sum"] / logs["n"]))
        if i + 1 == snapshot_at:
            state = {k: v.clone() for k, v in model.state_dict().items()}
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pinned = pinned_host_peak_gib()
    ms = statistics.median(times[warmup:])
    flops = 3 * 2 * spectral_macs_per_pixel() * batch["image"][..., 0].numel()
    after = running_stats(model)
    moved = sum(not torch.equal(after[k], before[k]) for k in before)
    profiled = None
    if profile:
        print(f"{label}: {n_chunks} chunks, a step under torch.profiler:")
        profiled = profile_step(step, batch, warmup=False)
    record = {"n_chunks": n_chunks, "offload": offload, "ms_per_step": ms,
              "step_ms": times, "peak_gib": peak, "pinned_host_peak_gib": pinned,
              "tflops": flops / (ms * 1e-3) / 1e12,
              "losses": losses, "running_stats_moved": moved, "profile": profiled,
              "running_stats": len(before), "launches": launches}
    print(f"{label}: {n_chunks} chunks{' offloaded' if offload else ''}: "
          f"{ms:.3f} ms/step (median of {steps - warmup} after {warmup} warm-ups; "
          f"steps {[round(t, 3) for t in times]}), peak {peak:.3f} GiB"
          f"{f' (pinned host {pinned} GiB)' if offload else ''}, "
          f"{record['tflops']:.2f} TFLOP/s on the model FLOPs, losses {losses}")
    del model, step, logs
    torch.cuda.empty_cache()
    return record, state


def phase_spectral_training(card):
    phase(f"(m) SpectralUNET-{SPECTRAL_FEATS} training, batch {TRAIN_BATCH}, {H}x{W}x{D}, "
          f"Adam(1e-3), chunked, on {card}")
    batch = spectral_batch()
    out = {}
    for name, dtype in DTYPES.items():
        label = f"SpectralUNET {name}"
        plain = state = None
        for n_chunks in SPECTRAL_CHUNK_COUNTS:
            try:
                plain, state = spectral_run(dtype, n_chunks, False, batch, label,
                                            SPECTRAL_WARMUP + SPECTRAL_TIMED, SPECTRAL_WARMUP,
                                            OFFLOAD_STEPS, profile=True)
                break
            except torch.cuda.OutOfMemoryError:
                print(f"{label}: {n_chunks} chunks do not fit the card")
                torch.cuda.empty_cache()
        check(plain is not None, f"{label} fits the card at none of {SPECTRAL_CHUNK_COUNTS}")
        k = plain["n_chunks"]
        losses = plain["losses"]
        check(all(v == v and abs(v) != float("inf") for v in losses), f"{label}: {losses}")
        check(losses[2] < losses[0], f"{label}: the loss did not fall over 3 steps: {losses}")
        check(plain["running_stats_moved"] == plain["running_stats"] == 18,
              f"{label}: {plain['running_stats_moved']} of the 9 BatchNorms' 18 running "
              "statistics moved")
        check(not any(plain["launches"].values()),
              f"{label}: kernels launched on the SpectralUNET path: {plain['launches']}")
        per_px = offload_bytes_per_pixel(dtype)
        need = per_px * batch["image"][..., 0].numel() / k * PINNED_HEADROOM + HOST_MARGIN_BYTES
        avail = mem_available_bytes()
        print(f"{label}: offload copies {per_px:.0f} bytes a pixel; {k} chunks need "
              f"{need / 2 ** 30:.2f} GiB of host memory with the margin, MemAvailable "
              f"{avail / 2 ** 30:.2f} GiB")
        check(avail >= need, f"{label}: not enough host memory to offload at {k} chunks")
        off, off_state = spectral_run(dtype, k, True, batch, label, OFFLOAD_STEPS,
                                      OFFLOAD_STEPS - 1, OFFLOAD_STEPS)
        same = off["losses"] == losses[:OFFLOAD_STEPS] and all(
            torch.equal(off_state[key], state[key]) for key in state)
        print(f"{label}: offload at {k} chunks bit-equal to the plain step (losses, "
              f"parameters, running statistics after {OFFLOAD_STEPS} steps): {same}")
        check(same, f"{label}: the offloaded step differs from the plain step")
        check(not any(off["launches"].values()), f"{label}: kernels launched with offload")
        del state, off_state
        empty_host_cache()
        # the per-image count, the reference's own semantics, with offload
        need2 = (per_px * batch["image"][..., 0].numel() / SPECTRAL_PER_IMAGE_CHUNKS
                 * PINNED_HEADROOM + HOST_MARGIN_BYTES)
        avail = mem_available_bytes()
        if avail >= need2:
            per_image, _ = spectral_run(dtype, SPECTRAL_PER_IMAGE_CHUNKS, True, batch, label,
                                        OFFLOAD_STEPS, OFFLOAD_STEPS - 1, OFFLOAD_STEPS)
            empty_host_cache()
        else:
            per_image = {"skipped": True, "need_gib": need2 / 2 ** 30,
                         "mem_available_gib": avail / 2 ** 30}
            print(f"{label}: SKIPPED the offloaded run at {SPECTRAL_PER_IMAGE_CHUNKS} chunks: "
                  f"it needs {need2 / 2 ** 30:.2f} GiB of host memory with the margin, "
                  f"MemAvailable is {avail / 2 ** 30:.2f} GiB")
        out[name] = {"plain": plain, "offload": off, "offload_bit_equal": same,
                     "offload_bytes_per_pixel": per_px, "per_image_offload": per_image}
    del batch
    torch.cuda.empty_cache()
    return out


def random_spectral_unet(seed: int):
    """Unfolded float32 SpectralUNET-1650 on the card with flax's init drawn
    from `seed`, then seeded BatchNorm affines and running statistics, so
    that folding them is not close to the identity (as serve.random_cubenet)."""
    from hyperpri_tpu_torch.models.parts import TorchBatchNorm
    from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET

    g = torch.Generator().manual_seed(seed)
    model = SpectralUNET(D, 1, SPECTRAL_FEATS, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.empty(n).uniform_(0.8, 1.2, generator=g))
                m.bias.copy_(torch.empty(n).normal_(0.0, 0.1, generator=g))
                m.running_mean.copy_(torch.empty(n).normal_(0.0, 0.2, generator=g))
                m.running_var.copy_(torch.empty(n).uniform_(0.5, 2.0, generator=g))
    return model.cuda()


def logit_errors(out, ref):
    return (float((out - ref).norm() / ref.norm()),
            float(((out > 0) == (ref > 0)).float().mean()))


def phase_spectral_eval(card):
    phase(f"(n) SpectralUNET-{SPECTRAL_FEATS} eval, 1x{H}x{W}x{D}, through "
          f"apply_pixelwise_chunked, on {card}")
    import copy

    from hyperpri_tpu_torch.models.spectral_unet import SpectralUNET
    from hyperpri_tpu_torch.ops.chunked import apply_pixelwise_chunked
    from hyperpri_tpu_torch.ops.fold_bn import fold_batch_norm

    model = random_spectral_unet(0)
    folded = {}
    for name, dtype in DTYPES.items():
        folded[name] = SpectralUNET(D, 1, SPECTRAL_FEATS, fused_bn=True, dtype=dtype).cuda()
        folded[name].load_state_dict(fold_batch_norm(model.state_dict()))
    unfolded_bf16 = copy.deepcopy(model)
    for m in unfolded_bf16.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.bfloat16
    cube = torch.randn((1, H, W, D), generator=torch.Generator(device="cuda").manual_seed(8),
                       device="cuda")
    zero_launches()
    small = cube[:, :SPECTRAL_EVAL_SMALL[0], :SPECTRAL_EVAL_SMALL[1]]
    with torch.no_grad():
        whole = model(small)
    chunked = apply_pixelwise_chunked(model, small, chunk=8192)
    chunked_rel = logit_errors(chunked, whole)[0]
    print(f"chunked (8192-pixel chunks) against unchunked eval at 1x{SPECTRAL_EVAL_SMALL[0]}x"
          f"{SPECTRAL_EVAL_SMALL[1]}, float32: rel L2 {chunked_rel:.3e} (limit "
          f"{CHUNKED_EVAL_REL_L2})")
    check(chunked_rel <= CHUNKED_EVAL_REL_L2, "chunked eval differs from the unchunked eval")

    runs, logits = {}, {}
    for chunk in SPECTRAL_EVAL_CHUNKS:
        for label, mdl in (("f32_unfolded", model), ("bf16_folded", folded["bf16"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_ms(lambda: apply_pixelwise_chunked(mdl, cube, chunk), reps=3, warmup=1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            runs[label, chunk] = {"ms_per_cube": ms, "peak_gib_above_inputs": peak}
            print(f"eval {label}, chunk {chunk}: {ms:.3f} ms/cube, peak {peak:.3f} GiB above "
                  f"the model and the cube")
    for label, mdl in (("f32_unfolded", model), ("f32_folded", folded["f32"]),
                       ("bf16_folded", folded["bf16"]), ("bf16_unfolded", unfolded_bf16)):
        logits[label] = apply_pixelwise_chunked(mdl, cube, SPECTRAL_EVAL_CHUNKS[0])
        check(tuple(logits[label].shape) == (1, H, W, 1)
              and logits[label].dtype == torch.float32
              and bool(torch.isfinite(logits[label]).all()), f"{label}: logits")
    check(not any(read_launches().values()), "kernels launched on the SpectralUNET eval path")
    ref = logits["f32_unfolded"]
    errs = {label: logit_errors(logits[label], ref)
            for label in ("f32_folded", "bf16_folded", "bf16_unfolded")}
    for label, (rel, agree) in errs.items():
        print(f"{label} vs f32_unfolded: rel L2 {rel:.3e}, sign agreement {agree:.6f}")
    rel, agree = errs["f32_folded"]
    check(rel <= FOLD_F32_REL_L2 and agree >= MODEL_SIGN_AGREE,
          f"the float32 fold: rel L2 {rel}, agreement {agree}")
    rel, agree = errs["bf16_folded"]
    flips, stock_flips = 1.0 - agree, 1.0 - errs["bf16_unfolded"][1]
    check(rel <= MODEL_REL_L2 and flips <= TRAIN_VS_STOCK * stock_flips,
          f"the bf16 fold: rel L2 {rel} (limit {MODEL_REL_L2}), {flips:.3e} of the signs "
          f"flipped against {stock_flips:.3e} for the unfolded model in bf16 "
          f"(limit {TRAIN_VS_STOCK}x)")
    del model, folded, unfolded_bf16, cube, logits
    torch.cuda.empty_cache()
    return {"chunked_vs_unchunked_rel_l2": chunked_rel,
            "runs": {f"{label}_chunk{chunk}": r for (label, chunk), r in runs.items()},
            "vs_f32_unfolded": {k: {"rel_l2": v[0], "sign_agreement": v[1]}
                                for k, v in errs.items()}}


def phase_spectral_cli(tree, n_chunks):
    phase(f"(o) the CLI: kfold_train --model SpectralUNET --chunks {n_chunks}, kfold_validate, "
          "kfold_segmaps")
    from hyperpri_tpu_torch import cli
    from hyperpri_tpu_torch.data.png import load_png

    common = ["--calling-path", tree, "--num-splits", "1", "--device", "cuda"]
    seconds = {}

    def run(name, argv):
        t0 = time.perf_counter()
        result = getattr(cli, name)(argv + common)
        seconds[name] = time.perf_counter() - t0
        print(f"{name} {' '.join(argv)}: {seconds[name]:.2f} s")
        return result

    zero_launches()
    run("kfold_train", ["--model", "SpectralUNET", "--chunks", str(n_chunks), "--max-epochs",
                        "1", "--validate"])
    launches = read_launches()
    check(not any(launches.values()), f"kernels launched by the SpectralUNET fit: {launches}")
    run("kfold_validate", [])
    val_json = os.path.join(tree, "Datasets", "HyperPRI", "data_splits", "val1.json")
    results = run("kfold_segmaps", ["--test-json", val_json])
    check(set(m for _, m in results) == set(cli.KFOLD_MODELS), f"tested {list(results)}")
    tests = {}
    for (split, model), res in results.items():
        check(all(v == v for k, v in res.items() if k != "conf_mat"), f"{model}: {res}")
        tests[model] = {k: (v.tolist() if k == "conf_mat" else v) for k, v in res.items()}
        print(f"test_net split {split} {model}: {tests[model]}")
    pngs = sorted(os.path.join(d, f) for d, _, files in os.walk(os.path.join(tree, "Saved_Models"))
                  for f in files if f.endswith("_seg.png"))
    for path in pngs:
        shape = load_png(path, "RGB").shape
        check(shape == (H, W, 3), f"{path}: {shape}")
    n_test = len(read_json_entries(val_json))
    print(f"{len(pngs)} segmentation maps written ({n_test} test images x "
          f"{len(cli.KFOLD_MODELS)} models), each {H}x{W}x3 as read back")
    check(len(pngs) == n_test * len(cli.KFOLD_MODELS), f"segmentation maps {pngs}")
    return {"seconds": seconds, "test_net": tests, "segmaps": len(pngs),
            "launches_spectral_fit": launches}


# ---------------------------------------------------------------------------
# (p), (q), (r): the host data path, checkpoint import from the reference's
# formats, and UNET's options.

READ_REPS = 3
SERVE_REPS = 50
HOST_EPOCHS = 3   # epoch 2 is profiled (the idle share), epoch 3 is not


def split_entries(tree, split):
    return read_json_entries(os.path.join(tree, "Datasets", "HyperPRI", "data_splits",
                                          f"{split}1.json"))


def bits(t):
    """A tensor's or array's bytes, for bit-equality."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return t.tobytes()


def phase_host_data(tree, card):
    phase(f"(p) the host data path on phase h's tree: {H}x{W} cubes of 299 bands, window "
          f"25:263, on {card}")
    import numpy as np

    from hyperpri_tpu_torch.config import ExpHyperspectralPRI
    from hyperpri_tpu_torch.data import disk_cache, envi, native_io
    from hyperpri_tpu_torch.train.trainer import train_net

    t0 = time.perf_counter()
    lib = native_io.build()
    print(f"native reader {lib} ready in {time.perf_counter() - t0:.2f} s (g++ "
          f"{' '.join(native_io.CXX_FLAGS)})")
    lo, hi = 25, 263
    batch = split_entries(tree, "train")   # the one train batch: two cubes
    check(len(batch) == TRAIN_BATCH, f"train split of {len(batch)} cubes")
    cache = os.path.join(tree, "decoded_cache")
    for e in batch:
        ref = envi.read_cube(e.hdr, e.dat, lo, hi, use_native=False)
        native = envi.read_cube(e.hdr, e.dat, lo, hi)
        check(native.dtype == np.float32 and bits(native) == bits(ref),
              f"{e.name}: native float32 read differs from the numpy read")
        native16 = envi.read_cube(e.hdr, e.dat, lo, hi, dtype=torch.bfloat16)
        check(bits(native16) == bits(torch.from_numpy(ref).to(torch.bfloat16)),
              f"{e.name}: native bf16 bits differ from the float32 read cast by torch")
        for dtype, want in ((torch.float32, native), (torch.bfloat16, native16)):
            disk_cache.read_cube_cached(e.hdr, e.dat, lo, hi, dtype, cache_dir=cache)
            back = disk_cache.read_cube_cached(e.hdr, e.dat, lo, hi, dtype, cache_dir=cache)
            check(bits(back) == bits(want), f"{e.name}: {dtype} cache entry read back differs")
    print(f"reads of the {len(batch)} train cubes: native float32 byte-equal to numpy, native "
          "bf16 bit-equal to torch's cast, cache entries read back equal")
    shutil.rmtree(cache)

    def seconds(read):
        runs = []
        for _ in range(READ_REPS):
            t = time.perf_counter()
            for e in batch:
                read(e)
            runs.append(time.perf_counter() - t)
        return statistics.median(runs), runs

    cold = os.path.join(tree, "cold_cache")

    def cached_cold(e):
        if e is batch[0]:   # each timed run starts from an empty cache
            shutil.rmtree(cold, ignore_errors=True)
        disk_cache.read_cube_cached(e.hdr, e.dat, lo, hi, torch.bfloat16, cache_dir=cold)

    readers = {
        "numpy_f32": lambda e: envi.read_cube(e.hdr, e.dat, lo, hi, use_native=False),
        "native_f32": lambda e: envi.read_cube(e.hdr, e.dat, lo, hi),
        "native_bf16": lambda e: envi.read_cube(e.hdr, e.dat, lo, hi, dtype=torch.bfloat16),
        "cache_cold_bf16": cached_cold,
        "cache_warm_bf16": lambda e: disk_cache.read_cube_cached(
            e.hdr, e.dat, lo, hi, torch.bfloat16, cache_dir=cold),
    }
    read_s = {}
    for name, read in readers.items():
        read_s[name], runs = seconds(read)
        print(f"read one batch ({len(batch)} cubes) {name}: {read_s[name]:.4f} s (median of "
              f"{READ_REPS}: {[round(r, 4) for r in runs]}; source files in the page cache)")
    shutil.rmtree(cold)

    # train_net bf16 without and with a warm decoded-cube cache
    warm = os.path.join(tree, "decoded_cache")
    for e in batch + split_entries(tree, "val"):
        disk_cache.read_cube_cached(e.hdr, e.dat, lo, hi, torch.bfloat16, cache_dir=warm)
    loops = {}
    for label, cache_dir in (("native_reader", None), ("decoded_cache_warm", warm)):
        shutil.rmtree(os.path.join(tree, "Saved_Models"), ignore_errors=True)
        cfg = ExpHyperspectralPRI(calling_path=tree, precision="bf16", device="cuda",
                                  decoded_cache_dir=cache_dir,
                                  profile_dir=os.path.join(tree, "profile_p"))
        trainer = train_net(cfg, max_epochs=HOST_EPOCHS, progress=False)
        hist = trainer.fit_result.history
        prof = trainer.profile or {}
        host = {split: {k: mean(v) for k, v in loader.timings.items()}
                for split, loader in trainer.loaders.items()}
        loops[label] = {"epoch_s": [h["epoch_time"] for h in hist],
                        "train_s": [h["train_time"] for h in hist],
                        "steps_per_s": hist[-1]["steps"] / hist[-1]["train_time"],
                        "idle_share": prof.get("idle_share"), "host_s_per_batch": host}
        print(f"train_net bf16, {label}: epochs {[round(h['epoch_time'], 3) for h in hist]} s, "
              f"epoch {HOST_EPOCHS} {loops[label]['steps_per_s']:.3f} steps/s; profiled epoch "
              f"{prof.get('epoch')}: idle share {prof.get('idle_share')}")
        for split, t in host.items():
            print(f"  host seconds per {split} batch: read {t['read']:.4f}, cast {t['cast']:.4f}, "
                  f"pad {t['pad']:.4f}, h2d {t['h2d']:.4f}")
        # the host cast of a batch's two float32 cubes to bf16 took 0.231 s on
        # an H100 machine; what is left is the mask's binarization
        check(host["train"]["cast"] < 0.05, f"{label}: the bf16 cubes were cast on the host")
        del trainer
    shutil.rmtree(warm)
    shutil.rmtree(os.path.join(tree, "Saved_Models"), ignore_errors=True)
    torch.cuda.empty_cache()
    return {"read_s_per_batch": read_s, "train_net_bf16": loops}


def _bf16_running_stats(model, seed):
    """Seeded BatchNorm running statistics of bf16 values: a bf16-mixed
    DeepSpeed run keeps them so, and its ZeRO-2 module copies carry them in
    bf16 (the other formats hold them in float32)."""
    from hyperpri_tpu_torch.models.parts import TorchBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=g).bfloat16().float())
                m.running_var.copy_((torch.rand(n, generator=g) + 0.5).bfloat16().float())
    return model


def write_zero2_dir(ckpt_dir, sd, world=2):
    """A DeepSpeed ZeRO-2 checkpoint directory as DeepSpeed lays it out:
    'latest', the module states with bf16 copies of every float tensor and
    the parameters' shapes in two optimizer groups, and each rank's float32
    master shard of each group (the flattened group padded to a multiple of
    the world size)."""
    root = os.path.join(ckpt_dir, "global_step1")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write("global_step1")
    params = [(k, v) for k, v in sd.items() if "running_" not in k and "num_batches" not in k]
    groups = [params[g::2] for g in range(2)]
    shards = [[] for _ in range(world)]
    for items in groups:
        flat = torch.cat([v.flatten().float() for _, v in items])
        flat = torch.cat([flat, torch.zeros((-len(flat)) % world)])
        for r, part in enumerate(flat.chunk(world)):
            shards[r].append(part.clone())
    torch.save({"module": {k: v.bfloat16() if v.is_floating_point() else v
                           for k, v in sd.items()},
                "param_shapes": [{k: v.shape for k, v in items} for items in groups]},
               os.path.join(root, "mp_rank_00_model_states.pt"))
    for r in range(world):
        torch.save({"optimizer_state_dict": {"single_partition_of_fp32_groups": shards[r]}},
                   os.path.join(root, f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))


def write_reference_checkpoint(fmt, save_path, sd):
    """One of the reference's three formats under a run's save path, where
    find_eval_checkpoint looks: a Lightning .ckpt or a ZeRO-2 directory in
    Checkpoints/, or best_wts.pt beside it."""
    shutil.rmtree(save_path, ignore_errors=True)
    name = os.path.join(save_path, "Checkpoints", "epoch=7-val_loss=0.250-val_dice=0.800.ckpt")
    os.makedirs(os.path.dirname(name))
    wrapped = {f"_forward_module.m_network.{k}": v for k, v in sd.items()}
    if fmt == "lightning":
        torch.save({"pytorch-lightning_version": "2.0.7", "epoch": 7, "global_step": 14,
                    "hyper_parameters": {"learn_rate": 1e-3}, "state_dict": wrapped}, name)
    elif fmt == "best_wts":
        os.rmdir(os.path.dirname(name))
        torch.save({f"module.{k}": v for k, v in sd.items()},
                   os.path.join(save_path, "best_wts.pt"))
    else:
        write_zero2_dir(name, wrapped)


def phase_checkpoint_import(tree):
    phase(f"(q) checkpoint import: UNET and CubeNET-64 at full width written as a Lightning "
          f".ckpt, a raw best_wts.pt and a two-rank ZeRO-2 directory, loaded by "
          f"evaluate._load_eval_state, logits on one {H}x{W} image")
    from hyperpri_tpu_torch import cli
    from hyperpri_tpu_torch.config import ExpHyperspectralPRI, ExpRedGreenBluePRI
    from hyperpri_tpu_torch.train.checkpoint import detect_checkpoint_format, find_eval_checkpoint
    from hyperpri_tpu_torch.train.evaluate import _load_eval_state
    from hyperpri_tpu_torch.train.torch_export import export_state_dict
    from hyperpri_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.deterministic = True
    calling = os.path.join(tree, "import")
    out = {}
    for cls, channels in ((ExpRedGreenBluePRI, 3), (ExpHyperspectralPRI, D)):
        cfg = cls(calling_path=calling, device="cuda")
        source = _bf16_running_stats(cfg.get_network(seed=11), 12).cuda().eval()
        sd = export_state_dict(source, cfg.model_name, cfg)
        x = torch.randn((1, H, W, channels), generator=torch.Generator().manual_seed(13)).cuda()
        with torch.no_grad():
            want = source(x)
        for fmt in ("lightning", "best_wts", "zero2"):
            t0 = time.perf_counter()
            write_reference_checkpoint(fmt, cfg.save_path, sd)
            found = find_eval_checkpoint(cfg.save_path)
            trainer = Trainer(cfg)
            _load_eval_state(trainer, cfg)
            with torch.no_grad():
                got = trainer.model.eval()(x)
            same = torch.equal(got, want)
            out[f"{cfg.model_name} {fmt}"] = {
                "format": detect_checkpoint_format(found), "bit_equal": same,
                "max_abs_diff": float((got - want).abs().max()),
                "seconds": time.perf_counter() - t0}
            print(f"{cfg.model_name} from {fmt} ({os.path.basename(found)}, "
                  f"{out[f'{cfg.model_name} {fmt}']['format']}): logits bit-equal {same}, "
                  f"max |diff| {out[f'{cfg.model_name} {fmt}']['max_abs_diff']:.3e}, "
                  f"{out[f'{cfg.model_name} {fmt}']['seconds']:.2f} s")
            check(same, f"{cfg.model_name} from {fmt}: logits differ from the source model's")
            del trainer
        del source
        torch.cuda.empty_cache()
    shutil.rmtree(calling)
    torch.backends.cudnn.deterministic = False

    # kfold_validate on phase h's tree, CubeNET-64 reading a ZeRO-2 directory
    cfg = ExpHyperspectralPRI(calling_path=tree, device="cuda")
    source = _bf16_running_stats(cfg.get_network(seed=14), 15)
    write_reference_checkpoint("zero2", cfg.save_path, export_state_dict(source, "CubeNET", cfg))
    t0 = time.perf_counter()
    cli.kfold_validate(["--calling-path", tree, "--models", "CubeNET", "--num-splits", "1",
                        "--device", "cuda"])
    out["kfold_validate_zero2_s"] = time.perf_counter() - t0
    csv_path = os.path.join(tree, "Saved_Models", "HSI", "CubeNET_pr.csv")
    check(os.path.exists(csv_path) and os.path.exists(os.path.join(cfg.save_path,
                                                                   "pr_curve.csv")),
          "kfold_validate wrote no curve for the ZeRO-2 checkpoint")
    print(f"kfold_validate --models CubeNET on the ZeRO-2 directory: "
          f"{out['kfold_validate_zero2_s']:.2f} s, {csv_path}")
    shutil.rmtree(os.path.join(tree, "Saved_Models"), ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def phase_unet_options(card):
    phase(f"(r) UNET's options on {card}: folded bf16 serving of 1x{H}x{W}x3, UNET+ float32 "
          "training, analyze")
    from hyperpri_tpu_torch.models.unet import UNet
    from hyperpri_tpu_torch.serve import build_unet_server

    calls = serving_calls("UNET")
    check(count_by_kernel(calls) == {"conv3x3_packed": 3},
          f"the routing sends {count_by_kernel(calls)} of UNET's serving convs to kernels")
    print(f"the routing predicts per image: {[c['layer'] for c in calls]} on conv3x3_packed")
    unfolded = build_unet_server(0, folded=False, dtype=torch.float32)
    server = build_unet_server(0, folded=True, use_kernels=True)
    plain = build_unet_server(0, folded=True, use_kernels=False)
    reqs = make_requests(torch.Generator(device="cuda").manual_seed(16), N_REQUESTS, 1, 3)
    # each kernel layer's output against a float32 conv of its own input
    # (bf16-rounded weights, float32 bias, ReLU), captured on the first request
    captured = {}

    def capture(name):
        def hook(mod, inp, out):   # returns None: the output is kept
            captured.setdefault(name, (mod, inp[0], out))
        return hook

    hooks = [server.model.get_submodule(c["layer"]).register_forward_hook(capture(c["layer"]))
             for c in calls]
    zero_launches()
    results = [server.serve(req) for req in reqs]
    torch.cuda.synchronize()
    launches, _ = check_launches(f"UNET serving, {N_REQUESTS} requests", calls, N_REQUESTS)
    for h in hooks:
        h.remove()
    layer_ulps = {}
    for name, (mod, inp, out) in captured.items():
        ref = F.relu(F.conv2d(inp.float().permute(0, 3, 1, 2),
                              mod.weight.to(torch.bfloat16).float(), padding=1)
                     .permute(0, 2, 3, 1) + mod.bias.float())
        layer_ulps[name] = bf16_ulp_error(out, ref)[0]
        check(layer_ulps[name] <= 1.0,
              f"UNET serving {name}: {layer_ulps[name]:.3f} bf16 ulps from a float32 conv")
    print(f"UNET serving's kernel layers against a float32 conv of their inputs, bf16 ulps: "
          f"{ {k: round(v, 3) for k, v in layer_ulps.items()} } (limit 1)")
    del captured
    # The random UNET's logits crowd zero, and the folded model on F.conv2d
    # in bf16 agrees in sign with the unfolded float32 model on only 0.9973
    # of the pixels on an H100, so phase d's sign-agreement limit would fail
    # the reference itself. As in phase n: rel L2 within phase d's limit
    # against both, and the kernel route's sign flips against float32 at
    # most TRAIN_VS_STOCK times the F.conv2d model's.
    worst = {"plain": [0.0, 1.0], "unfolded": [0.0, 1.0], "plain_vs_unfolded": [0.0, 1.0]}
    for i, (req, res) in enumerate(zip(reqs, results)):
        logits = res["logits"]
        check(tuple(logits.shape) == (1, H, W, 1) and bool(torch.isfinite(logits).all()),
              f"UNET request {i}: logits {tuple(logits.shape)}")
        refs = {name: other.serve(req)["logits"] for name, other in (("plain", plain),
                                                                    ("unfolded", unfolded))}
        errs = {"plain": logit_errors(logits, refs["plain"]),
                "unfolded": logit_errors(logits, refs["unfolded"]),
                "plain_vs_unfolded": logit_errors(refs["plain"], refs["unfolded"])}
        flips, plain_flips = 1.0 - errs["unfolded"][1], 1.0 - errs["plain_vs_unfolded"][1]
        check(errs["plain"][0] <= MODEL_REL_L2 and errs["unfolded"][0] <= MODEL_REL_L2
              and flips <= TRAIN_VS_STOCK * plain_flips,
              f"UNET request {i}: {errs}; {flips:.3e} of the signs flipped against float32, "
              f"{plain_flips:.3e} for the model on F.conv2d (limit {TRAIN_VS_STOCK}x)")
        for name, (rel, agree) in errs.items():
            worst[name] = [max(worst[name][0], rel), min(worst[name][1], agree)]
    for name, (rel, agree) in worst.items():
        print(f"UNET serving, worst {name if '_vs_' in name else 'kernels vs ' + name}: rel L2 "
              f"{rel:.4e}, sign agreement {agree:.6f}")

    def forward(srv):
        images = itertools.cycle([req["image"] for req in reqs])
        return lambda: srv.model(next(images))

    # In turns, SERVE_REPS forwards each: events, the host's time to issue a
    # forward, and the profiler's device time (the sum of its kernels).
    serving_ms, serving_runs = {}, {}
    with torch.inference_mode():
        for label, srv in (("kernels_off", plain), ("kernels_on", server),
                           ("kernels_on_again", server), ("kernels_off_again", plain)):
            ev, host = cuda_times(forward(srv), SERVE_REPS)
            serving_ms[label] = statistics.median(ev)
            serving_runs[label] = {"event_ms": ev, "host_ms": host}
            q = statistics.quantiles(ev, n=10)
            print(f"UNET serving forward {label}: {serving_ms[label]:.4f} ms/image (median of "
                  f"{SERVE_REPS}; min {min(ev):.4f}, p10 {q[0]:.4f}, p90 {q[-1]:.4f}, max "
                  f"{max(ev):.4f}), {1e3 / serving_ms[label]:.3f} images/s; host issue "
                  f"median {statistics.median(host):.4f} ms, max {max(host):.4f}")
        serving_device = {}
        for label, srv in (("kernels_off", plain), ("kernels_on", server)):
            dev, kernels = device_ms(forward(srv))
            packed = sum(n for k, n in kernels.items() if "conv3x3_packed" in k)
            serving_device[label] = {"device_ms": dev, "device_kernels": sum(kernels.values()),
                                     "conv3x3_packed_kernels": packed}
            print(f"UNET serving forward {label}: device {dev:.4f} ms/image (torch.profiler, "
                  f"20 forwards), {sum(kernels.values()):.0f} device kernels an image "
                  f"({packed:.0f} conv3x3_packed)")
    del unfolded, server, plain, results
    torch.cuda.empty_cache()

    plus = phase_training_f32("UNET+", training_calls("UNET+", dtype="f32",
                                                      path="unet_plus_training"), "r", False)

    model = UNet(3, 1, bilinear=False, analyze=True,
                 generator=torch.Generator().manual_seed(17)).cuda().eval()
    x = torch.randn((1, 64, 96, 3), device="cuda")
    torch.backends.cudnn.deterministic = True
    with torch.no_grad():
        triple = model(x)
        model.analyze = False
        logits = model(x)
    torch.backends.cudnn.deterministic = False
    check(len(triple) == 3 and torch.equal(triple[0], logits) and triple[1] is triple[0]
          and torch.equal(triple[2], torch.sigmoid(logits)),
          "analyze does not return (logits, logits, sigmoid(logits))")
    print("analyze: (logits, logits, sigmoid(logits)) on the card")
    del model
    torch.cuda.empty_cache()
    return {"serving_launches": launches, "serving_ms_per_image": serving_ms,
            "serving_runs": serving_runs, "serving_device": serving_device,
            "serving_worst": worst, "serving_layer_ulps": layer_ulps, "unet_plus_f32": plus}


def read_json_entries(path):
    """The images of a split JSON, as the port's split reader resolves them."""
    from hyperpri_tpu_torch.data.splits import parse_split_json

    root = os.path.dirname(os.path.dirname(path))
    return parse_split_json(path, root, mode="hsi").entries


REPLACES = {
    "conv3x3_packed": ("hyperpri_tpu_torch/csrc/conv3x3_packed.cu",
                       "hyperpri_tpu/ops/pallas/conv3x3_packed.py:308"),
    "conv3x3_bias_act": ("hyperpri_tpu_torch/csrc/conv3x3.cu",
                         "hyperpri_tpu/ops/pallas/conv3x3.py:125"),
    "conv3x3_wgrad": ("hyperpri_tpu_torch/csrc/conv3x3_grad.cu",
                      "hyperpri_tpu/ops/pallas/conv3x3_grad.py:184"),
    "max_pool_2x2_bwd": ("hyperpri_tpu_torch/csrc/pool_bwd.cu",
                         "hyperpri_tpu/ops/pallas/pool_bwd.py:82"),
    "probe_element_out": ("hyperpri_tpu_torch/csrc/probe_element_out.cu",
                          "scripts/probe_element_out.py:29"),
    "conv3x3_wgrad_fold": ("hyperpri_tpu_torch/csrc/conv3x3_grad.cu",
                           "hyperpri_tpu/ops/pallas/conv3x3_grad.py:184"),
    "conv3x3_bias_act_shift": ("hyperpri_tpu_torch/csrc/conv3x3_shift.cu",
                               "hyperpri_tpu/ops/pallas/conv3x3_shift.py:53"),
    "probe_dh_fold_current": ("hyperpri_tpu_torch/csrc/probe_dh_fold.cu",
                              "scripts/probe_dh_fold.py:44"),
    "probe_dh_fold_folded": ("hyperpri_tpu_torch/csrc/probe_dh_fold.cu",
                             "scripts/probe_dh_fold.py:61"),
    "probe_mosaic_ops": ("hyperpri_tpu_torch/csrc/probe_mosaic_ops.cu",
                         "scripts/probe_mosaic_ops.py:24"),
}


def summed_bound(rows):
    """(bound_ms, bound_by) of a set of calls: the sum of each call's bound
    times its count (every call takes at least its own bound, whether bytes
    or operations bound it), by what bounds the larger share of that sum."""
    parts = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        parts[r["bound_by"]] += r["bound_ms"] * r["count"]
    return sum(parts.values()), max(parts, key=parts.get)


def kernel_summary(rows, errors, launches_by_path, framings_by_path):
    """One entry per kernel and dtype. ms, plain_ms, library_ms (TF32 off),
    library_tf32_ms, library_benchmark_ms (float32 convs, cudnn.benchmark on,
    TF32 off) and bound_ms are sums over the kernel's calls in one pass
    of each main path of that dtype (bf16: one serving forward and one
    product-loop training step; float32: one UNET step and one CubeNET-64
    step); launches are those counted during the paths' runs, by path and,
    for the framed kernels, by framing. bound_ms sums each call's bound (its
    operations or its bytes, whichever takes longer; bound_by names what
    bounds the larger share), the float32 ones at the TF32 tensor rate.
    legacy_ms sums the same calls on the synchronous body where
    phase f timed it (conv3x3_packed, float32 conv3x3_bias_act and
    conv3x3_wgrad, the shift conv, the fold mode, the dh-fold probe), else
    null;
    times_by_path holds these sums by path, and for the shift conv halo_ms,
    the halo kernel on the same inputs; bodies, the bodies the timed calls
    took where phase f read them; device_ms, plain_device_ms and
    library_device_ms, the profiler's device time of the kernels, of the
    plain versions and of the library call, where phase f took it (the
    probes), else null. The fold mode of the weight
    gradient and the shift conv are on no path (launches 0): their numbers
    are summed over the conv3x3_wgrad and conv3x3_bias_act calls of one
    product-loop step (bf16) and of one UNET and one CubeNET-64 float32 step
    (times_by_path splits them), and no single PyTorch call computes the
    fold mode's (dW, db). The probes are no part of a path either (launches 0):
    the element probe is one call at 2x608x968x64, each dh-fold kernel one
    call at the probe's 2x610x1032 buffers, the Mosaic ops one call of each
    of the eight."""
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        for dtype in DTYPES:
            mine = [r for r in rows if r["kernel"] == name and r["dtype"] == dtype]
            if not mine:
                continue
            bound_ms, bound_by = summed_bound(mine)
            by_path = {path: counts.get(name, 0) for path, counts in
                       launches_by_path[dtype].items()}
            library = [r["library_ms"] for r in mine]
            tf32 = [r["library_tf32_ms"] for r in mine]
            bench = [r.get("library_benchmark_ms") for r in mine]
            times_by_path = {}
            for r in mine:
                one = times_by_path.setdefault(r["path"], {"ms": 0.0, "plain_ms": 0.0,
                                                           "library_ms": 0.0,
                                                           "library_tf32_ms": 0.0,
                                                           "library_benchmark_ms": 0.0,
                                                           "legacy_ms": 0.0, "halo_ms": 0.0})
                for key in one:
                    one[key] = (None if one[key] is None or r.get(key) is None
                                else one[key] + r[key] * r["count"])
            for path, one in times_by_path.items():
                one["bound_ms"] = summed_bound([r for r in mine if r["path"] == path])[0]
            kernels.append({
                "name": name, "dtype": dtype, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "launches_by_framing": {path: f[name] for path, f in
                                        framings_by_path[dtype].items() if name in f},
                "max_abs_err": errors[name, dtype][0], "max_rel_err": errors[name, dtype][1],
                "ms": sum(r["ms"] * r["count"] for r in mine),
                "plain_ms": sum(r["plain_ms"] * r["count"] for r in mine),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": (None if None in library
                               else sum(ms * r["count"] for ms, r in zip(library, mine))),
                "library_tf32_ms": (None if None in tf32
                                    else sum(ms * r["count"] for ms, r in zip(tf32, mine))),
                "library_benchmark_ms": (None if None in bench else
                                         sum(ms * r["count"] for ms, r in zip(bench, mine))),
                # the same calls on the synchronous body, where it was timed too
                "legacy_ms": (sum(r["legacy_ms"] * r["count"] for r in mine)
                              if all("legacy_ms" in r for r in mine) else None),
                # the bodies the timed calls took, where phase f read them
                "bodies": sorted({r["body"] for r in mine if "body" in r}),
                # device time by the profiler, where phase f took it (the probes)
                **{key: (sum(r[key] * r["count"] for r in mine)
                         if all(key in r for r in mine) else None)
                   for key in ("device_ms", "plain_device_ms", "library_device_ms")},
                "times_by_path": times_by_path, "calls": mine,
            })
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import hyperpri_tpu_torch  # noqa: F401  (fails here when run outside the repo)
    started = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay float32
    torch.backends.cudnn.allow_tf32 = False        # and so does the float32 reference model
    card = phase_env()
    phase_build()
    serve_calls, train_calls = serving_calls(), training_calls()
    loop_calls = training_calls(ingest=True)
    unet_calls = training_calls("UNET", dtype="f32", path="unet_training")
    cube32_calls = training_calls("CubeNET", ingest=True, dtype="f32",
                                  path="cubenet_f32_training")
    errors = phase_kernel_check(serve_calls + train_calls + loop_calls + unet_calls
                                + cube32_calls)
    serving_launches, serving_framings, serving_ms = phase_serving(serve_calls)
    training_launches, training_framings, step_ms, peak, step, batch = phase_training(
        train_calls)
    rows = phase_times(serve_calls + loop_calls + unet_calls + cube32_calls
                       + unrouted_calls(loop_calls) + unrouted_calls(unet_calls)
                       + unrouted_calls(cube32_calls), card)
    fold_ab = phase_fold_ab({"bf16": loop_calls, "f32": cube32_calls})
    phase_profile(step, batch)
    del step, batch
    torch.cuda.empty_cache()
    unet = phase_training_f32("UNET", unet_calls, "j")
    cube32 = phase_training_f32("CubeNET", cube32_calls, "k")
    spectral = phase_spectral_training(card)
    spectral_eval = phase_spectral_eval(card)
    tree = write_tree()
    try:
        loop = phase_product_loop(tree, loop_calls, card)
        mesh = phase_mesh(tree, loop_calls, card)
        cli = phase_cli(tree)
        spectral_cli = phase_spectral_cli(tree, spectral["f32"]["plain"]["n_chunks"])
        host_data = phase_host_data(tree, card)
        imports = phase_checkpoint_import(tree)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    unet_options = phase_unet_options(card)
    cli_launches = {name: sum(counts.get(f"{name} f32", 0) for counts in cli["launches"].values())
                    for name in kernel_wrappers()}
    kernels = kernel_summary(
        rows, errors,
        {"bf16": {"serving": serving_launches, "training_step": training_launches,
                  "product_loop": loop["launches"], "mesh_training": mesh["launches"],
                  "spectral_unet_training": spectral["bf16"]["plain"]["launches"],
                  "unet_serving": unet_options["serving_launches"]},
         "f32": {"unet_training": unet["launches"], "cubenet_f32_training": cube32["launches"],
                 "cli": cli_launches,
                 "spectral_unet_training": spectral["f32"]["plain"]["launches"],
                 "spectral_unet_cli": spectral_cli["launches_spectral_fit"],
                 "unet_plus_training": unet_options["unet_plus_f32"]["launches"]}},
        {"bf16": {"serving": serving_framings, "training_step": training_framings,
                  "product_loop": loop["launches_by_framing"]},
         "f32": {"unet_training": unet["launches_by_framing"],
                 "cubenet_f32_training": cube32["launches_by_framing"]}})
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from import to summary")
    print(card)
    print(json.dumps({"kernels": kernels, "serving_ms_per_cube": serving_ms,
                      "training_ms_per_step": step_ms, "training_peak_gib": peak,
                      "fold_ab_ms_per_step": fold_ab, "unet_f32": unet, "cubenet_f32": cube32,
                      "product_loop": loop, "mesh": mesh, "cli": cli, "spectral_unet_training": spectral,
                      "spectral_unet_eval": spectral_eval, "spectral_cli": spectral_cli,
                      "host_data": host_data, "checkpoint_import": imports,
                      "unet_options": unet_options}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
