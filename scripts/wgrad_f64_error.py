"""The weight gradient's float32 rounding on a training step's cotangents,
against float64, for both kernel bodies of conv3x3_wgrad:

    python3 scripts/wgrad_f64_error.py [SEEDS]

At every distinct bf16 conv3x3_wgrad call of a CubeNET-64 product-loop step
(chip_smoke.training_calls(ingest=True)) and every distinct float32 one of a
CubeNET-64 float32 step with the ingest buffer (which holds every float32
weight-gradient shape of the UNET step too), on the inputs of chip_smoke.py's
phase l: g_eff folded from a cotangent and the statistics' cotangents, so
that it carries a per-channel offset and dW sums terms of one sign, where
the float32 rounding along an accumulator chain shows. For seeds 0 to
SEEDS - 1 (default 4) it holds the Hopper body and the synchronous one
(`_legacy=True`) against a float64 dW and prints, per call and body, the
largest |dW - dW_f64| over the sum of the absolute terms, beside the 2e-5
limit and the pixel tiles a split chains (256 pixels each). The card's name
and power limit come first. Needs a CUDA device; imports no JAX.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    args = sys.argv[1:]
    if len(args) > 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    seeds = int(args[0]) if args else 4
    sys.path.insert(0, ROOT)
    import chip_smoke
    from hyperpri_tpu_torch.ops.kernels import _plain, framing, sm90_plan
    from hyperpri_tpu_torch.ops.kernels.conv3x3_grad import conv3x3_wgrad

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{card}; seeds 0-{seeds - 1}; limit {chip_smoke.SUM_REL:.0e}", flush=True)
    calls = chip_smoke.distinct([
        c for dtype in chip_smoke.DTYPES
        for c in chip_smoke.unrouted_calls(chip_smoke.training_calls(ingest=True, dtype=dtype))
        if c["kernel"] == "conv3x3_wgrad_fold"])
    worst = {dtype: {"sm90": 0.0, "legacy": 0.0} for dtype in chip_smoke.DTYPES}
    for call in calls:
        n, h, w, c = call["shape"]
        o, dtype = call["o"], call["dtype"]
        x_pitch = framing.ingest_spec(h, w, c)[0][2] if "pre_padded" in call["framing"] else c
        chains = {body: sm90_plan.wgrad_plan(n, h, w, c, o, chip_smoke.DTYPES[dtype], x_pitch, o,
                                             sm90=body == "sm90").tiles_per_split
                  for body in ("sm90", "legacy")}
        errs = {body: 0.0 for body in chains}
        for seed in range(seeds):
            case = chip_smoke.Case(call, torch.Generator(device="cuda").manual_seed(seed))
            (x, gy, pa, pb), kw, lg = case.args, case.kwargs, case.logical
            g_mat = _plain.fold_stats_cotangent(gy, kw["gsum"], kw["gsumsq"], kw["y"], case.dtype)
            g_log = _plain.fold_stats_cotangent(lg["gy"], lg["gsum"], lg["gsumsq"], lg["y"],
                                                case.dtype)
            z = _plain.prologue_act(lg["x"], lg["pa"], lg["pb"])
            exact = chip_smoke.wgrad_f64(z, g_log)
            scale = chip_smoke.wgrad_f64(z.abs(), g_log.abs())
            for body in chains:
                dw = conv3x3_wgrad(x, g_mat, pa, pb, _legacy=body == "legacy",
                                   **case.materialized_kwargs)
                errs[body] = max(errs[body], chip_smoke.sum_error(dw, exact, scale))
            del case, g_mat, g_log, z, exact, scale
            torch.cuda.empty_cache()
        for body in chains:
            worst[dtype][body] = max(worst[dtype][body], errs[body])
        print(f"  {dtype:4s} {c}->{o} at {n}x{h}x{w} {call['mode']:13s} x{call['count']}: sm90 "
              f"{errs['sm90']:.3e} ({chains['sm90']} tiles a split), synchronous "
              f"{errs['legacy']:.3e} ({chains['legacy']})", flush=True)
    for dtype, by_body in worst.items():
        print(f"  largest {dtype}: sm90 {by_body['sm90']:.3e}, synchronous "
              f"{by_body['legacy']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
