"""Run chip_smoke.py's SpectralUNET phases alone on one card:

    python3 scripts/chip_spectral.py

It prints the card and its MemAvailable, builds the kernels (phases a and b),
takes two offloaded bf16 steps at 16 pixel chunks and stops unless the pinned
host peak stays under 35 GiB (one chunk's copies: half of what the 8-chunk
runs pin), then runs phases m and n, writes phase h's synthetic tree, trains
UNET and CubeNET on it for one epoch through the CLI in this process (phase o
validates all three models), runs phase o, and prints the phases' records as
one JSON line and its own seconds. Needs a CUDA device and about 60 GiB of
free host memory; imports no JAX.
"""

import json
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"MemAvailable {cs.mem_available_bytes() / 2 ** 30:.2f} GiB", flush=True)
    card = cs.phase_env()
    cs.phase_build()
    batch = cs.spectral_batch()
    probe, _ = cs.spectral_run(torch.bfloat16, 16, True, batch, "pinned-memory probe", 2, 1, 2)
    print(f"pinned peak at 16 chunks: {probe['pinned_host_peak_gib']} GiB, MemAvailable "
          f"{cs.mem_available_bytes() / 2 ** 30:.2f} GiB", flush=True)
    cs.check((probe["pinned_host_peak_gib"] or 0) < 35,
             "pinned host blocks are not reused from chunk to chunk")
    cs.empty_host_cache()
    del batch
    m = cs.phase_spectral_training(card)
    n = cs.phase_spectral_eval(card)
    print(f"m + n: {time.perf_counter() - t0:.1f} s", flush=True)
    tree = cs.write_tree()
    try:
        from hyperpri_tpu_torch import cli

        for flags in (["--dataset", "RGB"], []):
            t1 = time.perf_counter()
            cli.main(["kfold_train", "--calling-path", tree, "--num-splits", "1",
                      "--max-epochs", "1", "--validate"] + flags)
            print(f"kfold_train {flags}: {time.perf_counter() - t1:.1f} s", flush=True)
        o = cs.phase_spectral_cli(tree, m["f32"]["plain"]["n_chunks"])
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    print(json.dumps({"m": m, "n": n, "o": o}, default=str))
    print(f"chip_spectral: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
