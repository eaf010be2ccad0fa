"""Experiment entry points (port of hyperpri_tpu/cli.py):

    python -m hyperpri_tpu_torch.cli kfold_train    [flags]
    python -m hyperpri_tpu_torch.cli kfold_validate [flags]

The flags are the JAX package's (cli.py:61-204). kfold_train trains one
model, each split (and seed) and, with --validate, runs the threshold sweep
after each run. As in the JAX package, --dataset (default HSI) picks the
configuration and the configuration picks the model, unless --model names
one: `kfold_train --dataset RGB` trains UNET, `kfold_train` trains CubeNET.
kfold_validate sweeps each split's thresholds for each model of --models
(default KFOLD_MODELS, each on RGB for UNET and HSI otherwise) and writes the
curves to {calling_path}/Saved_Models/{dataset}/{models}_pr.csv, where the JAX
package draws a combined PNG plot. SpectralUNET joins KFOLD_MODELS with its
slice; kfold_segmaps, and the flags of options not ported yet (--model-shard,
--chunks, --offload, --decoded-cache, --save-segmaps), raise. At the
configuration's default precision, fp32, the gated 3x3 convs and pool
backwards run the CUDA kernels in float32 (3xTF32 products); --precision bf16
runs them in bf16 (see config.py).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List, Optional

# kfold_validate's default --models: the ported subset of the JAX package's
# KFOLD_MODELS (cli.py:29), in its order.
KFOLD_MODELS = ["UNET", "CubeNET"]


def _make_config(dataset: str, calling_path: str, split_no: int, seed_num: int,
                 augment: bool, device: str, precision: str):
    from hyperpri_tpu_torch.config import ExpHyperspectralPRI, ExpRedGreenBluePRI

    cls = ExpRedGreenBluePRI if dataset.lower() == "rgb" else ExpHyperspectralPRI
    return cls(calling_path=calling_path, split_no=split_no, seed_num=seed_num,
               augment=augment, device=device, precision=precision)


def rename_folder(save_path: str) -> Optional[str]:
    """Archive an existing run directory with a timestamp suffix."""
    import datetime

    if not os.path.exists(save_path):
        return None
    now = datetime.datetime.now()
    suffix = f"_{now.year}{now.month}{now.day}_{now.hour}{now.minute}{now.second}"
    target = save_path.rstrip("/") + suffix + "/"
    os.rename(save_path, target)
    return target


def _add_common(p):
    p.add_argument("--model", default=None,
                   choices=["UNET", "UNET+", "SpectralUNET", "CubeNET"],
                   help="override the config's default model")
    p.add_argument("--hsi-lo", type=int, default=None)
    p.add_argument("--hsi-hi", type=int, default=None)
    p.add_argument("--cube-featmaps", type=int, default=None)
    p.add_argument("--spectral-bn-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--decoded-cache", default=None, metavar="DIR",
                   help="not ported yet")
    p.add_argument("--chunks", type=int, default=None, metavar="N", help="not ported yet")
    p.add_argument("--offload", action="store_true", help="not ported yet")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="compute precision of the model; both run the gated convs on the "
                        "CUDA kernels")


def _apply_overrides(cfg, args):
    for flag in ("chunks", "offload", "decoded_cache"):
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet")
    if args.model:
        cfg.model_name = args.model
    for attr, val in [("hsi_lo", args.hsi_lo), ("hsi_hi", args.hsi_hi),
                      ("cube_featmaps", args.cube_featmaps),
                      ("spectral_bn_size", args.spectral_bn_size), ("epochs", args.epochs)]:
        if val is not None:
            setattr(cfg, attr, val)
    if args.hsi_lo is not None or args.hsi_hi is not None:
        cfg.channels = cfg.hsi_hi - cfg.hsi_lo
    cfg._refresh_paths()
    return cfg


def kfold_train(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="kfold_train",
                                description="5-split cross-validation training")
    p.add_argument("--calling-path", default=os.getcwd())
    p.add_argument("--dataset", default="HSI", choices=["RGB", "HSI"])
    p.add_argument("--model-shard", action="store_true", help="not ported yet")
    p.add_argument("--load-ckpt", action="store_true",
                   help="resume the start split from its newest last.ckpt")
    p.add_argument("--augment", action="store_true", help="random-crop augmentation")
    p.add_argument("--n-seeds", type=int, default=1)
    p.add_argument("--start-split", type=int, default=0)
    p.add_argument("--num-splits", type=int, default=5)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--validate", action="store_true",
                   help="run the threshold sweep after each training run")
    p.add_argument("--archive-existing", action="store_true",
                   help="timestamp-rename an existing run dir instead of resuming into it")
    _add_common(p)
    args = p.parse_args(argv)
    if args.model_shard:
        raise SystemExit("--model-shard (meshes, ZeRO) is not ported yet")

    from hyperpri_tpu_torch.train.evaluate import validate_net
    from hyperpri_tpu_torch.train.trainer import train_net

    print("\n ~~~~~~~~~~ 5-SPLIT CYCLES ~~~~~~~~~~\n")
    load_ckpt = args.load_ckpt
    for run in range(args.start_split, args.num_splits):
        print(f" ********** Split {run + 1} **********")
        for seed_idx in range(args.n_seeds):
            print(f"        Seed {seed_idx + 1} / {args.n_seeds}.....")
            cfg = _make_config(args.dataset, args.calling_path, run + 1, seed_idx, args.augment,
                               args.device, args.precision)
            _apply_overrides(cfg, args)
            if args.archive_existing:
                archived = rename_folder(cfg.save_path)
                if archived:
                    print(f"archived previous run to {archived}")
            train_net(cfg, checkpoint=load_ckpt, max_epochs=args.max_epochs)
            if args.n_seeds > 1 or args.validate:
                print(f"   Model: {cfg.model_param_str}")
                print(f"   Validation JSON: {cfg.json_dir['val']}")
                validate_net(cfg.get_val_data(), cfg, save_segmaps=False)
        load_ckpt = False  # only the start split resumes


def kfold_validate(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="kfold_validate",
                                description="per-split threshold sweeps for each model")
    p.add_argument("--calling-path", default=os.getcwd())
    p.add_argument("--models", nargs="+", default=KFOLD_MODELS)
    p.add_argument("--datasets", nargs="+", default=None,
                   help="per-model dataset (default RGB for UNET, HSI otherwise)")
    p.add_argument("--start-split", type=int, default=0)
    p.add_argument("--num-splits", type=int, default=5)
    p.add_argument("--save-segmaps", action="store_true", help="not ported yet")
    _add_common(p)
    args = p.parse_args(argv)
    if args.save_segmaps:
        raise SystemExit("--save-segmaps waits for the segmaps slice")

    from hyperpri_tpu_torch.train.evaluate import validate_net

    datasets = args.datasets or ["RGB" if m.upper() == "UNET" else "HSI" for m in args.models]
    print("\n ~~~~~~~~~~ 5-SPLIT CYCLES ~~~~~~~~~~\n")
    rows, dset = [], "HSI"
    for run in range(args.start_split, args.num_splits):
        print(f" ********** Split {run + 1} **********")
        for m, dset in zip(args.models, datasets):
            cfg = _make_config(dset, args.calling_path, run + 1, 0, False, args.device,
                               args.precision)
            cfg.change_network_param(m, args.calling_path, run + 1)
            _apply_overrides(cfg, args)
            print(f"   Model: {cfg.model_param_str}")
            print(f"   Validation JSON: {cfg.json_dir['val']}")
            precision, recall, _ = validate_net(cfg.get_val_data(), cfg, save_segmaps=False)
            rows += [(run + 1, m, float(r), float(pr)) for r, pr in zip(recall, precision)]
    out = f"{args.calling_path}/Saved_Models/{dset}/{'_'.join(args.models)}_pr.csv"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["split", "model", "recall", "precision"])
        w.writerows(rows)
    print(f"saved {out}")


COMMANDS = {"kfold_train": kfold_train, "kfold_validate": kfold_validate}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        names = " | ".join(COMMANDS)
        print(f"usage: python -m hyperpri_tpu_torch.cli {{{names}}} [flags] "
              "(kfold_segmaps waits for the segmaps slice)", file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
