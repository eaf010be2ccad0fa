"""Experiment entry points (port of hyperpri_tpu/cli.py):

    python -m hyperpri_tpu_torch.cli kfold_train    [flags]
    python -m hyperpri_tpu_torch.cli kfold_validate [flags]
    python -m hyperpri_tpu_torch.cli kfold_segmaps  [flags]

The flags are the JAX package's (cli.py:61-246). kfold_train trains one
model, each split (and seed) and, with --validate, runs the threshold sweep
after each run. As in the JAX package, --dataset (default HSI) picks the
configuration and the configuration picks the model, unless --model names
one: `kfold_train --dataset RGB` trains UNET, `kfold_train` trains CubeNET,
`kfold_train --model SpectralUNET --chunks K` trains SpectralUNET with K
pixel chunks a step (BatchNorm statistics per chunk; K = batch size is the
reference's per-image semantics) and --offload keeps its saved residuals in
pinned host memory; both flags refuse any other model. kfold_validate sweeps
each split's thresholds for each model of --models (default KFOLD_MODELS,
each on RGB for UNET and HSI otherwise) and writes the curves to
{calling_path}/Saved_Models/{dataset}/{models}_pr.csv, where the JAX package
draws a combined PNG plot; --save-segmaps writes each validation image's
overlay. kfold_segmaps runs test_net for each model and split at the
published thresholds (REFERENCE_THRESHOLDS, or --thresholds) and writes the
overlays unless --no-segmaps. --decoded-cache DIR keeps each decoded cube
window on disk, so that cold epochs read it back instead of re-paying the
ENVI gather; --model UNET+ trains UNET with the skip*x merge. Each command
evaluates a reference checkpoint (Lightning .ckpt, raw best_wts.pt or a
ZeRO-2 directory) found under a run's save path as well as the port's own.
--model-shard trains as train_net(model_parallel=True): bf16, ZeRO-sharded
Adam state and a mesh of the launched world, one process per device, under
`torchrun --standalone --nproc_per_node N -m hyperpri_tpu_torch.cli
kfold_train --model-shard` (or as a single process, world 1); the sweep
after it runs on the same mesh. At the configuration's default precision, fp32, the
gated 3x3 convs and pool backwards of UNET and CubeNET run the CUDA kernels
in float32 (3xTF32 products); --precision bf16 runs them in bf16 (see
config.py).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List, Optional

# Published best validation thresholds (BASELINE.md), per model and split.
REFERENCE_THRESHOLDS = {
    "UNET": [0.36, 0.41, 0.42, 0.56, 0.38],
    "SpectralUNET": [0.45, 0.39, 0.48, 0.36, 0.28],
    "CubeNET": [0.33, 0.46, 0.39, 0.46, 0.27],
}

KFOLD_MODELS = ["UNET", "SpectralUNET", "CubeNET"]


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
                   help="on-disk decoded-cube cache dir: cold epochs read the "
                        "decoded band window instead of re-paying the ENVI gather")
    p.add_argument("--chunks", type=int, default=None, metavar="N",
                   help="SpectralUNET: chunked-pixel gradient accumulation, BatchNorm "
                        "statistics per chunk (N = batch size: the reference's per-image "
                        "semantics)")
    p.add_argument("--offload", action="store_true",
                   help="SpectralUNET: saved residuals in pinned host memory across the "
                        "forward-to-backward gap (numerics of the plain step)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="compute precision of the model; both run the gated convs on the "
                        "CUDA kernels")


def _apply_overrides(cfg, args):
    if args.model:
        cfg.model_name = args.model
    # --chunks / --offload are SpectralUNET training modes; a silent no-op on
    # another model would record misleading hparams (cli.py:88-96)
    for flag in ("chunks", "offload"):
        if getattr(args, flag, None) and cfg.model_name.lower() != "spectralunet":
            raise SystemExit(f"--{flag} is a SpectralUNET training mode (per-pixel model); "
                             f"current model is {cfg.model_name}")
    for attr, val in [("hsi_lo", args.hsi_lo), ("hsi_hi", args.hsi_hi),
                      ("cube_featmaps", args.cube_featmaps),
                      ("spectral_bn_size", args.spectral_bn_size), ("epochs", args.epochs),
                      ("decoded_cache_dir", args.decoded_cache),
                      ("grad_accum_chunks", args.chunks), ("offload", args.offload or None)]:
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
    p.add_argument("--model-shard", action="store_true",
                   help="multi-device training (MODEL_SHARD=True): bf16 + ZeRO-sharded Adam "
                        "state + a data x spatial mesh of the torchrun world")
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

    from hyperpri_tpu_torch.parallel.mesh import launched_world
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
            if args.archive_existing and launched_world()[0] == 0:   # one rank renames
                archived = rename_folder(cfg.save_path)
                if archived:
                    print(f"archived previous run to {archived}")
            train_net(cfg, checkpoint=load_ckpt, model_parallel=args.model_shard,
                      max_epochs=args.max_epochs)
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
    p.add_argument("--save-segmaps", action="store_true",
                   help="write each validation image's overlay at the best threshold")
    _add_common(p)
    args = p.parse_args(argv)

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
            precision, recall, _ = validate_net(cfg.get_val_data(), cfg,
                                                save_segmaps=args.save_segmaps)
            rows += [(run + 1, m, float(r), float(pr)) for r, pr in zip(recall, precision)]
    out = f"{args.calling_path}/Saved_Models/{dset}/{'_'.join(args.models)}_pr.csv"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["split", "model", "recall", "precision"])
        w.writerows(rows)
    print(f"saved {out}")


def kfold_segmaps(argv: Optional[List[str]] = None) -> dict:
    """-> {(split, model): test_net's results}."""
    p = argparse.ArgumentParser(prog="kfold_segmaps",
                                description="test-set metrics + segmaps at fixed thresholds")
    p.add_argument("--calling-path", default=os.getcwd())
    p.add_argument("--models", nargs="+", default=KFOLD_MODELS)
    p.add_argument("--datasets", nargs="+", default=None)
    p.add_argument("--start-split", type=int, default=0)
    p.add_argument("--num-splits", type=int, default=5)
    p.add_argument("--testing-set", default="test", choices=["train", "val", "test"])
    p.add_argument("--test-json", default=None,
                   help="override test split JSON (default data_splits/test.json)")
    p.add_argument("--no-segmaps", action="store_true")
    p.add_argument("--thresholds", nargs="+", type=float, default=None,
                   help="flat per-model thresholds (default: published table)")
    _add_common(p)
    args = p.parse_args(argv)

    from hyperpri_tpu_torch.train.evaluate import test_net

    datasets = args.datasets or ["RGB" if m.upper() == "UNET" else "HSI" for m in args.models]
    print("\n ~~~~~~~~~~ 5-SPLIT CYCLES ~~~~~~~~~~\n")
    results = {}
    for run in range(args.start_split, args.num_splits):
        print(f" ********** Split {run + 1} **********")
        for m_idx, (m, dset) in enumerate(zip(args.models, datasets)):
            cfg = _make_config(dset, args.calling_path, run + 1, 0, False, args.device,
                               args.precision)
            cfg.change_network_param(m, args.calling_path, run + 1)
            _apply_overrides(cfg, args)
            cfg.json_dir["test"] = args.test_json or os.path.join(cfg.data_dir, "data_splits",
                                                                  "test.json")
            print(f"   Model: {cfg.model_param_str}")
            print(f"   Test JSON: {cfg.json_dir['test']}")
            data = {"train": cfg.get_train_data, "val": cfg.get_val_data,
                    "test": cfg.get_test_data}[args.testing_set]()
            if args.thresholds is not None:
                thr = args.thresholds[m_idx]
            else:
                thr = REFERENCE_THRESHOLDS.get(m, [0.5] * 5)[run]
            results[run + 1, m] = test_net(data, cfg, best_threshold=thr,
                                           save_segmaps=not args.no_segmaps)
    return results


COMMANDS = {"kfold_train": kfold_train, "kfold_validate": kfold_validate,
            "kfold_segmaps": kfold_segmaps}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        names = " | ".join(COMMANDS)
        print(f"usage: python -m hyperpri_tpu_torch.cli {{{names}}} [flags]", file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
