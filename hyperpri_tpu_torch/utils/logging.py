"""Experiment logging: CSV metrics + TensorBoard events + JSON hyperparameters
(port of hyperpri_tpu/utils/logging.py, without its offline Comet archive).

Metrics land in {save_path}/LOGS/metrics.csv, TensorBoard scalar events in
{save_path}/LOGS/tb/events.out.tfevents.* (utils/tb_events.py), hyperparameters
in {save_path}/LOGS/hparams.json and a JSONL event stream in
{save_path}/LOGS/events.jsonl. No external service is contacted.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

from hyperpri_tpu_torch.utils.tb_events import TBEventWriter


class ExperimentLogger:
    def __init__(self, save_path: str, hparams: Optional[Any] = None, tensorboard: bool = True):
        self.log_dir = os.path.join(save_path, "LOGS")
        os.makedirs(self.log_dir, exist_ok=True)
        self.csv_path = os.path.join(self.log_dir, "metrics.csv")
        self.jsonl_path = os.path.join(self.log_dir, "events.jsonl")
        self.tb = TBEventWriter(os.path.join(self.log_dir, "tb")) if tensorboard else None
        # On resume, adopt the existing CSV's header so appended rows align.
        self._fieldnames = self._read_existing_header()
        if hparams is not None:
            self.log_hparams(hparams)

    def log_hparams(self, hparams: Any) -> None:
        if dataclasses.is_dataclass(hparams) and not isinstance(hparams, type):
            data = dataclasses.asdict(hparams)
        elif isinstance(hparams, dict):
            data = hparams
        else:
            data = dict(vars(hparams))
        safe = {k: v for k, v in data.items() if _jsonable(v)}
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(safe, f, indent=2, default=str)

    def _read_existing_header(self):
        try:
            with open(self.csv_path, newline="") as f:
                header = next(csv.reader(f), None)
            return list(header) if header else None
        except OSError:
            return None

    def _rewrite_csv_with_header(self) -> None:
        """Rewrite metrics.csv under the grown field set.

        A metric key appearing mid-run (e.g. val metrics after the first
        train-only epoch) must not produce rows wider than the header —
        every row is re-emitted aligned to the union header, blank-filling
        columns a row never had."""
        rows = []
        try:
            with open(self.csv_path, newline="") as f:
                # restkey collects cells beyond the header (a legacy file whose
                # data rows are wider than its header row); drop them instead
                # of letting the rewrite below crash on a None fieldname.
                rows = [
                    {k: v for k, v in row.items() if k is not None}
                    for row in csv.DictReader(f, restkey=None)
                ]
        except OSError:
            pass
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, restval="", extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: _to_float(v) for k, v in metrics.items()})
        if self._fieldnames is None:
            self._fieldnames = list(row)
            with open(self.csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
        elif any(k not in self._fieldnames for k in row):
            self._fieldnames += [k for k in row if k not in self._fieldnames]
            self._rewrite_csv_with_header()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore", restval="")
            w.writerow(row)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.tb is not None:
            self.tb.add_scalars(
                {
                    k: v
                    for k, v in row.items()
                    if isinstance(v, (int, float)) and k not in ("step", "time", "epoch")
                },
                step,
            )

    def close(self) -> None:
        """Close the TensorBoard event file; CSV and JSONL writes are per call."""
        if self.tb is not None:
            self.tb.close()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return isinstance(v, (str, int, float, bool, type(None)))
