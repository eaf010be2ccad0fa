"""On-disk decoded-cube cache: pay the ENVI gather once per machine, not once
per process (port of hyperpri_tpu/data/disk_cache.py).

The host-RAM LRU of data/dataset.py removes the decode within a process;
every cold start still re-pays the strided band-window gather. This module
keeps the decoded (H, W, B) window, channel-last and already in the loader's
dtype, so a cold epoch becomes one contiguous sequential read.

Layout: <cache_dir>/<sha1(key)>.bin (raw bytes) + .json sidecar (shape,
dtype). The key folds in the hdr/dat absolute paths, sizes and mtimes, the
band window and the dtype's numpy name ("float32", "bfloat16"), exactly as
the JAX package computes it, so an entry written by either package is read
by the other. Writes are atomic (tmp + rename): concurrent loaders either see
a complete entry or decode themselves. A damaged entry (wrong size, missing
sidecar) is decoded again and overwritten.

Size control: sweep_cache(dir, max_bytes) evicts least-recently-used entries
(by access or modification time) down to the cap.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

from hyperpri_tpu_torch.data.envi import numpy_dtype, read_cube


def dtype_name(dtype) -> str:
    """The numpy name of a numpy or torch dtype: "bfloat16" for
    torch.bfloat16 (ml_dtypes' name), np.dtype(...).name otherwise."""
    return "bfloat16" if dtype == torch.bfloat16 else numpy_dtype(dtype).name


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _fingerprint(path: str) -> dict:
    st = os.stat(path)
    return {"path": os.path.abspath(path), "size": st.st_size, "mtime_ns": st.st_mtime_ns}


def cache_key(hdr_path: str, dat_path: str, band_lo: int, band_hi: Optional[int],
              dtype) -> str:
    payload = json.dumps(
        {
            "hdr": _fingerprint(hdr_path),
            "dat": _fingerprint(dat_path),
            "band_lo": int(band_lo),
            "band_hi": None if band_hi is None else int(band_hi),
            "dtype": dtype_name(dtype),
            "v": 1,
        },
        sort_keys=True,
    )
    return hashlib.sha1(payload.encode()).hexdigest()


def _paths(cache_dir: str, key: str):
    return os.path.join(cache_dir, key + ".bin"), os.path.join(cache_dir, key + ".json")


def _write_atomic(cache_dir: str, path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_cube_cached(hdr_path: str, dat_path: str, band_lo: int = 0,
                     band_hi: Optional[int] = None, dtype=np.float32,
                     cache_dir: Optional[str] = None):
    """envi.read_cube through the on-disk decoded cache (read_cube itself when
    cache_dir is None). Returns what read_cube returns for `dtype`."""
    if cache_dir is None:
        return read_cube(hdr_path, dat_path, band_lo, band_hi, dtype)
    name = dtype_name(dtype)
    key = cache_key(hdr_path, dat_path, band_lo, band_hi, dtype)
    bin_path, meta_path = _paths(cache_dir, key)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        shape = tuple(meta["shape"])
        nbytes = int(np.prod(shape)) * _itemsize(name)
        if meta["dtype"] == name and os.path.getsize(bin_path) == nbytes:
            raw = np.fromfile(bin_path, dtype=np.uint8, count=nbytes)
            if name == "bfloat16":
                return torch.from_numpy(raw.view(np.uint16).reshape(shape)).view(torch.bfloat16)
            return raw.view(np.dtype(name)).reshape(shape)
    except (OSError, ValueError, KeyError):
        pass  # a miss or a damaged entry: decode again and overwrite

    cube = read_cube(hdr_path, dat_path, band_lo, band_hi, dtype)
    data = (cube.view(torch.int16).numpy().tobytes() if isinstance(cube, torch.Tensor)
            else np.ascontiguousarray(cube).tobytes())
    try:
        os.makedirs(cache_dir, exist_ok=True)
        _write_atomic(cache_dir, bin_path, data)
        _write_atomic(cache_dir, meta_path,
                      json.dumps({"shape": list(cube.shape), "dtype": name}).encode())
    except OSError as e:
        # the JAX package's contract: a full or read-only cache never fails a read
        warnings.warn(f"decoded-cube cache entry not written to {cache_dir}: {e}")
    return cube


def sweep_cache(cache_dir: str, max_bytes: int) -> int:
    """Evict least-recently-touched entries down to max_bytes; returns bytes
    freed. Entry recency = the later of the .bin's st_atime and st_mtime."""
    try:
        names = [n for n in os.listdir(cache_dir) if n.endswith(".bin")]
    except OSError:
        return 0
    entries, total = [], 0
    for n in names:
        p = os.path.join(cache_dir, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((max(st.st_atime_ns, st.st_mtime_ns), st.st_size, p))
        total += st.st_size
    freed = 0
    for _, size, p in sorted(entries):
        if total - freed <= max_bytes:
            break
        for victim in (p, p[:-4] + ".json"):
            try:
                os.unlink(victim)
            except OSError:
                pass
        freed += size
    return freed
