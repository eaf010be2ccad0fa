"""Build the CUDA sources under hyperpri_tpu_torch/csrc/ and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for sm_90a into `<repo>/build/kernels/lib<name>.so`, then loaded with
ctypes. The sources share headers (`csrc/*.cuh`), so a library is built at
first use and rebuilt when any file under csrc/ is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Every kernel library of the port: csrc/<name>.cu for each name.
LIBRARIES = ("conv3x3_packed", "conv3x3", "conv3x3_grad", "pool_bwd", "probe_element_out",
             "conv3x3_shift", "probe_dh_fold", "probe_mosaic_ops")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(candidate) if candidate.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(name: str, force: bool = False) -> tuple:
    """Compile csrc/<name>.cu unless an up-to-date library exists. Returns the
    library's path and nvcc's output ("" when nothing was built), which
    includes ptxas's register, shared-memory and spill counts."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    newest = max(f.stat().st_mtime for f in CSRC.iterdir() if f.is_file())
    if not force and out.exists() and out.stat().st_mtime >= newest:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename: concurrent processes never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_all(names=LIBRARIES, force: bool = False) -> dict:
    """Build several libraries at once, one nvcc process each, all started
    together. Returns {name: (path, nvcc output)}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name, force) for name in names}
        return {name: future.result() for name, future in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            _libs[name] = lib
        return lib
