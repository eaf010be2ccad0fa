"""The port's native ENVI reader (hyperpri_tpu_torch/data/native_io.py, built
from its own copy of the C++ source with g++ into a temporary directory)
against its numpy reader and the JAX package's readers, on small cubes
written with numpy from a seed:

  - every interleave (bil, bip, bsq), every ENVI data type the C++ reader
    takes, several band windows, big-endian data and a header offset: the
    port's native float32 read is byte-equal to its numpy read, to the JAX
    package's numpy read and to the JAX package's native read of the same
    file (runtime/envi_reader.cc built into the test's directory and named
    by HYPERPRI_IO_LIB);
  - bfloat16: the port's bits equal the float32 read rounded by torch and the
    JAX package's ml_dtypes bits;
  - a short file is refused by both packages; a failed build and a nonzero
    return code raise, and read_cube then reads nothing through numpy.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import ml_dtypes  # noqa: E402

from hyperpri_tpu.data import envi as jenvi  # noqa: E402
from hyperpri_tpu.data import native_io as jnative  # noqa: E402
from hyperpri_tpu_torch.data import envi, native_io  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (7, 9, 12)   # lines, samples, bands
WINDOWS = [(0, 12), (2, 9), (11, 12)]
DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64, np.uint16, np.uint32,
          np.int64, np.uint64]


def _cube(dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return (rng.normal(size=SHAPE) * 1000).astype(dtype)
    info = np.iinfo(dtype)
    # integers beyond 2**24 (float32 rounds them) where the type holds them
    hi = min(int(info.max), 2 ** 40)
    return rng.integers(max(int(info.min), -hi), hi, size=SHAPE, dtype=dtype)


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    """The port's library built by native_io.build into a temporary build
    directory, and the JAX package's built there from runtime/envi_reader.cc
    with runtime/Makefile's flags."""
    d = tmp_path_factory.mktemp("native")
    jax_lib = d / "libjax_io.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-shared", "-o",
                    str(jax_lib), os.path.join(ROOT, "runtime", "envi_reader.cc")], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(native_io, "BUILD_DIR", d / "port")
    mp.setattr(native_io, "_lib", None)
    mp.setenv("HYPERPRI_IO_LIB", str(jax_lib))
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_lib_checked", False)
    assert native_io.build() == d / "port" / native_io.LIBRARY_NAME
    assert jnative.get_library() is not None
    yield d
    mp.undo()


def _write(tmp_path, cube, interleave, big_endian=False, offset=0):
    hdr, dat = str(tmp_path / "c.hdr"), str(tmp_path / "c.dat")
    envi.write_envi(hdr, dat, cube, interleave=interleave)
    if big_endian or offset:
        raw = open(dat, "rb").read()
        if big_endian:
            arr = {"bsq": np.transpose(cube, (2, 0, 1)), "bil": np.transpose(cube, (0, 2, 1)),
                   "bip": cube}[interleave]
            raw = np.ascontiguousarray(arr).astype(cube.dtype.newbyteorder(">")).tobytes()
        with open(dat, "wb") as f:
            f.write(b"\x5a" * offset + raw)
        text = open(hdr).read()
        text = text.replace("byte order = 0", f"byte order = {int(big_endian)}")
        text = text.replace("header offset = 0", f"header offset = {offset}")
        open(hdr, "w").write(text)
    return hdr, dat


def _reads_agree(hdr, dat, windows):
    for lo, hi in windows:
        port_native = envi.read_cube(hdr, dat, lo, hi)
        port_numpy = envi.read_cube(hdr, dat, lo, hi, use_native=False)
        jax_numpy = jenvi.read_cube(hdr, dat, lo, hi, use_native=False)
        jax_native = jnative.read_cube_native(jenvi.parse_envi_header(hdr), dat, lo, hi,
                                              np.float32)
        assert port_native.dtype == np.float32 and port_native.shape == SHAPE[:2] + (hi - lo,)
        for other in (port_numpy, jax_numpy, jax_native):
            assert port_native.tobytes() == other.tobytes(), (lo, hi)
        bf16 = envi.read_cube(hdr, dat, lo, hi, dtype=torch.bfloat16)
        assert bf16.dtype == torch.bfloat16 and bf16.is_contiguous()
        bits = bf16.view(torch.int16).numpy()
        want = torch.from_numpy(port_numpy).to(torch.bfloat16).view(torch.int16).numpy()
        jax_bits = jenvi.read_cube(hdr, dat, lo, hi, dtype=ml_dtypes.bfloat16).view(np.int16)
        np.testing.assert_array_equal(bits, want)
        np.testing.assert_array_equal(bits, jax_bits)
        numpy_bf16 = envi.read_cube(hdr, dat, lo, hi, dtype=torch.bfloat16, use_native=False)
        np.testing.assert_array_equal(numpy_bf16.view(torch.int16).numpy(), bits)


@pytest.mark.parametrize("interleave", ["bil", "bip", "bsq"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_native_read_matches_numpy_and_jax(libraries, tmp_path, interleave, dtype):
    cube = _cube(dtype, DTYPES.index(dtype))
    _reads_agree(*_write(tmp_path, cube, interleave), WINDOWS)


@pytest.mark.parametrize("interleave", ["bil", "bip", "bsq"])
def test_big_endian_and_header_offset(libraries, tmp_path, interleave):
    for dtype in (np.float32, np.int16, np.float64):
        cube = _cube(dtype, 3)
        _reads_agree(*_write(tmp_path, cube, interleave, big_endian=True, offset=37),
                     WINDOWS[1:2])


def test_short_file_is_refused(libraries, tmp_path):
    hdr, dat = _write(tmp_path, _cube(np.float32, 0), "bil")
    with open(dat, "r+b") as f:
        f.truncate(os.path.getsize(dat) - 4)
    for read in (envi.read_cube, jenvi.read_cube):
        with pytest.raises(ValueError, match="too small"):
            read(hdr, dat, 0, 12)


def test_nonzero_return_code_raises(libraries, tmp_path):
    """The reader's own checks (a short file, a missing file) come back as
    nonzero codes, which raise with the code."""
    hdr, dat = _write(tmp_path, _cube(np.float32, 0), "bip")
    header = envi.parse_envi_header(hdr)
    with open(dat, "r+b") as f:
        f.truncate(os.path.getsize(dat) - 4)
    with pytest.raises(OSError, match="returned -27"):
        native_io.read_cube_native(header, dat, 0, 12, torch.float32)
    with pytest.raises(OSError, match="returned -2 "):
        native_io.read_cube_native(header, dat + ".missing", 0, 12, torch.bfloat16)


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    hdr, dat = _write(tmp_path, _cube(np.float32, 0), "bil")
    bad = tmp_path / "broken.cc"
    bad.write_text("int envi_read_slice( {\n")
    monkeypatch.setattr(native_io, "SOURCE", bad)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_io, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\n)*error"):
        native_io.build()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        envi.read_cube(hdr, dat, 0, 12)
    assert not (tmp_path / "build" / native_io.LIBRARY_NAME).exists()
    # asked for, the numpy reader needs no library
    assert envi.read_cube(hdr, dat, 0, 12, use_native=False).shape == SHAPE


def test_build_is_reused_until_the_source_changes(tmp_path, monkeypatch):
    src = tmp_path / "envi_reader.cc"
    src.write_bytes(native_io.SOURCE.read_bytes())
    runs = []
    real_run = subprocess.run

    def counting_run(cmd, **kwargs):
        runs.append(cmd)
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(native_io, "SOURCE", src)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_io.subprocess, "run", counting_run)
    out = native_io.build()
    assert native_io.build() == out and len(runs) == 1
    assert runs[0][1:6] == native_io.CXX_FLAGS
    newer = out.stat().st_mtime + 10
    os.utime(src, (newer, newer))
    native_io.build()
    assert len(runs) == 2
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native_io.LIBRARY_NAME]
