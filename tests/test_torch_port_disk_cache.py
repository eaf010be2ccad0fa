"""The port's decoded-cube disk cache (hyperpri_tpu_torch/data/disk_cache.py)
against the JAX package's (hyperpri_tpu/data/disk_cache.py), on small ENVI
cubes written with numpy from a seed:

  - cache_key equals the JAX package's for float32 and bfloat16;
  - an entry written by either package is read by the other without a decode;
  - an entry goes stale when the source's mtime changes; a truncated entry is
    decoded again and rewritten (as tests/test_data.py expects of JAX's);
  - sweep_cache evicts the same entries as JAX's on copies of one cache;
  - the dataset decodes HSI cubes straight into the loader's dtype through
    the cache, its cast stage reads 0, and --decoded-cache reaches it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import ml_dtypes  # noqa: E402

from hyperpri_tpu.data import disk_cache as jcache  # noqa: E402
from hyperpri_tpu.data import envi as jenvi  # noqa: E402
from hyperpri_tpu_torch import cli  # noqa: E402
from hyperpri_tpu_torch.data import disk_cache, envi  # noqa: E402
from hyperpri_tpu_torch.data.dataset import HyperpriDataset  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402

WINDOW = (3, 17)
DTYPES = [(np.float32, np.float32), (torch.float32, np.float32),
          (torch.bfloat16, ml_dtypes.bfloat16)]


@pytest.fixture
def cube_files(tmp_path):
    cube = np.random.default_rng(0).normal(size=(10, 12, 20)).astype(np.float32)
    hdr, dat = str(tmp_path / "c.hdr"), str(tmp_path / "c.dat")
    envi.write_envi(hdr, dat, cube, interleave="bil")
    return hdr, dat, str(tmp_path / "cache")


def _bits(a):
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint8).tobytes() if a.dtype != np.int16 else a.tobytes()


@pytest.mark.parametrize("mine, theirs", DTYPES, ids=["np.float32", "torch.float32",
                                                      "bfloat16"])
def test_cache_key_matches_jax(cube_files, mine, theirs):
    hdr, dat, _ = cube_files
    for window in (WINDOW, (0, None)):
        assert (disk_cache.cache_key(hdr, dat, *window, mine)
                == jcache.cache_key(hdr, dat, *window, theirs))


@pytest.mark.parametrize("mine, theirs", DTYPES[1:], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_entries_move_between_packages(cube_files, monkeypatch, mine, theirs, writer):
    """The writer decodes and stores; the reader must hit without decoding
    (its read_cube is replaced by one that raises) and return the same bits."""
    hdr, dat, cdir = cube_files
    want = envi.read_cube(hdr, dat, *WINDOW, use_native=False)

    def no_decode(*args, **kwargs):
        raise AssertionError("the cache missed")

    if writer == "jax":
        jcache.read_cube_cached(hdr, dat, *WINDOW, dtype=theirs, cache_dir=cdir)
        monkeypatch.setattr(disk_cache, "read_cube", no_decode)
        got = disk_cache.read_cube_cached(hdr, dat, *WINDOW, dtype=mine, cache_dir=cdir)
    else:
        disk_cache.read_cube_cached(hdr, dat, *WINDOW, dtype=mine, cache_dir=cdir)
        monkeypatch.setattr(jenvi, "read_cube", no_decode)
        got = jcache.read_cube_cached(hdr, dat, *WINDOW, dtype=theirs, cache_dir=cdir)
    if theirs is np.float32:
        assert _bits(got) == want.tobytes()
    else:
        assert _bits(got) == _bits(torch.from_numpy(want).to(torch.bfloat16))
    assert sorted(os.listdir(cdir)) == sorted(
        jcache.cache_key(hdr, dat, *WINDOW, theirs) + ext for ext in (".bin", ".json"))


def test_stale_and_truncated_entries_decode_again(cube_files):
    hdr, dat, cdir = cube_files
    for dtype in (torch.float32, torch.bfloat16):
        first = disk_cache.read_cube_cached(hdr, dat, *WINDOW, dtype=dtype, cache_dir=cdir)
        key = disk_cache.cache_key(hdr, dat, *WINDOW, dtype)
        bin_path = os.path.join(cdir, key + ".bin")
        size = os.path.getsize(bin_path)
        with open(bin_path, "wb") as f:
            f.write(b"xx")
        again = disk_cache.read_cube_cached(hdr, dat, *WINDOW, dtype=dtype, cache_dir=cdir)
        assert _bits(again) == _bits(first) and os.path.getsize(bin_path) == size
    # a new mtime on the source is a new key: no stale hit
    key = disk_cache.cache_key(hdr, dat, *WINDOW, torch.float32)
    st = os.stat(dat)
    os.utime(dat, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert disk_cache.cache_key(hdr, dat, *WINDOW, torch.float32) != key
    cube = np.asarray(envi.read_cube(hdr, dat, 0, 20)) + 1.0
    envi.write_envi(hdr, dat, cube.astype(np.float32), interleave="bil")
    got = disk_cache.read_cube_cached(hdr, dat, *WINDOW, dtype=torch.float32, cache_dir=cdir)
    np.testing.assert_array_equal(got, cube[..., WINDOW[0]:WINDOW[1]])


@pytest.mark.parametrize("cap_entries", [0, 1, 2, 4])
def test_sweep_evicts_as_jax_does(tmp_path, cap_entries):
    """Entries of three sizes with distinct access times, swept on two copies
    of one cache to the same cap: the same files remain and the same bytes
    are freed."""
    src = tmp_path / "src"
    src.mkdir()
    for i, n in enumerate([400, 100, 300, 200]):
        (src / f"e{i}.bin").write_bytes(b"\0" * n)
        (src / f"e{i}.json").write_text("{}")
        t = 1_000_000_000 + 1000 * ((i * 7) % 4)
        os.utime(src / f"e{i}.bin", ns=(t * 10 ** 9, t * 10 ** 9))
    cap = sorted([400, 100, 300, 200])[:cap_entries]
    results = {}
    for name, sweep in (("port", disk_cache.sweep_cache), ("jax", jcache.sweep_cache)):
        copy = tmp_path / name
        shutil.copytree(src, copy)
        for f in src.iterdir():
            st = os.stat(f)
            os.utime(copy / f.name, ns=(st.st_atime_ns, st.st_mtime_ns))
        freed = sweep(str(copy), sum(cap))
        results[name] = (freed, sorted(p.name for p in copy.iterdir()))
    assert results["port"] == results["jax"]
    assert disk_cache.sweep_cache(str(tmp_path / "absent"), 0) == 0


def test_dataset_decodes_into_the_loader_dtype_through_the_cache(tmp_path):
    make_experiment_tree(str(tmp_path), n_boxes=2, dates_per_box=1, size_hw=(12, 16),
                         bands=30, seed=0)
    split = str(tmp_path / "Datasets" / "HyperPRI" / "data_splits" / "train1.json")
    root = str(tmp_path / "Datasets" / "HyperPRI")
    cdir = str(tmp_path / "cache")
    plain = HyperpriDataset(root, "HSI", hsi_lo=2, hsi_hi=20, json_file=split)
    cached = HyperpriDataset(root, "HSI", hsi_lo=2, hsi_hi=20, json_file=split,
                             decoded_cache_dir=cdir, cache_items=4)
    for dtype in (torch.float32, torch.bfloat16):
        plain.set_image_dtype(dtype)
        cached.set_image_dtype(dtype)
        assert not cached._cache   # entries of the old dtype dropped
        for i in range(len(plain)):
            want, got = plain[i], cached[i]
            assert got["image"].dtype == dtype and got["timing"]["cast"] < 1e-3
            assert torch.equal(got["image"].view(torch.uint8), want["image"].view(torch.uint8))
        assert len(cached._cache) == len(plain)
    assert len([n for n in os.listdir(cdir) if n.endswith(".bin")]) == 2 * len(plain)


def test_cli_decoded_cache_reaches_the_dataset(tmp_path):
    p = cli.argparse.ArgumentParser()
    cli._add_common(p)
    args = p.parse_args(["--decoded-cache", str(tmp_path / "cache"), "--device", "cpu"])
    cfg = cli._apply_overrides(cli._make_config("HSI", str(tmp_path), 1, 0, False, "cpu",
                                                "fp32"), args)
    assert cfg.decoded_cache_dir == str(tmp_path / "cache")
    make_experiment_tree(str(tmp_path), n_boxes=2, dates_per_box=1, size_hw=(12, 16),
                         bands=299, seed=0)
    assert cfg.get_val_data().decoded_cache_dir == str(tmp_path / "cache")
