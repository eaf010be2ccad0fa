"""The port's data layer (hyperpri_tpu_torch/data: envi, splits, png,
dataset, synthetic, pipeline) against the JAX package's on the same files.

A synthetic experiment tree written by the JAX package (with PIL) is read by
both sides: headers, cubes, split indices, dataset items (float32 and bf16
bytes), the loader's batch order over three epochs with its valid flags, and
the pre-padded ingest layout with its drift check must agree exactly. The
port's own tree must equal the JAX package's for the same seed, and its PNG
codec must agree with PIL both ways.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")
Image = pytest.importorskip("PIL.Image")

from hyperpri_tpu.data import envi as jenvi  # noqa: E402
from hyperpri_tpu.data import splits as jsplits  # noqa: E402
from hyperpri_tpu.data.dataset import HyperpriDataset as JaxDataset  # noqa: E402
from hyperpri_tpu.data.pipeline import DataLoader as JaxLoader  # noqa: E402
from hyperpri_tpu.data.pipeline import pre_pad_images as jax_pre_pad  # noqa: E402
from hyperpri_tpu.data.synthetic import make_experiment_tree as jax_tree  # noqa: E402
from hyperpri_tpu_torch.data import envi, png, splits  # noqa: E402
from hyperpri_tpu_torch.data.dataset import HyperpriDataset  # noqa: E402
from hyperpri_tpu_torch.data.pipeline import DataLoader, collate, pre_pad_images  # noqa: E402
from hyperpri_tpu_torch.data.synthetic import make_experiment_tree  # noqa: E402

BANDS, HW = 20, (16, 24)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A JAX-written tree: 3 boxes of 2 dates, 2 splits and a test split."""
    root = tmp_path_factory.mktemp("jax_tree")
    jax_tree(str(root), n_boxes=3, dates_per_box=2, size_hw=HW, bands=BANDS, seed=3,
             n_splits=2)
    return root


def _split(tree, name="train1.json"):
    return str(tree / "Datasets" / "HyperPRI" / "data_splits" / name)


def _data_root(tree):
    return str(tree / "Datasets" / "HyperPRI")


def _bits(t):
    """Bytes of a dataset image: torch float32/bf16 or numpy float32/bf16."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def test_envi_and_splits_agree(tree):
    for split in ("train1.json", "val1.json", "train2.json", "test.json"):
        mine = splits.parse_split_json(_split(tree, split), _data_root(tree), mode="hsi")
        theirs = jsplits.parse_split_json(_split(tree, split), _data_root(tree), mode="hsi")
        assert [e.__dict__ for e in mine.entries] == [e.__dict__ for e in theirs.entries]
        assert mine.class_count == theirs.class_count
        assert mine.sample_weights(["Peanut"]) == theirs.sample_weights(["Peanut"])
    entry = mine.entries[0]
    assert vars(envi.parse_envi_header(entry.hdr)) == vars(jenvi.parse_envi_header(entry.hdr))
    for lo, hi in ((0, BANDS), (3, 11)):
        a = envi.read_cube(entry.hdr, entry.dat, lo, hi)
        b = jenvi.read_cube(entry.hdr, entry.dat, lo, hi, use_native=False)
        assert a.shape == (*HW, hi - lo) and a.tobytes() == b.tobytes()
    names = tree / "names.csv"
    names.write_text("\n".join(e.name for e in mine.entries))
    mine = splits.parse_split_csv(str(names), _data_root(tree), mode="hsi")
    theirs = jsplits.parse_split_csv(str(names), _data_root(tree), mode="hsi")
    assert [e.__dict__ for e in mine.entries] == [e.__dict__ for e in theirs.entries]


def test_write_envi_and_split_json_round_trip(tmp_path):
    cube = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    for interleave in ("bil", "bip", "bsq"):
        envi.write_envi(str(tmp_path / "c.hdr"), str(tmp_path / "c.dat"), cube, interleave)
        assert np.array_equal(envi.read_cube(str(tmp_path / "c.hdr"),
                                             str(tmp_path / "c.dat")), cube)
    boxes = {"box33": {"plant_folder": "Peanut", "resolution": "7x5", "dates": ["1"]}}
    splits.write_split_json(str(tmp_path / "a.json"), boxes)
    jsplits.write_split_json(str(tmp_path / "b.json"), boxes)
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


@pytest.mark.parametrize("mode,crop", [("HSI", None), ("HSI", (9, 13)), ("RGB", (9, 13)),
                                       ("gray", None)])
def test_dataset_items_are_byte_identical(tree, mode, crop):
    kw = dict(mode=mode, crop_size=crop, hsi_lo=2, hsi_hi=18, json_file=_split(tree), seed=5)
    mine, theirs = HyperpriDataset(_data_root(tree), **kw), JaxDataset(_data_root(tree), **kw)
    assert len(mine) == len(theirs) == 4 and mine.n_channels == theirs.n_channels
    for i in range(len(mine)):
        a, b = mine[i], theirs[i]
        assert a["index"] == b["index"] and a["label"] == b["label"]
        assert _bits(a["image"]) == _bits(b["image"]) and a["image"].shape == b["image"].shape
        assert _bits(a["mask"]) == _bits(b["mask"])
    if mode == "HSI":
        mine.set_image_dtype(torch.bfloat16)
        theirs.set_image_dtype(ml_dtypes.bfloat16)
        a, b = mine.__getitem__(1), theirs.__getitem__(1)
        assert a["image"].dtype == torch.bfloat16
        assert _bits(a["image"]) == _bits(b["image"])


def test_loader_batches_match_over_three_epochs(tree):
    """Shuffled batches of 3 over 4 samples (a padded last batch) with crops:
    order, valid flags, names and bytes equal for each epoch."""
    kw = dict(mode="HSI", crop_size=(12, 20), hsi_lo=0, hsi_hi=BANDS,
              json_file=_split(tree), seed=1)
    mine = DataLoader(HyperpriDataset(_data_root(tree), **kw), 3, shuffle=True, seed=7,
                      prefetch=2)
    theirs = JaxLoader(JaxDataset(_data_root(tree), **kw), 3, shuffle=True, seed=7,
                       device_put=False)
    for epoch in range(3):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == len(mine) == 2
        for a, b in zip(got, want):
            assert a["names"] == b["names"]
            assert a["valid"].tolist() == b["valid"].tolist()
            assert _bits(a["image"]) == _bits(b["image"])
            assert _bits(a["mask"]) == _bits(b["mask"])
    assert got[-1]["valid"].tolist() == [1.0, 0.0, 0.0]
    assert all(len(v) == 6 for v in mine.timings.values())   # 3 epochs of 2 batches
    probe_a, probe_b = mine.probe(), theirs.probe()
    assert _bits(probe_a["image"]) == _bits(probe_b["image"])


def test_pre_pad_layout_and_drift_check():
    img = np.arange(2 * 5 * 6 * 3).reshape(2, 5, 6, 3).astype(np.float32)
    spec = ((10, 16, 8), (1, 1), (5, 6, 3))
    buf = pre_pad_images(torch.from_numpy(img), spec)
    assert buf.numpy().tobytes() == jax_pre_pad(img, spec).tobytes()
    for bad in (np.zeros((2, 4, 6, 3), np.float32), np.zeros((2, 5, 6, 2), np.float32)):
        with pytest.raises(ValueError, match="crop shape"):
            jax_pre_pad(bad, spec)
        with pytest.raises(ValueError, match="crop shape"):
            pre_pad_images(torch.from_numpy(bad), spec)


def test_loader_pre_pads_when_asked_and_only_then(tree):
    """The ingest spec is an argument of the iterator: the same loader yields
    framed images with it and logical ones without."""
    ds = HyperpriDataset(_data_root(tree), mode="HSI", hsi_lo=0, hsi_hi=BANDS,
                         json_file=_split(tree))
    loader = DataLoader(ds, 2, prefetch=0)
    spec = ((HW[0] + 2, HW[1] + 2, 32), (1, 1), (*HW, BANDS))
    framed = list(loader.batches(spec))
    logical = list(loader)
    assert all(tuple(b["image"].shape) == (2, 18, 26, 32) for b in framed)
    for f, b in zip(framed, logical):
        assert torch.equal(f["image"], pre_pad_images(b["image"], spec))
        assert torch.equal(f["mask"], b["mask"]) and f["names"] == b["names"]
    with pytest.raises(ValueError, match="crop shape"):
        list(loader.batches(((18, 26, 32), (1, 1), (15, 24, BANDS))))


def test_collate_fills_cyclically():
    samples = [{"image": torch.full((2, 2, 1), float(i)), "mask": torch.zeros(2, 2, 1),
                "index": f"s{i}"} for i in range(2)]
    batch = collate(samples, 3)
    assert batch["image"][:, 0, 0, 0].tolist() == [0.0, 1.0, 0.0]
    assert batch["valid"].tolist() == [1.0, 1.0, 0.0] and batch["names"] == ["s0", "s1", ""]


def test_port_tree_equals_jax_tree(tmp_path):
    """The same seed writes the same tree: cubes and headers byte for byte,
    PNGs pixel for pixel (the encoders differ), split JSONs as data."""
    jax_tree(str(tmp_path / "jax"), n_boxes=2, dates_per_box=2, size_hw=HW, bands=BANDS,
             seed=4, n_splits=2)
    make_experiment_tree(str(tmp_path / "port"), n_boxes=2, dates_per_box=2, size_hw=HW,
                         bands=BANDS, seed=4, n_splits=2)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert any(f.suffix == ".png" for f in files) and any(f.suffix == ".dat" for f in files)
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix == ".png":
            assert np.array_equal(png.read_png(str(b)), np.asarray(Image.open(a)))
        elif rel.suffix == ".json":
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def _filters(data: bytes):
    """The row-filter bytes of a PNG's image data."""
    import zlib

    arr = png.decode_png(data)
    stride = arr.shape[1] * (arr.shape[2] if arr.ndim == 3 else 1)
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(arr.shape[0])}


@pytest.mark.parametrize("shape,mode", [((37, 53), "L"), ((37, 53, 3), "RGB"),
                                        ((20, 31, 4), "RGBA"), ((20, 31, 2), "LA")])
def test_png_codec_against_pil(shape, mode):
    rng = np.random.default_rng(1)
    img = (rng.random(shape) * 255).astype(np.uint8)
    img[5:9] = img[4]          # smooth rows, so PIL's adaptive filters vary
    img[:, 10:14] = 200
    filters = set()
    for optimize in (False, True):
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, format="PNG", optimize=optimize)
        assert np.array_equal(png.decode_png(buf.getvalue()), img)
        filters |= _filters(buf.getvalue())
    assert len(filters) >= 2   # more than one row filter was decoded
    if mode != "LA":
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(png.encode_png(img)))), img)


def test_png_decodes_every_filter_kind(tmp_path):
    """Rows written with each of the five filters decode to PIL's pixels."""
    import struct
    import zlib

    rng = np.random.default_rng(2)
    img = (rng.random((10, 9, 3)) * 255).astype(np.uint8)
    bpp, rows, prior = 3, [], np.zeros(27, np.int32)
    for y in range(10):
        cur = img[y].reshape(-1).astype(np.int32)
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 10, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    assert np.array_equal(png.decode_png(data), img)
    path = tmp_path / "rgb.png"
    path.write_bytes(data)
    assert np.array_equal(png.load_png(str(path), "L"),
                          np.asarray(Image.open(path).convert("L")))
    assert np.array_equal(png.load_png(str(path), "RGB"), img)
    assert os.path.getsize(path) == len(data)


@pytest.mark.parametrize("fold", [1, 2, 3, 4, 5])
def test_shipped_split_files_parse_alike(fold):
    """The published 5-fold split files (Datasets/HyperPRI/data_splits) give
    the same entries, class counts and sample weights through both parsers."""
    split_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "Datasets", "HyperPRI", "data_splits")
    for kind in ("train", "val"):
        path = os.path.join(split_dir, f"{kind}{fold}.json")
        mine = splits.parse_split_json(path, "/data", mode="hsi", require_exists=False)
        theirs = jsplits.parse_split_json(path, "/data", mode="hsi", require_exists=False)
        assert len(mine) == len(theirs) > 0
        assert [e.__dict__ for e in mine.entries] == [e.__dict__ for e in theirs.entries]
        assert mine.class_count == theirs.class_count
        assert mine.sample_weights(splits.DEFAULT_CLASS_LIST) == theirs.sample_weights(
            jsplits.DEFAULT_CLASS_LIST)
