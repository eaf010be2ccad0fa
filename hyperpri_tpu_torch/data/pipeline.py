"""Host input pipeline: shuffle, collate, pad, pre-pad and prefetch to the
device (port of hyperpri_tpu/data/pipeline.py).

  - Fixed batch shapes: the last partial batch is filled cyclically with real
    samples and carries a per-sample `valid` mask, as in the JAX package.
  - The epoch's order is a pure function of (seed, epoch), and each sample's
    crop draws from its own child of default_rng((seed + 1, epoch)): a resumed
    epoch reproduces the original batches, and the JAX package's loader gives
    the same batches for the same seed.
  - A background thread reads, collates and copies ahead, `prefetch` batches
    deep. On a CUDA device each batch is assembled in page-locked host memory
    and copied with non_blocking copies on a side stream; the consumer's
    stream waits for the copy's event before it uses the tensors.
  - Host pre-padded ingest (parts.first_conv_ingest_spec): given a spec, the
    iterator writes each image batch into the logical region of a framed
    buffer whose frame was zeroed once when the buffer was allocated, and
    reuses that buffer for every batch: the frame is never written, so it is
    never zeroed again. The spec is an argument of the iterator, not state of
    the loader, so a loader reused for evaluation yields logical cubes.
  - Under a mesh (parallel/mesh.Mesh) the batch size is the global one,
    rounded up to a multiple of the data axis (Trainer.effective_batch), and
    every rank draws the same order and crops from the same seed: a data
    rank reads only its samples of each global batch (fill samples carry
    valid = 0, as on one device), and a spatial rank keeps its rows of them
    (pipeline.py's batch_sharding / sample_sharding).
  - `timings` records, per batch, the host seconds spent reading (ENVI
    band-window gather or PNG decode, summed over samples), casting to the
    image dtype (summed over samples), collating or pre-padding into the
    staging buffer, and copying to the device (until the copy's event).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

TIMING_KEYS = ("read", "cast", "pad", "h2d")


def collate(samples: Sequence[Dict], batch_size: int, out: Optional[torch.Tensor] = None,
            images: bool = True) -> Dict[str, object]:
    """Stack samples; fill up to `batch_size` cyclically with a `valid` mask
    (pipeline.py:27-45: duplicated real images keep the BatchNorm batch
    statistics on distribution). `out`, when given, receives the images;
    without `images` the caller places them itself."""
    n = len(samples)
    if not 0 < n <= batch_size:
        raise ValueError(f"{n} samples for a batch of {batch_size}")
    return _stack(*_positions(samples, range(batch_size)), out=out, images=images)


def _positions(samples, positions):
    """(the sample at each of `positions` of a batch of the n `samples`
    filled cyclically, their valid flags, their names): positions past n
    hold copies, which are not valid and have no name. `samples` may hold
    None where no position reads the sample."""
    n = len(samples)
    reps = [samples[p % n] for p in positions]
    valid = torch.tensor([float(p < n) for p in positions], dtype=torch.float32)
    names = [samples[p]["index"] if p < n else "" for p in positions]
    return reps, valid, names


def _stack(reps, valid, names, out: Optional[torch.Tensor] = None, images: bool = True,
           rows=slice(None)) -> Dict[str, object]:
    image = torch.stack([s["image"][rows] for s in reps], out=out) if images else None
    mask = torch.stack([s["mask"][rows] for s in reps])
    return {"image": image, "mask": mask, "valid": valid, "names": names}


def _check_spec(spec, h: int, w: int, c: int):
    """A 3-part spec carries the logical dims it was made for; a batch whose
    crop drifted from them is refused (pipeline.py:213-226): it would embed
    silently, with zero rows entering the first conv's BatchNorm statistics."""
    if len(spec) > 2 and (h, w, c) != tuple(spec[2]):
        raise ValueError(
            f"pre-padded ingest spec was probed for logical {tuple(spec[2])} (h, w, c) but "
            f"this batch is {(h, w, c)}: the crop shape changed after the ingest spec was "
            "wired")


def pre_pad_images(image: torch.Tensor, spec) -> torch.Tensor:
    """Embed a logical (N, H, W, C) image batch into a new pre-padded ingest
    buffer of `spec` ((H_pad, W_pad, C_pad), (row0, col0)[, (h, w, c)]):
    logical (0,0) at (row0, col0), zeros elsewhere."""
    (hp, wp, cp), (r0, c0) = spec[0], spec[1]
    n, h, w, c = image.shape
    _check_spec(spec, h, w, c)
    out = image.new_zeros((n, hp, wp, cp))
    out[:, r0:r0 + h, c0:c0 + w, :c] = image
    return out


def epoch_metrics_mask(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Broadcast the per-sample valid flags to per-pixel weights."""
    return valid.reshape((-1,) + (1,) * (mask.dim() - 1))


class DataLoader:
    """Epoch-based loader over a HyperpriDataset-like object (pipeline.py:48-).

    `device`: where batches go (None keeps them on the host). `image_dtype`
    is pushed into the dataset, so images are cast once per sample at load.
    `mesh`: this rank's samples and rows of each global batch (module
    docstring).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 prefetch: int = 2, device=None, weighted: bool = False,
                 image_dtype: Optional[torch.dtype] = None, fetch_workers: int = 4,
                 mesh=None):
        self.dataset = dataset
        self.mesh = mesh
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.weighted = weighted
        self.image_dtype = image_dtype
        if image_dtype is not None and hasattr(dataset, "set_image_dtype"):
            dataset.set_image_dtype(image_dtype)
        self.fetch_workers = max(1, int(fetch_workers))
        self.epoch = 0
        self.timings = {k: [] for k in TIMING_KEYS}
        self._staging: Dict[tuple, torch.Tensor] = {}
        self._stream = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def probe(self) -> Dict[str, object]:
        """One logical single-sample batch on the host, for shapes and dtypes
        (no prefetching iterator is left behind)."""
        rng = np.random.default_rng((self.seed + 1, self.epoch))
        return collate([self.dataset.__getitem__(0, rng=rng)], 1)

    def order(self) -> np.ndarray:
        """This epoch's sample order (pipeline.py:148-157)."""
        n = len(self.dataset)
        if self.weighted:
            w = np.asarray(self.dataset.sample_weights, np.float64)
            return np.random.default_rng((self.seed, self.epoch)).choice(
                n, size=n, replace=True, p=w / w.sum())
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def _samples(self) -> Iterator[tuple]:
        """-> per batch, _positions' (the samples at this rank's positions,
        valid, names), reading only the samples those positions hold."""
        order = self.order()
        crop_rng = np.random.default_rng((self.seed + 1, self.epoch))
        workers = min(self.fetch_workers, self.batch_size)
        pool = ThreadPoolExecutor(workers) if workers > 1 else None
        first, stop = (0, self.batch_size) if self.mesh is None else \
            self.mesh.sample_range(self.batch_size)
        try:
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                rngs = crop_rng.spawn(len(idx))   # every sample's, on every rank
                wanted = sorted({p % len(idx) for p in range(first, stop)})

                def fetch(k):
                    return self.dataset.__getitem__(int(idx[k]), rng=rngs[k])

                got = dict(zip(wanted, pool.map(fetch, wanted) if pool else map(fetch, wanted)))
                yield _positions([got.get(k) for k in range(len(idx))], range(first, stop))
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def _staged(self) -> bool:
        """Batches are assembled in reusable page-locked buffers only for a
        CUDA device; elsewhere every batch gets tensors of its own."""
        return self.device is not None and self.device.type == "cuda"

    def _buffer(self, key: str, shape, dtype, frame_zero: bool) -> torch.Tensor:
        """The reusable page-locked staging buffer for `key`, zeroed once when
        it is (re)allocated."""
        buf = self._staging.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            alloc = torch.zeros if frame_zero else torch.empty
            buf = alloc(tuple(shape), dtype=dtype, pin_memory=True)
            self._staging[key] = buf
        return buf

    def _assemble(self, positions, pad_spec) -> Dict[str, object]:
        reps, valid, names = positions
        first = reps[0]["image"]
        rows = slice(None)
        if self.mesh is not None and self.mesh.spatial > 1:
            rows = slice(*self.mesh.row_range(first.shape[0]))
        if pad_spec is None:
            shape = (len(reps),) + tuple(first[rows].shape)
            out = self._buffer("image", shape, first.dtype, False) if self._staged() else None
            return _stack(reps, valid, names, out=out, rows=rows)
        (hp, wp, cp), (r0, c0) = pad_spec[0], pad_spec[1]
        h, w, c = first.shape
        _check_spec(pad_spec, h, w, c)
        shape = (len(reps), hp, wp, cp)
        buf = (self._buffer("ingest", shape, first.dtype, True) if self._staged()
               else torch.zeros(shape, dtype=first.dtype))
        # only the logical region is written: the frame stays as zeroed once
        for i, sample in enumerate(reps):
            buf[i, r0:r0 + h, c0:c0 + w, :c] = sample["image"]
        batch = _stack(reps, valid, names, images=False)
        batch["image"] = buf
        return batch

    def _to_device(self, host: Dict[str, object]):
        """-> (batch on the device, the event its copy ends with or None)."""
        if self.device is None:
            return host, None
        arrays = {k: v for k, v in host.items() if isinstance(v, torch.Tensor)}
        if self.device.type != "cuda":
            return dict(host, **{k: v.to(self.device) for k, v in arrays.items()}), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            moved = {k: v.to(self.device, non_blocking=True) for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        # the staging buffers are rewritten by the next batch: wait for the copy
        event.synchronize()
        return dict(host, **moved), event

    def _batches(self, pad_spec) -> Iterator[tuple]:
        for positions in self._samples():
            t0 = time.perf_counter()
            host = self._assemble(positions, pad_spec)
            t1 = time.perf_counter()
            samples = list({id(s): s for s in positions[0]}.values())
            batch, event = self._to_device(host)
            t2 = time.perf_counter()
            self.timings["read"].append(sum(s["timing"]["read"] for s in samples))
            self.timings["cast"].append(sum(s["timing"]["cast"] for s in samples))
            self.timings["pad"].append(t1 - t0)
            self.timings["h2d"].append(t2 - t1)
            yield batch, event

    def batches(self, pad_spec=None) -> Iterator[Dict[str, object]]:
        """This epoch's batches; with `pad_spec`, images arrive as the
        pre-padded ingest buffer of that spec."""
        def ready(item):
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(stream)
            return batch

        if self.prefetch <= 0:
            for item in self._batches(pad_spec):
                yield ready(item)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def producer():
            try:
                for item in self._batches(pad_spec):
                    q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield ready(item)
        t.join()
        if err:
            raise err[0]

    def __iter__(self) -> Iterator[Dict[str, object]]:
        return self.batches()
