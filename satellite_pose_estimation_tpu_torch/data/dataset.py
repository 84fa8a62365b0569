"""Host-side SPEED datasets feeding the device-resident preprocessing
(counterpart of data/dataset.py).

Split of responsibilities:
* host: frame decode (binary PPM read by numpy, every other format by PIL),
  crop-box geometry (crop.py), cheap integer pre-crop into a fixed-size
  packed buffer (bounded host-to-device traffic);
* device: fused cubic crop+resize+normalize (ops/image_warp.py), train-time
  augmentation (data/augment.py), landmark normalisation.

A packed sample carries (buffer (P, P, 3) uint8, clip_bbox in buffer coords,
landmarks in buffer coords); `pack_crop` guarantees the whole clip box is
representable, decimating by powers of two when the crop exceeds the buffer.
"""
from __future__ import annotations

import os.path as osp
from typing import Iterator, Optional

import numpy as np

from .annotations import load_detector_boxes, load_train_annotations
from .crop import (
    bbox_area,
    generate_clip_bbox_submission,
    generate_clip_bbox_train,
    generate_clip_bbox_val,
)

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _read_pnm(f):
    """(H, W, 3) uint8 of the binary PPM (P6) or PGM (P5) file ``f``, open
    at its start, or None for a maxval other than 255."""
    magic = f.read(2)
    fields, token = [], b""
    while len(fields) < 3:
        c = f.read(1)
        if not c:
            raise ValueError("truncated PNM header")
        if c == b"#" and not token:
            f.readline()
        elif c.isspace():
            if token:
                fields.append(int(token))
                token = b""
        else:
            token += c
    width, height, maxval = fields
    if maxval != 255:
        return None
    channels = 3 if magic == b"P6" else 1
    data = np.fromfile(f, np.uint8, count=width * height * channels)
    if data.size != width * height * channels:
        raise ValueError("truncated PNM data")
    img = data.reshape(height, width, channels)
    return img if channels == 3 else np.repeat(img, 3, axis=2)


def _decode(path: str) -> np.ndarray:
    """A frame as (H, W, 3) uint8 RGB. Binary PPM / PGM at maxval 255 is
    read with numpy (equal to PIL's decode of the same file); any other
    format needs PIL, and raises ImportError naming it where PIL is
    missing."""
    with open(path, "rb") as f:
        if f.read(2) in (b"P6", b"P5"):
            f.seek(0)
            img = _read_pnm(f)
            if img is not None:
                return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"decoding {path} needs PIL (Pillow); only binary PPM / PGM "
                          "frames are read without it") from e
    return np.asarray(Image.open(path).convert("RGB"))


def _decode_cache_budget() -> int:
    """Images the decoded-frame RAM cache may hold (0 disables).

    The reference hides JPEG decode behind torch DataLoader workers
    (R1/main.py DataLoader(num_workers=...)); re-decoding every epoch on a
    host with few cores serializes with the device step, so repeat-epoch
    reads come from RAM instead.
    ``SPE_DECODE_CACHE`` overrides: '0' disables, an integer caps the
    image count. Default 1024 ≈ 7 GB of 1920x1200 SPEED frames.
    """
    import os

    v = os.environ.get("SPE_DECODE_CACHE", "")
    return 1024 if v == "" else int(v)


def _packed_cache_budget() -> int:
    """Images the PACKED-sample cache may hold on the deterministic
    (train=False) path (0 disables).

    The val/submission crop is a pure function of the annotation record,
    so the whole packed sample — (P, P, 3) buffer + box metadata — can be
    memoized across epochs. At the deployment pack size (256) a sample is
    ~197 KB, 35x smaller than caching the decoded 1920x1200 frame, and a
    cache hit skips decode AND pack entirely (the round-4 warm path
    re-ran pack_crop per image per epoch — VERDICT r4 item 1).
    ``SPE_PACKED_CACHE`` overrides; default 4096 ≈ 0.8 GB at pack 256.
    """
    import os

    v = os.environ.get("SPE_PACKED_CACHE", "")
    return 4096 if v == "" else int(v)


def _cache_insert(cache: Optional[dict], path: str, img: np.ndarray,
                  budget: int) -> None:
    """Insert a decoded frame if the cache has room (first `budget` distinct
    frames win; later frames decode every epoch). Frames are frozen so an
    accidental in-place mutation by a consumer raises instead of silently
    corrupting every later epoch."""
    if cache is not None and len(cache) < budget:
        img.setflags(write=False)
        cache[path] = img


def pack_crop(img: np.ndarray, clip_bbox: np.ndarray, pack_size: int = 512):
    """Copy the clip region into a fixed (pack_size, pack_size, 3) buffer.

    Returns (buffer, bbox_in_buffer, scale, offset_xy) where
    original_coords = buffer_coords * scale + offset_xy. If the clip box is
    larger than the buffer, the source is decimated by the smallest power of
    two that fits (stride slicing; the device cubic resample follows).
    """
    H, W, _ = img.shape
    x1, y1, x2, y2 = clip_bbox
    # Integer source region (intersection with the image).
    sx1, sy1 = int(np.floor(max(0.0, x1))), int(np.floor(max(0.0, y1)))
    sx2, sy2 = int(np.ceil(min(W, x2))), int(np.ceil(min(H, y2)))
    sx2, sy2 = max(sx2, sx1 + 1), max(sy2, sy1 + 1)

    step = 1
    while (sx2 - sx1) // step > pack_size or (sy2 - sy1) // step > pack_size:
        step *= 2

    region = img[sy1:sy2:step, sx1:sx2:step]
    buf = np.zeros((pack_size, pack_size, 3), img.dtype)
    h, w = region.shape[:2]
    buf[:h, :w] = region

    scale = float(step)
    offset = np.asarray([sx1, sy1], np.float64)
    bbox_buf = np.asarray(
        [
            (x1 - sx1) / scale,
            (y1 - sy1) / scale,
            (x2 - sx1) / scale,
            (y2 - sy1) / scale,
        ]
    )
    return buf, bbox_buf, scale, offset


class SpeedTrainDataset:
    """Train/val dataset over the wz_train.json + split-index format.

    Yields per-sample dicts; batching/collation is plain numpy stacking since
    every tensor is fixed-shape by construction.
    """

    def __init__(
        self,
        data_root: str,
        ann_file: str = "wz_train.json",
        index_file: str = "train_1.txt",
        img_dir: str = "images/train",
        resize: int = 256,
        train: bool = True,
        pack_size: int = 512,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.img_dir = img_dir
        self.resize = resize
        self.train = train
        self.pack_size = pack_size
        self.seed = seed
        self.rng = np.random.RandomState(seed)  # shuffle order only
        self._epoch = 0
        self.data_infos = load_train_annotations(
            osp.join(data_root, "annos", ann_file),
            osp.join(data_root, "annos", index_file),
        )
        # Multi-epoch datasets keep up to `budget` decoded frames in RAM
        # (dict writes are GIL-atomic — safe under the threaded loader;
        # a rare duplicate decode is benign). Datasets larger than the
        # budget still get partial benefit: the first `budget` distinct
        # frames are cached, the rest decode every epoch.
        self._decode_budget = _decode_cache_budget()
        self._decode_cache: Optional[dict] = (
            {} if self._decode_budget > 0 else None
        )
        # Deterministic-path (train=False) packed-sample memo: epoch 2+
        # serves (buffer, boxes, landmarks) straight from RAM with no
        # decode and no pack. Train-mode crops are stochastic per epoch
        # and never cached.
        self._packed_budget = 0 if train else _packed_cache_budget()
        self._packed_cache: Optional[dict] = (
            {} if self._packed_budget > 0 else None
        )

    def __len__(self):
        return len(self.data_infos)

    def _decode_cached(self, path: str) -> np.ndarray:
        if self._decode_cache is None:
            return _decode(path)
        img = self._decode_cache.get(path)
        if img is None:
            img = _decode(path)
            # When the packed cache will hold every sample of this split,
            # decoded frames are never re-read — keeping them would cost
            # ~7 MB each for nothing.
            if not (self._packed_cache is not None
                    and len(self.data_infos) <= self._packed_budget):
                _cache_insert(self._decode_cache, path, img,
                              self._decode_budget)
        return img

    def __getitem__(self, idx: int) -> dict:
        if self._packed_cache is not None:
            cached = self._packed_cache.get(idx)
            if cached is not None:
                return dict(cached)  # shallow copy; arrays are frozen
        info = self.data_infos[idx]
        img = self._decode_cached(
            osp.join(self.data_root, self.img_dir, info["filename"])
        )
        H, W = img.shape[:2]
        landmarks = np.asarray(info["landmarks"], np.float64)[:, :2]
        bbox = np.asarray(info["bbox_xxyy"], np.float64)

        if self.train:
            # Per-(seed, epoch, index) RNG: deterministic, thread-safe under
            # the parallel loader, and resampled every epoch like the
            # reference's per-worker RNG streams.
            mix = (self.seed * 1000003 + self._epoch * 97 + idx) % (2 ** 31)
            clip = generate_clip_bbox_train(
                bbox, (W, H), np.random.RandomState(mix)
            )
        else:
            clip = generate_clip_bbox_val(bbox, (W, H))

        buf, bbox_buf, scale, offset = pack_crop(img, clip, self.pack_size)
        lm_buf = (landmarks - offset[None, :]) / scale

        sample = {
            "image": buf,  # (P, P, 3) uint8
            "clip_bbox_buf": bbox_buf.astype(np.float32),
            "clip_bbox": clip.astype(np.float32),  # original-image coords
            "scale": np.float32(scale),
            "offset": offset.astype(np.float32),
            "landmarks_buf": lm_buf.astype(np.float32),  # buffer pixel coords
            "labels": np.arange(11, dtype=np.int32),
            "filename": info["filename"],
        }
        if "q_vbs2tango" in info:
            sample["quat_gt"] = np.asarray(info["q_vbs2tango"], np.float32)
            sample["tvec_gt"] = np.asarray(
                info["r_Vo2To_vbs_true"], np.float32
            )
        # Area proxy for the adaptive-threshold self-assessment solver
        # (reference parenthesisation preserved, see crop.bbox_area).
        sample["bbox_area"] = np.float32(bbox_area(bbox))
        if (self._packed_cache is not None
                and len(self._packed_cache) < self._packed_budget):
            for v in sample.values():
                if isinstance(v, np.ndarray):
                    v.setflags(write=False)
            self._packed_cache[idx] = dict(sample)
        return sample

    def batches(self, batch_size: int, shuffle: Optional[bool] = None,
                drop_last: bool = True, pad_last: bool = False,
                prefetch: int = 2, rows: Optional[slice] = None) -> Iterator[dict]:
        """pad_last repeats the final sample to keep the batch shape static
        (one compiled program); the pad count rides in batch['pad'].

        ``rows`` (a slice of a batch, e.g. ``parallel.mesh.shard_rows``)
        loads only those rows of every batch, with their own pad count: a
        data-parallel rank's share. The order and the crops are those of
        the whole batch.

        ``prefetch`` > 0 decodes up to that many batches ahead on a
        background thread (the reference DataLoader's worker-prefetch
        equivalent, R1/main.py DataLoader(num_workers=...)): host JPEG
        decode overlaps the device step instead of serializing with it —
        on a host where decode dominates, wall time per step drops from
        decode+step to max(decode, step)."""
        shuffle = self.train if shuffle is None else shuffle
        self._epoch += 1
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        chunks = []
        for start in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                           batch_size):
            idxs = list(order[start:start + batch_size])
            if drop_last and len(idxs) < batch_size:
                break
            pad = 0
            if pad_last and len(idxs) < batch_size:
                pad = batch_size - len(idxs)
                idxs = idxs + [idxs[-1]] * pad
            chunks.append(_rows_of(idxs, pad, rows))

        def make(idxs, pad):
            batch = _collate(self._load_parallel(idxs))
            if pad_last:
                batch["pad"] = pad
            return batch

        yield from _prefetch_iter(chunks, make, prefetch)

    def _load_parallel(self, idxs, workers: Optional[int] = None):
        return _load_samples(self, idxs, workers)

    def advance_epochs(self, n: int) -> None:
        """Take ``n`` epochs' shuffle draws and epoch counts without loading
        anything, so that a run resumed at epoch ``n`` sees the order and
        crops an uninterrupted run sees there."""
        for _ in range(n):
            self._epoch += 1
            if self.train:
                self.rng.shuffle(np.arange(len(self)))


class SpeedSubmissionDataset:
    """Detector-box submission dataset (R1/datasets/speed.py:44-160):
    square int crop on a zero canvas, ratio preserved."""

    def __init__(
        self,
        data_root: str,
        ann_file: str,
        img_dir: str,
        resize: int = 256,
        pack_size: int = 512,
    ):
        self.data_root = data_root
        self.img_dir = img_dir
        self.resize = resize
        self.pack_size = pack_size
        self.data_infos = load_detector_boxes(
            osp.join(data_root, "annos", ann_file)
        )

    def __len__(self):
        return len(self.data_infos)

    def __getitem__(self, idx: int) -> dict:
        info = self.data_infos[idx]
        img = _decode(osp.join(self.data_root, self.img_dir, info["filename"]))
        bbox = np.asarray(info["bbox_xxyy"])
        clip = generate_clip_bbox_submission(bbox)
        buf, bbox_buf, scale, offset = pack_crop(img, clip, self.pack_size)
        return {
            "image": buf,
            "clip_bbox_buf": bbox_buf.astype(np.float32),
            "clip_bbox": clip.astype(np.float32),
            "scale": np.float32(scale),
            "offset": offset.astype(np.float32),
            "bbox_area": np.float32(bbox_area(bbox)),
            "filename": info["filename"],
        }

    def batches(self, batch_size: int, pad_last: bool = True,
                prefetch: int = 2, rows: Optional[slice] = None) -> Iterator[dict]:
        """Batches in file order, the last padded by repeating its final
        sample (the count in batch['pad']); ``rows`` loads only those rows
        of each, as ``SpeedTrainDataset.batches`` does."""
        n = len(self)
        chunks = []
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            pad = 0
            if pad_last and len(idxs) < batch_size:
                pad = batch_size - len(idxs)
                idxs = idxs + [idxs[-1]] * pad
            chunks.append(_rows_of(idxs, pad, rows))

        def make(idxs, pad):
            batch = _collate(_load_samples(self, idxs))
            batch["pad"] = pad
            return batch

        yield from _prefetch_iter(chunks, make, prefetch)



def _rows_of(idxs, pad: int, rows: Optional[slice]):
    """(the indices of ``rows`` of a batch, how many of them are pad): the
    batch's last ``pad`` rows repeat its final sample."""
    if rows is None:
        return idxs, pad
    lo, hi = rows.start, rows.stop
    return idxs[lo:hi], max(0, hi - max(lo, len(idxs) - pad))


def _prefetch_iter(items, make, prefetch: int = 2):
    """Yield ``make(*item)`` for each item, computing up to ``prefetch``
    results ahead on a background producer thread (the reference
    DataLoader's worker-prefetch equivalent): host JPEG decode overlaps
    the device step instead of serializing with it. ``prefetch<=0`` is
    the plain synchronous loop. The producer shuts down cleanly when the
    consumer abandons the iterator; producer exceptions re-raise at the
    consumer."""
    if prefetch <= 0:
        for it in items:
            yield make(*it)
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    _done = object()

    def produce():
        for it in items:
            if stop.is_set():
                return
            try:
                out = make(*it)
            except BaseException as e:  # surface in the consumer
                out = e
            while not stop.is_set():
                try:
                    q.put(out, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(out, BaseException):
                return
        while not stop.is_set():
            try:
                q.put(_done, timeout=0.2)
                return
            except queue.Full:
                continue

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _load_samples(ds, idxs, workers=None):
    """Threaded decode + crop over ``ds[i]`` (PIL's decode and numpy's file
    read release the GIL, so this scales with host cores). On a single-core
    host the pool is pure scheduling overhead: decode is CPU-bound, so
    threads cannot overlap anything within one batch (the producer thread
    in _prefetch_iter still overlaps whole batches with the device step)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    ncpu = os.cpu_count() or 1
    if workers is None:
        workers = min(16, max(4, ncpu)) if ncpu > 1 else 1
    if workers <= 1 or len(idxs) <= 1:
        return [ds[int(i)] for i in idxs]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda i: ds[int(i)], idxs))


def _collate(samples):
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == "filename":
            out[key] = vals
        else:
            out[key] = np.stack(vals)
    return out
