"""CIFAR-10 dataset wrapper for the classification sanity task (a copy of
the JAX package's data/cifar10.py, R2/src/data/cifar10/__init__.py:7-19
equivalent). Reads the standard python-version batch files from disk
(data_batch_1..5 / test_batch) with pickle and numpy; no torchvision and
no downloading. ``write_synthetic_batches`` writes a learnable stand-in set
in that format."""
from __future__ import annotations

import os.path as osp
import pickle
from typing import Tuple

import numpy as np

CIFAR10_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.asarray([0.2470, 0.2435, 0.2616], np.float32)


class CIFAR10:
    def __init__(self, root: str, train: bool = True):
        files = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        data, labels = [], []
        for fn in files:
            with open(osp.join(root, fn), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            data.append(batch[b"data"])
            labels.extend(batch[b"labels"])
        self.images = (
            np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        )
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        img = self.images[idx].astype(np.float32) / 255.0
        img = (img - CIFAR10_MEAN) / CIFAR10_STD
        return img, int(self.labels[idx])

    def batches(self, batch_size: int, rng=None):
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[s:s + batch_size]
            imgs = np.stack([self[int(i)][0] for i in idx])
            labels = self.labels[idx]
            yield imgs, labels


def write_synthetic_batches(root: str, per_file: int = 1000, seed: int = 0):
    """Write CIFAR-10 batch files in the python-version pickle format
    (``data_batch_1`` .. ``data_batch_5`` and ``test_batch``, each
    ``per_file`` 32 x 32 images) under ``root``: a learnable stand-in for
    the real set, which is not in the repository. Each class has its own
    colour and stripe pattern, under pixel noise."""
    import os

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:32, 0:32]
    patterns = []
    for c in range(10):
        colour = rng.uniform(40, 215, 3)
        stripes = np.sin((xx * np.cos(c * 0.6) + yy * np.sin(c * 0.6)) * (0.3 + 0.05 * c))
        patterns.append(colour[:, None, None] + 40.0 * stripes[None])
    os.makedirs(root, exist_ok=True)
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.randint(0, 10, per_file)
        images = np.stack([patterns[c] for c in labels]) + rng.normal(0, 25, (per_file, 3, 32, 32))
        data = np.clip(images, 0, 255).astype(np.uint8).reshape(per_file, 3072)
        with open(osp.join(root, fn), "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)
