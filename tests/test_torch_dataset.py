"""The port's host pipeline against the JAX package's: ``pack_crop``, the
SPEED train / val / submission datasets' batches over two epochs (both
caches on and off, ``pad_last``), all bit for bit on the same rendered
files (JPEG and binary PPM); the prefetch's error and shutdown contract;
and the evaluator's summaries and per-image log, equal to JAX's on the same
results."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.data import dataset as jds
from satellite_pose_estimation_tpu.train.evaluator import SpeedEvaluator as JaxEvaluator
from satellite_pose_estimation_tpu_torch.data import dataset as pds
from satellite_pose_estimation_tpu_torch.data.prefetch import prefetch_to_device
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
from satellite_pose_estimation_tpu_torch.train.evaluator import SpeedEvaluator

N_IMAGES, N_TRAIN = 8, 5


@pytest.fixture(scope="module", params=["jpg", "ppm"])
def speed_root(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"speed_{request.param}")
    info = render_dataset(str(root), N_IMAGES, seed=3, n_train=N_TRAIN, fmt=request.param)
    assert info["fmt"] == request.param
    return str(root)


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            if k == "filename":
                assert list(a[k]) == list(b[k])
            elif k == "pad":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pack_crop_matches_jax():
    """Boxes inside, across the edge and larger than the buffer
    (power-of-two decimation), bit for bit."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (300, 420, 3)).astype(np.uint8)
    boxes = [[10.3, 20.7, 110.2, 121.9], [-15.0, -4.5, 60.0, 80.0], [300.0, 200.0, 460.0, 330.0],
             [0.0, 0.0, 420.0, 300.0], [5.5, 7.25, 390.75, 280.5]]
    for box in boxes:
        for pack in (64, 128, 512):
            got = pds.pack_crop(img, np.asarray(box), pack)
            ref = jds.pack_crop(img, np.asarray(box), pack)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("caches", ["on", "off"])
def test_train_and_val_batches_match_jax_over_two_epochs(speed_root, caches, monkeypatch):
    """The shuffled train split (drop_last) and the val split (pad_last) of
    both packages over two epochs, bit for bit, with the decoded-frame and
    packed-sample caches on (default) and off; the prefetching loader
    equal to the synchronous one."""
    if caches == "off":
        monkeypatch.setenv("SPE_DECODE_CACHE", "0")
        monkeypatch.setenv("SPE_PACKED_CACHE", "0")
    kw = dict(ann_file="wz_train.json", img_dir="images/train", pack_size=256, seed=5)
    for split, train in (("train_1.txt", True), ("val_1.txt", False)):
        port = pds.SpeedTrainDataset(speed_root, index_file=split, train=train, **kw)
        ref = jds.SpeedTrainDataset(speed_root, index_file=split, train=train, **kw)
        assert (port._decode_cache is None) == (caches == "off")
        for epoch in range(2):
            args = dict(drop_last=train, pad_last=not train)
            got = list(port.batches(2, prefetch=2 if epoch else 0, **args))
            want = list(ref.batches(2, prefetch=0, **args))
            _assert_batches_equal(got, want)
            if not train:
                assert got[-1]["pad"] == (2 - (N_IMAGES - N_TRAIN) % 2) % 2


def test_resumed_dataset_repeats_the_uninterrupted_epoch(speed_root):
    """``advance_epochs(n)`` leaves the train split where n epochs of
    ``batches`` leave it: the next epoch's order and crops are the same."""
    kw = dict(index_file="train_1.txt", pack_size=256, seed=5)
    a, b = pds.SpeedTrainDataset(speed_root, **kw), pds.SpeedTrainDataset(speed_root, **kw)
    for _ in range(2):
        list(a.batches(2, prefetch=0))
    b.advance_epochs(2)
    _assert_batches_equal(list(b.batches(2, prefetch=0)), list(a.batches(2, prefetch=0)))


def test_submission_batches_match_jax(speed_root):
    for ann in ("wz_real_test.json", "wz_synt_test.json"):
        port = pds.SpeedSubmissionDataset(speed_root, ann, "images/train", pack_size=256)
        ref = jds.SpeedSubmissionDataset(speed_root, ann, "images/train", pack_size=256)
        got = list(port.batches(2, prefetch=2))
        _assert_batches_equal(got, list(ref.batches(2, prefetch=0)))
        assert sum(len(b["filename"]) - b["pad"] for b in got) == len(ref)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def _wait_gone(timeout=5.0):
    end = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < end:
        time.sleep(0.02)
    return not _prefetch_threads()


def test_prefetch_reraises_and_shuts_down():
    """On the CPU the prefetch yields the host arrays as tensors (shared,
    equal), passes names and pads through, re-raises a producer's exception
    at the consumer, and stops its producer when the consumer abandons the
    iterator with batches still queued."""
    batches = [{"x": np.full((2, 3), i, np.float32), "filename": ["a", "b"], "pad": i}
               for i in range(6)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 6
    for got, ref in zip(out, batches):
        assert isinstance(got["x"], torch.Tensor)
        np.testing.assert_array_equal(got["x"].numpy(), ref["x"])
        assert got["filename"] == ref["filename"] and got["pad"] == ref["pad"]
    assert _wait_gone()

    def failing():
        yield batches[0]
        raise OSError("frame unreadable")

    it = prefetch_to_device(failing(), size=2, device="cpu")
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)
    assert _wait_gone()

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.zeros(1, np.float32)}
            i += 1

    it = prefetch_to_device(endless(), size=2, device="cpu")
    next(it)
    it.close()  # abandoned with a full queue
    assert _wait_gone()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n  # the producer stopped


def _results(rng, n, with_gt):
    out = {
        "quat_pr": rng.randn(n, 4).astype(np.float32),
        "tvec_pr": rng.randn(n, 3).astype(np.float32),
        "valid": rng.rand(n) > 0.3,
        "points": rng.rand(n, 20, 2).astype(np.float32) * 1000,
        "probs": rng.rand(n, 20, 12).astype(np.float32),
        "sigmas": rng.rand(n, 20, 2).astype(np.float32),
        "aux_points_0": rng.randn(n, 20, 12).astype(np.float32),
    }
    if with_gt:
        out.update(score_tvec=rng.rand(n).astype(np.float32),
                   score_quat=rng.rand(n).astype(np.float32),
                   score=rng.rand(n).astype(np.float32),
                   quat_gt=rng.randn(n, 4).astype(np.float32),
                   tvec_gt=rng.randn(n, 3).astype(np.float32))
    return out


@pytest.mark.parametrize("with_gt", [True, False], ids=["scored", "no_ground_truth"])
def test_evaluator_matches_jax(with_gt, tmp_path):
    """The same padded batches of results through both evaluators:
    ``summarize``, ``scalar_summary`` and ``dump`` equal."""
    rng = np.random.RandomState(1)
    port, ref = SpeedEvaluator(), JaxEvaluator()
    for b, pad in enumerate((0, 0, 3)):
        names = [f"img{b}_{i}.jpg" for i in range(4)]
        res = _results(rng, 4, with_gt)
        port.update_batch(names, res, pad=pad)
        ref.update_batch(names, res, pad=pad)
    assert port.summarize() == ref.summarize()
    assert port.scalar_summary() == ref.scalar_summary()
    port.dump(str(tmp_path / "port.json"))
    ref.dump(str(tmp_path / "ref.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())
    assert len(port.log) == 9
