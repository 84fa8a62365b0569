"""PyTorch port, the detection task's host data against the JAX package:
every registered transform (and the det recipe's whole pipeline) under one
``np.random.RandomState`` gives the same samples exactly, ``CocoEvaluator``
equals JAX's on the golden, fuzz and segm cases of tests/test_coco_eval.py
(1e-12), and the synthetic COCO renderer, ``CocoDetection``, the solver's
image preparation and its padded collation equal JAX's."""
import pathlib
import types

import numpy as np
import pytest
import yaml

from satellite_pose_estimation_tpu.data import coco as jcoco
from satellite_pose_estimation_tpu.data import transforms as jtf
from satellite_pose_estimation_tpu.tools import synthetic_det_selfcheck as jselfcheck
from satellite_pose_estimation_tpu.train import det_solver as jds
from satellite_pose_estimation_tpu_torch.data import coco, transforms
from satellite_pose_estimation_tpu_torch.tools import synthetic_det_selfcheck as selfcheck
from satellite_pose_estimation_tpu_torch.train import det_solver as ds

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECIPE_OPS = yaml.safe_load((ROOT / "configs/det/include/dataloader.yml").read_text())[
    "train_dataloader"]["dataset"]["transforms"]["ops"]


def _samples(seed, n=6):
    """Images of a few sizes with 0-4 normalised cxcywh boxes, labels and
    landmarks."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        H, W = rng.randint(40, 90), rng.randint(40, 90)
        k = i % 5
        c = rng.uniform(0.2, 0.8, (k, 2))
        wh = rng.uniform(0.05, 0.5, (k, 2))
        out.append({"image": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
                    "boxes": np.concatenate([c, wh], 1).astype(np.float32),
                    "labels": rng.randint(0, 80, k).astype(np.int32),
                    "landmarks": rng.uniform(0, 40, (3, 2))})
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


OPS = [
    [{"type": "RandomPhotometricDistort", "p": 1.0}],
    [{"type": "RandomPhotometricDistort", "p": 0.5}],
    [{"type": "RandomZoomOut", "fill": 0}],
    [{"type": "RandomIoUCrop", "p": 1.0}],
    [{"type": "SanitizeBoundingBox", "min_size": 8}],
    [{"type": "RandomHorizontalFlip"}],
    [{"type": "Resize", "size": [64, 48]}],
    [{"type": "ConvertBox", "out_fmt": "xyxy", "normalize": True}],
    [{"type": "ConvertBox", "out_fmt": "cxcywh", "normalize": True}],
    [{"type": "Normalize"}],
    [{"type": "Pad", "size": 72}],
    [{"type": "RandomCrop", "size": 64}],
    [{"type": "PadToSize", "spatial_size": 96, "fill": 3}],
    [{"type": "EmptyTransform"}, {"type": "ToImageTensor"}, {"type": "ConvertDtype"}],
    RECIPE_OPS,
]


@pytest.mark.parametrize("ops", OPS, ids=[" + ".join(o["type"] for o in ops)[:40]
                                          for ops in OPS[:-1]] + ["det_recipe"])
def test_transforms_equal_jax_under_one_random_state(ops):
    """Each pipeline draws from one RandomState in JAX's order: every
    sample's image, boxes, labels and landmarks equal JAX's exactly."""
    seed = 7
    jpipe = jtf.Compose.from_config(ops, rng=np.random.RandomState(seed))
    tpipe = transforms.Compose.from_config(ops, rng=np.random.RandomState(seed))
    for a, b in zip(_samples(seed), _samples(seed)):
        _assert_same(tpipe(a), jpipe(b))


def test_registry_names_equal_jax():
    assert set(transforms.TRANSFORMS) == set(jtf.TRANSFORMS)
    assert ds._SOLVER_OWNED_OPS == jds._SOLVER_OWNED_OPS


# -- the evaluator -----------------------------------------------------------------

def _fuzz_images(seed, n=6):
    """The fuzz fixtures of tests/test_coco_eval.py: jittered copies of GT
    boxes (mid IoUs) and random false positives over 3 categories."""
    rng = np.random.RandomState(seed)
    images = []
    for _ in range(n):
        n_g, n_d = rng.randint(0, 5), rng.randint(0, 8)
        g_b = [list(np.r_[xy, xy + rng.uniform(5, 40, 2)])
               for xy in (rng.uniform(0, 80, 2) for _ in range(n_g))]
        d_b = []
        for _ in range(n_d):
            if n_g and rng.rand() < 0.6:
                bx = np.asarray(g_b[rng.randint(n_g)]) + rng.uniform(-6, 6, 4)
                bx[2], bx[3] = max(bx[2], bx[0] + 1), max(bx[3], bx[1] + 1)
            else:
                xy = rng.uniform(0, 80, 2)
                bx = np.r_[xy, xy + rng.uniform(5, 40, 2)]
            d_b.append(bx)
        images.append((np.asarray(g_b, np.float64).reshape(-1, 4), rng.randint(0, 3, n_g),
                       np.asarray(d_b, np.float64).reshape(-1, 4), rng.randint(0, 3, n_d),
                       rng.rand(n_d)))
    return images


def _masks(boxes, size=128):
    m = np.zeros((len(boxes), size, size), bool)
    for i, (x1, y1, x2, y2) in enumerate(np.clip(np.asarray(boxes, int), 0, size)):
        m[i, y1:y2, x1:x2] = True
    return m


@pytest.mark.parametrize("case", ["golden", "fuzz_0", "fuzz_1", "fuzz_2", "segm"])
def test_coco_evaluator_equals_jax(case):
    """The hand-derived golden, the fuzz fixtures and a segm run: every
    stat of ``summarize()`` equal to JAX's to 1e-12, with the same keys."""
    iou_type = "segm" if case == "segm" else "bbox"
    ev, jev = coco.CocoEvaluator(iou_type), jcoco.CocoEvaluator(iou_type)
    if case == "golden":
        images = [(np.float64([[0, 0, 10, 10], [20, 20, 30, 30]]), [1, 1],
                   np.float64([[0, 0, 10, 10], [20, 20, 30, 28.2], [50, 50, 60, 60]]),
                   [1, 1, 1], [0.9, 0.8, 0.7])]
    else:
        images = _fuzz_images(4 + int(case[-1]) if case != "segm" else 11)
    for g, gl, d, dl, s in images:
        if iou_type == "segm":
            for e in (ev, jev):
                e.update(None, gl, None, dl, s, gt_masks=_masks(g), det_masks=_masks(d))
        else:
            ev.update(g, gl, d, dl, s)
            jev.update(g, gl, d, dl, s)
    got, want = ev.summarize(), jev.summarize()
    assert set(got) == set(want) == {"AP", "AP50", "AP75", "AR1", "AR10", "AR100"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    if case == "golden":
        np.testing.assert_allclose(got["AP"], (7 + 3 * 51 / 101) / 10, rtol=1e-12)
    with pytest.raises(ValueError, match="keypoints"):
        coco.CocoEvaluator("keypoints")


# -- the dataset, the renderer and the solver's collation ---------------------------

@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The same synthetic COCO set rendered by both packages."""
    root = tmp_path_factory.mktemp("synth_det")
    selfcheck.render_dataset(str(root / "port"), 10, seed=3, img_size=64)
    jselfcheck.render_dataset(str(root / "jax"), 10, seed=3, img_size=64)
    return root


def test_render_and_coco_detection_equal_jax(rendered):
    """The renderer writes JAX's files byte for byte, and CocoDetection (with
    and without the mscoco remap) gives JAX's samples."""
    for rel in ("annotations/instances_train2017.json", "train2017/train2017_00003.jpg",
                "val2017/val2017_00007.jpg"):
        assert (rendered / "port" / rel).read_bytes() == (rendered / "jax" / rel).read_bytes()
    for remap in (False, True):
        args = (str(rendered / "port/train2017"),
                str(rendered / "port/annotations/instances_train2017.json"), remap)
        ds_, jds_ = coco.CocoDetection(*args), jcoco.CocoDetection(*args)
        assert len(ds_) == len(jds_) == 10
        for i in range(len(ds_)):
            _assert_same(ds_[i], jds_[i])


def test_prep_image_and_collate_equal_jax(rendered):
    """``_prep_image`` (PIL bilinear resize, ImageNet normalisation) and the
    solver's collation (the recipe's transforms, targets padded to
    ``max_targets`` with -1) equal JAX's."""
    data = coco.CocoDetection(str(rendered / "port/train2017"),
                              str(rendered / "port/annotations/instances_train2017.json"))
    samples = [data[i] for i in range(4)]
    for size in (48, 80):
        np.testing.assert_array_equal(ds._prep_image(samples[0]["image"], size),
                                      jds._prep_image(samples[0]["image"], size))
    ops = [op for op in RECIPE_OPS if op["type"] not in ds._SOLVER_OWNED_OPS]
    host = types.SimpleNamespace(max_targets=3, resize=64)
    got = ds.DetSolver._collate(host, samples, transforms.Compose.from_config(
        ops, rng=np.random.RandomState(2)), 56)
    want = jds.DetSolver._collate(host, samples, jtf.Compose.from_config(
        ops, rng=np.random.RandomState(2)), 56)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (4, 56, 56, 3) and (got[1] == -1).any()
