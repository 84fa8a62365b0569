"""COCO detection data and evaluation without pycocotools (counterpart of
data/coco.py, a copy of its numpy code): ``CocoDetection`` parses a
COCO-instances file (with the optional mscoco category remap) and decodes
its images with PIL through the port's decoded-frame cache
(``data.dataset``), and ``CocoEvaluator`` is the COCO protocol's AP@[.5:.95],
AP50, AP75 and AR@{1,10,100} over bbox or segm IoUs (greedy score-order
matching per image and category, 101-point step interpolation, as
pycocotools' COCOeval).
"""
from __future__ import annotations

import json
import os.path as osp
from collections import defaultdict
from typing import Dict

import numpy as np

# classic 80-category mscoco id remap (sparse ids -> contiguous)
MSCOCO_CATEGORY_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]
MSCOCO2LABEL = {cid: i for i, cid in enumerate(MSCOCO_CATEGORY_IDS)}


class CocoDetection:
    """Minimal COCO-instances dataset: decoded images and normalised cxcywh
    box targets. Images come back at the size the transform pipeline leaves
    them (the original size without a Resize op); the solver makes the
    final fixed-size resize (train/det_solver._prep_image)."""

    def __init__(self, img_dir: str, ann_file: str,
                 remap_mscoco_category: bool = False):
        self.img_dir = img_dir
        self.remap = remap_mscoco_category
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.img_ids = sorted(self.images)
        self.anns_by_img: Dict[int, list] = defaultdict(list)
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_img[ann["image_id"]].append(ann)
        self.categories = coco.get("categories", [])
        # Repeat-epoch decoded-frame RAM cache, same policy as the SPEED
        # datasets (data/dataset._decode_cache_budget): first `budget`
        # distinct frames are cached, frozen read-only so an in-place
        # mutation by a consumer raises instead of corrupting the cache.
        from .dataset import _cache_insert, _decode_cache_budget

        self._cache_insert = _cache_insert
        self._decode_budget = _decode_cache_budget()
        self._decode_cache = {} if self._decode_budget > 0 else None

    def __len__(self):
        return len(self.img_ids)

    def _decode_cached(self, path: str) -> np.ndarray:
        from PIL import Image

        if self._decode_cache is not None:
            img = self._decode_cache.get(path)
            if img is not None:
                return img
        img = np.asarray(Image.open(path).convert("RGB"))
        self._cache_insert(self._decode_cache, path, img, self._decode_budget)
        return img

    def __getitem__(self, idx: int) -> dict:
        img_id = self.img_ids[idx]
        info = self.images[img_id]
        img = self._decode_cached(osp.join(self.img_dir, info["file_name"]))
        H, W = img.shape[:2]
        boxes, labels = [], []
        for ann in self.anns_by_img[img_id]:
            x, y, w, h = ann["bbox"]
            cat = ann["category_id"]
            if self.remap:
                cat = MSCOCO2LABEL.get(cat, 0)
            boxes.append([x, y, x + w, y + h])
            labels.append(cat)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        # normalized cxcywh
        if len(boxes):
            cxcywh = np.stack(
                [
                    (boxes[:, 0] + boxes[:, 2]) / 2 / W,
                    (boxes[:, 1] + boxes[:, 3]) / 2 / H,
                    (boxes[:, 2] - boxes[:, 0]) / W,
                    (boxes[:, 3] - boxes[:, 1]) / H,
                ],
                axis=1,
            )
        else:
            cxcywh = boxes
        return {
            "image_id": img_id,
            "image": img,
            "orig_size": np.asarray([W, H]),
            "boxes": cxcywh,
            "labels": np.asarray(labels, np.int32),
        }


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """xyxy IoU (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _mask_iou_matrix(a, b) -> np.ndarray:
    """Binary-mask IoU (N, M): a (N, H, W), b (M, H, W) bool. The segm
    iou-type's IoU definition (pycocotools maskUtils.iou on decoded masks;
    R2/src/data/coco/coco_eval.py iou_types)."""
    a = np.asarray(a, bool).reshape(len(a), -1)
    b = np.asarray(b, bool).reshape(len(b), -1)
    inter = (a[:, None, :] & b[None, :, :]).sum(-1).astype(np.float64)
    union = (a[:, None, :] | b[None, :, :]).sum(-1).astype(np.float64)
    return inter / np.maximum(union, 1e-9)


class CocoEvaluator:
    """COCO-protocol AP over bbox or segm iou-types. update() with
    per-image detections and GT; summarize() returns {AP, AP50, AP75}.

    ``iou_type``: "bbox" (xyxy box IoU) or "segm" (binary-mask IoU via
    ``update(..., gt_masks=, det_masks=)``) — the two iou_types the
    reference's CocoEvaluator wraps (R2/src/data/coco/coco_eval.py:18-24;
    its "keypoints" type is never built by any config and raises here).
    The reference's cross-rank merge (coco_eval.py:26-278) has no
    counterpart: the port evaluates on one device, in one process."""

    # pycocotools p.iouThrs = np.linspace(.5, .95, 10) — NOT arange, whose
    # accumulated float error can flip an exact-tie IoU>=t comparison
    # (R2/src/data/coco/coco_eval.py drives pycocotools' Params defaults)
    IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
    RECALL_POINTS = np.linspace(0, 1, 101)
    MAX_DETS = 100  # p.maxDets[-1]: per-image-per-category detection cap

    def __init__(self, iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(
                f"unsupported iou_type {iou_type!r}: this evaluator "
                "implements bbox and segm (the reference never builds "
                "its keypoints type)")
        self.iou_type = iou_type
        # per category: list of (score, matched[t]) and gt counts
        self.dets = defaultdict(list)  # cat -> [(score, match_mask (T,))]
        self.n_gt = defaultdict(int)

    def update(self, gt_boxes, gt_labels, det_boxes, det_labels, det_scores,
               gt_masks=None, det_masks=None):
        """One image. Boxes xyxy pixel coords; for iou_type="segm" pass
        gt_masks (G, H, W) and det_masks (D, H, W) binary masks (boxes may
        then be None)."""
        if self.iou_type == "segm":
            if gt_masks is None or det_masks is None:
                raise ValueError("segm iou_type requires gt_masks/det_masks")
            gt_items = np.asarray(gt_masks, bool)
            det_items = np.asarray(det_masks, bool)
            iou_fn = _mask_iou_matrix
        else:
            gt_items = np.asarray(gt_boxes).reshape(-1, 4)
            det_items = np.asarray(det_boxes).reshape(-1, 4)
            iou_fn = _iou_matrix
        gt_labels = np.asarray(gt_labels).astype(int)
        det_labels = np.asarray(det_labels).astype(int)
        det_scores = np.asarray(det_scores)

        for cat in set(gt_labels.tolist()) | set(det_labels.tolist()):
            g = gt_items[gt_labels == cat]
            d_idx = np.where(det_labels == cat)[0]
            d = det_items[d_idx]
            s = det_scores[d_idx]
            order = np.argsort(-s, kind="stable")
            d, s = d[order][: self.MAX_DETS], s[order][: self.MAX_DETS]
            self.n_gt[cat] += len(g)
            if len(d) == 0:
                continue
            iou = iou_fn(d, g) if len(g) else np.zeros((len(d), 0))
            T = len(self.IOU_THRESHOLDS)
            taken = np.zeros((T, len(g)), bool)
            for di in range(len(d)):
                match = np.zeros(T, bool)
                for ti, th in enumerate(self.IOU_THRESHOLDS):
                    best, best_iou = -1, th
                    for gi in range(len(g)):
                        if taken[ti, gi]:
                            continue
                        if iou[di, gi] >= best_iou:
                            best, best_iou = gi, iou[di, gi]
                    if best >= 0:
                        taken[ti, best] = True
                        match[ti] = True
                # di is the per-image per-category score rank: greedy
                # score-order matching means the matches of the first k
                # dets ARE the matches of a k-capped run, so AR@k slices
                # by rank (pycocotools accumulate() slices dtMatches the
                # same way)
                self.dets[cat].append((float(s[di]), match, di))

    def _ap_per_cat(self, cat) -> np.ndarray:
        entries = sorted(self.dets[cat], key=lambda e: -e[0])
        n_gt = self.n_gt[cat]
        T = len(self.IOU_THRESHOLDS)
        if n_gt == 0:
            return np.full(T, np.nan)
        if not entries:
            return np.zeros(T)
        matches = np.stack([m for _, m, _ in entries])  # (D, T)
        tp = np.cumsum(matches, axis=0)
        fp = np.cumsum(~matches, axis=0)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        ap = np.zeros(T)
        for ti in range(T):
            p = precision[:, ti]
            r = recall[:, ti]
            # pycocotools accumulate(): monotone precision envelope, then a
            # STEP lookup — precision at the first detection whose recall
            # reaches each of the 101 recall points (searchsorted left),
            # zero past the achieved recall. NOT linear interpolation
            # (cocoeval.py accumulate: inds = searchsorted(rc, recThrs,
            # side='left'); q[ri] = pr[pi]).
            p_env = np.maximum.accumulate(p[::-1])[::-1]
            inds = np.searchsorted(r, self.RECALL_POINTS, side="left")
            q = np.where(inds < len(p_env),
                         p_env[np.minimum(inds, len(p_env) - 1)], 0.0)
            ap[ti] = float(np.mean(q))
        return ap

    def _ar_per_cat(self, cat, k) -> float:
        """Final recall with per-image detections capped at k, averaged
        over the IoU thresholds (pycocotools accumulate(): recall[t] is
        tp/npig after ALL top-k dets — det order is irrelevant to the
        final count)."""
        n_gt = self.n_gt[cat]
        if n_gt == 0:
            return np.nan
        T = len(self.IOU_THRESHOLDS)
        tp = np.zeros(T)
        for _, match, rank in self.dets[cat]:
            if rank < k:
                tp += match
        return float(np.mean(tp / n_gt))

    def summarize(self) -> dict:
        cats = sorted(set(self.n_gt) | set(self.dets))
        aps = np.stack([self._ap_per_cat(c) for c in cats]) if cats else \
            np.zeros((1, len(self.IOU_THRESHOLDS)))
        mean_ap = np.nanmean(aps, axis=0)
        stats = {
            "AP": float(np.nanmean(mean_ap)),
            "AP50": float(mean_ap[0]),
            "AP75": float(mean_ap[5]),
        }
        # AR@{1,10,100}: the reference CocoEvaluator's pycocotools stats
        # row carries these (cocoeval summarize() rows 6-8); area-range
        # variants (APs/m/l, ARs/m/l) are not computed — SPEED-task
        # objects are single-instance and the det selfcheck uses one
        # scale, so every object falls in areaRng 'all'.
        for k in (1, 10, 100):
            ars = [self._ar_per_cat(c, k) for c in cats]
            stats[f"AR{k}"] = float(np.nanmean(ars)) if cats else 0.0
        print(
            "COCO bbox eval: AP {AP:.4f} | AP50 {AP50:.4f} | "
            "AP75 {AP75:.4f} | AR@1 {AR1:.4f} | AR@10 {AR10:.4f} | "
            "AR@100 {AR100:.4f}".format(**stats)
        )
        return stats
