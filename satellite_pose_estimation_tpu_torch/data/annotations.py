"""SPEED annotation parsing (counterpart of data/annotations.py) — exact formats of the reference's checked-in
assets (R1/annos/*, SURVEY.md section 2.1 #20).

* Train annotation JSON (wz_train.json): a list; each item has
  filename, landmarks (11x2 pixel coords), bbox_xxyy, q_vbs2tango,
  r_Vo2To_vbs_true. Index .txt files select integer rows into that list
  (R1/datasets/speed.py:200-207).
* Ground-truth JSON (train.json): list of {filename, q_vbs2tango,
  r_Vo2To_vbs_true} (+ bbox_xxyy in R2's copy).
* Detector-box JSON (wz_real_test.json / wz_synt_test.json):
  {filename: [[x1, y1, x2, y2, score], ...]} — first box used
  (R1/datasets/speed.py:59-82).
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


def load_train_annotations(ann_path: str, index_path: str | None = None) -> List[dict]:
    """Load the train annotation list, optionally row-indexed by a split file."""
    with open(ann_path, "r") as f:
        anns = json.load(f)
    if index_path is None:
        return anns
    idx = np.loadtxt(index_path, dtype=int)
    return [anns[int(i)] for i in np.atleast_1d(idx).tolist()]


def load_index_file(path: str) -> np.ndarray:
    return np.atleast_1d(np.loadtxt(path, dtype=int))


def load_detector_boxes(path: str) -> List[dict]:
    """Detector output JSON -> [{'filename', 'bbox_xxyy'}] (first box only,
    matching SpeedSubmission.load_anns R1/datasets/speed.py:59-82)."""
    with open(path, "r") as f:
        anns = json.load(f)
    return [
        {"filename": fn, "bbox_xxyy": boxes[0][:4]} for fn, boxes in anns.items()
    ]


def load_ground_truth(path: str) -> Dict[str, dict]:
    """train.json -> {filename: {'quat', 'tvec'[, 'bbox_xxyy']}}."""
    with open(path, "r") as f:
        items = json.load(f)
    out = {}
    for item in items:
        entry = {
            "quat": np.asarray(item["q_vbs2tango"], np.float64),
            "tvec": np.asarray(item["r_Vo2To_vbs_true"], np.float64),
        }
        if "bbox_xxyy" in item:
            entry["bbox_xxyy"] = np.asarray(item["bbox_xxyy"], np.float64)
        out[item["filename"]] = entry
    return out
