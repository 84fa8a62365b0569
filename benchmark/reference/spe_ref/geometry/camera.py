"""SPEED camera model and Tango world-point constants (counterpart of
geometry/camera.py).

fx = fy = 0.0176 m, pixel pitch 5.86e-6 m/px, 1920x1200 sensor, zero
distortion. The world points are read from a copy of the repository's
``assets/tango_world_points.json`` beside this file.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


class Camera:
    """SPEED dataset camera intrinsics (static constants)."""

    fx = 0.0176  # focal length [m]
    fy = 0.0176
    nu = 1920  # horizontal pixels
    nv = 1200  # vertical pixels
    ppx = 5.86e-6  # pixel pitch [m/px]
    ppy = ppx
    fpx = fx / ppx  # focal length [px] ~= 3003.41
    fpy = fy / ppy

    K = np.array(
        [
            [fpx, 0.0, nu / 2],
            [0.0, fpy, nv / 2],
            [0.0, 0.0, 1.0],
        ]
    )

    @classmethod
    def K_torch(cls, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.as_tensor(cls.K, dtype=dtype, device=device)


_ASSET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tango_world_points.json")


def load_world_points(path: str | None = None) -> np.ndarray:
    """Load the 11 Tango landmark body-frame positions [m], shape (11, 3)."""
    with open(path or _ASSET_PATH, "r") as f:
        data = json.load(f)
    return np.asarray(data["world_points"], dtype=np.float64)


WORLD_POINTS = load_world_points()
NUM_KEYPOINTS = WORLD_POINTS.shape[0]  # 11
