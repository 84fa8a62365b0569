"""SPEED camera model and Tango world-point constants (counterpart of
geometry/camera.py).

fx = fy = 0.0176 m, pixel pitch 5.86e-6 m/px, 1920x1200 sensor, zero
distortion. The world points are read from the repository's
``assets/tango_world_points.json``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.constants import device_constant


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
        """K on ``device`` in ``dtype``, built once and shared (read only)."""
        return device_constant("camera.K", lambda: cls.K, device, dtype)


_ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "tango_world_points.json",
)


def load_world_points(path: str | None = None) -> np.ndarray:
    """Load the 11 Tango landmark body-frame positions [m], shape (11, 3)."""
    with open(path or _ASSET_PATH, "r") as f:
        data = json.load(f)
    return np.asarray(data["world_points"], dtype=np.float64)


WORLD_POINTS = load_world_points()
NUM_KEYPOINTS = WORLD_POINTS.shape[0]  # 11


def world_points(device=None, dtype=torch.float32) -> torch.Tensor:
    """``WORLD_POINTS`` on ``device`` in ``dtype``, built once and shared
    (read only)."""
    return device_constant("camera.world_points", lambda: WORLD_POINTS, device, dtype)
