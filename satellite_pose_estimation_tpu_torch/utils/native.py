"""ctypes bindings for the native geometry reference library (counterpart of
utils/native.py; the same functions and signatures).

The C++ library (native/src/geometry_ref.cc) provides float64 host
reference implementations of the weighted-Huber LM PnP (Ceres equivalent)
and the exact LSAP, an oracle for the port's device solvers on a machine
without the JAX package. It is built from that source with ``g++`` (the
flags of native/build.sh) into ``build/native/`` at first use, named by a
hash of the source and flags, so an edited source is rebuilt; the
``native/libgeometry_ref.so`` committed beside the source is not loaded. A
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .cuda_build import PACKAGE_DIR, compile_once

SOURCE = PACKAGE_DIR.parent / "native" / "src" / "geometry_ref.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-shared")
_lib = None


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgeometry_ref-{digest.hexdigest()[:16]}.so"


def _load():
    global _lib
    if _lib is None:
        out = library_path()
        if not out.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found on PATH; it builds the native geometry library")
            compile_once(out, [cxx, *CXX_FLAGS, str(SOURCE)])
        lib = ctypes.CDLL(str(out))
        lib.gn_pnp_refine.restype = ctypes.c_double
        lib.gn_pnp_refine.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.lsap.restype = ctypes.c_double
        lib.lsap.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built or can be: it exists, or g++ is on PATH."""
    return library_path().exists() or shutil.which("g++") is not None


def gn_pnp_refine(
    world: np.ndarray,
    obs_norm: np.ndarray,
    rvec0: np.ndarray,
    tvec0: np.ndarray,
    weights: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    huber_delta: float = 0.0,
    iters: int = 20,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """LM refine of one pose from (rvec0, tvec0) on the (n, 3) world points
    and their (n, 2) normalised observations, with per-axis ``weights`` (n,
    2), a point ``mask`` (n,) and Huber ``huber_delta`` (0: none). Returns
    (rvec, tvec, final cost)."""
    lib = _load()
    n = world.shape[0]
    world = np.ascontiguousarray(world, np.float64)
    obs = np.ascontiguousarray(obs_norm, np.float64)
    w = np.ascontiguousarray(
        weights if weights is not None else np.ones((n, 2)), np.float64
    )
    m = np.ascontiguousarray(
        mask if mask is not None else np.ones(n), np.uint8
    )
    rt = np.concatenate(
        [np.asarray(rvec0, np.float64).ravel(),
         np.asarray(tvec0, np.float64).ravel()]
    ).copy()
    if (world.shape != (n, 3) or obs.shape != (n, 2) or w.shape != (n, 2) or m.shape != (n,)
            or rt.shape != (6,)):
        raise ValueError(f"gn_pnp_refine: shapes {world.shape} {obs.shape} {w.shape} {m.shape} "
                         f"{rt.shape} do not describe one pose of {n} points")
    c = lib.gn_pnp_refine(
        world.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        obs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n,
        float(huber_delta),
        int(iters),
        rt.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return rt[:3], rt[3:], float(c)


def lsap(cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """cost (rows, cols) with rows <= cols; returns (col4row, total)."""
    lib = _load()
    cost = np.ascontiguousarray(cost, np.float64)
    rows, cols = cost.shape
    if rows > cols:
        raise ValueError(f"lsap takes rows <= cols, got {cost.shape}")
    out = np.zeros(rows, np.int32)
    total = lib.lsap(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows,
        cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out, float(total)
