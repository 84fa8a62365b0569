"""PyTorch port, utils/profiling.py on the CPU (the trace file, a span's
time, no card's memory) and utils/native.py: the library built with
g++ from native/src/geometry_ref.cc, its wrappers against the JAX
package's on the same inputs, and the port's float64 ``hungarian`` and
``huber_weighted_pnp`` against it, as tests/test_native_oracle.py holds
the JAX kernels."""
import time

import cv2
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.utils import native as jax_native
from satellite_pose_estimation_tpu_torch.geometry import Camera, WORLD_POINTS, rodrigues
from satellite_pose_estimation_tpu_torch.geometry.projection import normalize_points
from satellite_pose_estimation_tpu_torch.geometry.refine import huber_weighted_pnp
from satellite_pose_estimation_tpu_torch.ops.hungarian import hungarian
from satellite_pose_estimation_tpu_torch.utils import native, profiling

from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)


# -- profiling ----------------------------------------------------------------

def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as where:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert where == str(logdir)
    (trace,) = logdir.glob("*.pt.trace.json")
    assert "aten::mm" in trace.read_text()


def test_device_timer_meter_and_memory_stats_on_the_cpu():
    """The span recorder took the timer's and the meter's place (both are
    gone): a span inside ``record_spans()`` times its block a step."""
    assert not hasattr(profiling, "device_timer") and not hasattr(profiling, "ThroughputMeter")
    profiling.reset_spans()
    try:
        with profiling.record_spans(), profiling.span("mm"):
            torch.ones(8, 8) @ torch.ones(8, 8)
            time.sleep(0.01)
        (mm,) = profiling.span_summary()["spans"].values()
        assert mm["ms_per_step"] >= 10.0 and mm["calls_per_step"] == 1.0
    finally:
        profiling.reset_spans()
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


# -- native ---------------------------------------------------------------------

def test_native_builds_from_the_source_with_gpp():
    assert native.available()
    native._load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.resolve() != (native.SOURCE.parents[1] / "libgeometry_ref.so").resolve()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.lsap(np.ones((2, 3)))
    assert not any((tmp_path / "build").glob("*.so"))


def test_native_wrappers_equal_jax_wrappers(rng):
    """The port's library (built here) and JAX's (native/build.sh's) on the
    same inputs: the same assignments and totals, the same refined poses."""
    for _ in range(5):
        cost = rng.rand(7, 12)
        col, total = native.lsap(cost)
        jcol, jtotal = jax_native.lsap(cost)
        np.testing.assert_array_equal(col, jcol)
        assert total == pytest.approx(jtotal, rel=1e-12)
    world = WORLD_POINTS.astype(np.float64)
    obs = rng.randn(11, 2) * 0.05
    w, m = rng.rand(11, 2) + 0.5, rng.rand(11) > 0.2
    r0, t0 = rng.randn(3) * 0.3, np.array([0.1, 0.0, 9.0])
    for delta in (0.0, 0.005):
        got = native.gn_pnp_refine(world, obs, r0, t0, w, m, delta, 25)
        ref = jax_native.gn_pnp_refine(world, obs, r0, t0, w, m, delta, 25)
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        assert got[2] == pytest.approx(ref[2], rel=1e-12)
    with pytest.raises(ValueError):
        native.lsap(np.ones((3, 2)))
    with pytest.raises(ValueError):
        native.gn_pnp_refine(world, obs[:5], r0, t0)


def test_native_lsap_matches_the_ports_hungarian(rng):
    costs = rng.rand(10, 30, 11)
    q4t = hungarian(torch.from_numpy(costs)).numpy()  # (10, 11) float64, batched
    for cost, q in zip(costs, q4t):
        total_dev = cost[q, np.arange(11)].sum()
        _, total_nat = native.lsap(cost.T)  # rows <= cols
        np.testing.assert_allclose(total_dev, total_nat, rtol=1e-5)


def test_native_gn_matches_the_ports_weighted_huber_refine(rng):
    """As tests/test_native_oracle.py::test_native_gn_matches_device_weighted:
    noisy projections (OpenCV) and per-point sigmas, the port's float64
    refine (30 iterations) against the oracle's (60): 2e-3 rad, 2%."""
    world = WORLD_POINTS.astype(np.float64)
    K = torch.from_numpy(Camera.K)
    for _ in range(5):
        rvec = rng.randn(3) * 0.6
        tvec = np.array([0.1, -0.1, rng.uniform(8, 20)])
        img, _ = cv2.projectPoints(world, rvec, tvec, Camera.K, np.zeros(5))
        img = img.reshape(-1, 2) + rng.randn(11, 2) * 2.0
        sigma = np.abs(rng.rand(11, 2)) * 3 + 0.5
        rv_d, tv_d = huber_weighted_pnp(
            torch.from_numpy(world), torch.from_numpy(img)[None], K,
            torch.from_numpy(sigma)[None], torch.from_numpy(rvec + 0.02)[None],
            torch.from_numpy(tvec + 0.1)[None], torch.ones(1, 11, dtype=torch.bool),
            huber_delta=0.005, iters=30)
        w1 = 1.0 / (np.sqrt(sigma) + 1e-6)
        w = w1 / w1.sum(0, keepdims=True)
        obs = normalize_points(torch.from_numpy(img), K).numpy()
        rv_n, tv_n, _ = native.gn_pnp_refine(world, obs, rvec + 0.02, tvec + 0.1, weights=w,
                                             huber_delta=0.005, iters=60)
        R_d = rodrigues(rv_d[0]).numpy()
        R_n = rodrigues(torch.from_numpy(rv_n)).numpy()
        ang = np.arccos(np.clip((np.trace(R_d @ R_n.T) - 1) / 2, -1, 1))
        assert ang < 2e-3, f"angle between the port and the oracle {ang}"
        np.testing.assert_allclose(tv_d[0].numpy(), tv_n, rtol=0.02, atol=0.02)
