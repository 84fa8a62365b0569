"""PyTorch port, the solvers' CUDA graphs (utils/graphs.py) and the
constants they need (utils/constants.py).

On the CPU: CPU tensors run the solvers eagerly and the span recorder
counts no capture; the constant cache hands out one tensor per name,
device and dtype; nothing records while a stream is being captured; and
the graph runner's bookkeeping (eager, capture, replay, fresh outputs, the
key bound) with a stand-in for the card's graph. On the card (``cuda``):
each solver's replays equal its eager result bit for bit at B = 256 and
B = 20, leave earlier results alone, make no host sync, count one capture
per key, and the key bound evicts; the eval step's outputs, the score
included, replay bit for bit. The file imports no JAX; on the card:

    python -m pytest --noconftest -q tests/test_torch_solver_graphs.py
"""
import pytest
import torch

from satellite_pose_estimation_tpu_torch.geometry import solvers
from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera, world_points
from satellite_pose_estimation_tpu_torch.geometry.projection import project_points
from satellite_pose_estimation_tpu_torch.geometry.ransac import _all_triples
from satellite_pose_estimation_tpu_torch.geometry.rotations import quat_to_rotmat
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils import graphs, profiling
from satellite_pose_estimation_tpu_torch.utils.constants import device_constant

SOLVER_STAGES = ["solver.select", "solver.init", "solver.refine", "solver.finalize"]
EVAL_STAGES = ["eval.solver.prepare", "solver.select", "solver.init", "solver.refine",
               "solver.finalize", "eval.solver.score"]


@pytest.fixture(autouse=True)
def fresh():
    graphs.clear()
    profiling.reset_spans()
    yield
    graphs.clear()
    profiling.reset_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run on a card")
    return torch.device("cuda")


def _inputs(B, seed, Q=20):
    """A batch of solver inputs like a model's on lit targets: eleven
    queries near the projections of the landmarks (pixel noise, one far
    outlier an image), background queries elsewhere; queries 11-13 repeat
    queries 0-2 exactly (ties in the per-label selection); every 7th image
    all background and every 5th with three keypoints (invalid images).
    Returns (points, probs, sigmas, bbox_area) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    quat = torch.nn.functional.normalize(torch.randn(B, 4, generator=g), dim=-1)
    tvec = torch.stack([torch.rand(B, generator=g) - 0.5, torch.rand(B, generator=g) - 0.5,
                        5 + 20 * torch.rand(B, generator=g)], -1)
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    pix, _ = project_points(world, Camera.K_torch(), quat_to_rotmat(quat), tvec)
    points = torch.rand(B, Q, 2, generator=g) * torch.tensor([1920.0, 1200.0])
    points[:, :11] = pix + 2.0 * torch.randn(pix.shape, generator=g)
    points[:, 4] += 300.0
    logits = torch.randn(B, Q, 12, generator=g)
    logits[:, torch.arange(11), torch.arange(11)] += 6.0
    logits[:, 11:, 11] += 6.0
    points[:, 11:14], logits[:, 11:14] = points[:, 0:3], logits[:, 0:3]
    logits[::7, :, 11] += 20.0
    logits[1::5, 3:, 11] += 20.0
    sigmas = 0.5 + 3.5 * torch.rand(B, Q, 2, generator=g)
    area = 4e4 + 1e5 * torch.rand(B, generator=g)
    return points, torch.softmax(logits, -1), sigmas, area


def _call(kind, dev, B, seed):
    """The solver ``kind`` and its arguments on ``dev``."""
    points, probs, sigmas, area = _inputs(B, seed)
    args = {"simple": (points, probs), "sigma": (points, probs, sigmas),
            "self_assessed": (points, probs, sigmas, area)}[kind]
    return getattr(solvers, f"solve_pose_{kind}"), (world_points(dev), *(a.to(dev) for a in args))


def _solve(kind, dev, B, seed):
    fn, args = _call(kind, dev, B, seed)
    return fn(*args)


def _tiny(family, dev):
    if family == "detr":
        return build_detr_model(DETRConfig(backbone="resnet18", hidden_dim=32, nheads=4,
                                           enc_layers=1, dec_layers=2, dim_feedforward=64,
                                           num_queries=12, dropout=0.0), seed=0, device=dev)
    return build_rtdetr_model(RTDETRConfig(depth=18, freeze_norm=False, hidden_dim=32, nhead=2,
                                           dim_feedforward=64, num_queries=12,
                                           num_decoder_layers=2, expansion=0.5),
                              seed=0, device=dev)


def _batch(n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    batch = {
        "image": torch.randint(0, 256, (n, 80, 80, 3), generator=g, dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * n),
        "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * n),
        "quat_gt": torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1),
        "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * n),
    }
    return {k: v.to(dev) for k, v in batch.items()}


def _graphed(kind):
    """The solver's graphed stages: all four but EPnP's init."""
    return [s for s in SOLVER_STAGES if kind != "self_assessed" or s != "solver.init"]


def _counts(stages):
    found = profiling.span_summary()["graphs"]
    return {s: (found[s]["eager"], found[s]["captures"], found[s]["replays"]) for s in stages}


# -- on the CPU -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["simple", "sigma", "self_assessed"])
def test_cpu_tensors_run_eagerly_and_count_no_capture(kind):
    with profiling.record_spans():
        for _ in range(3):
            with profiling.span("step"):
                _solve(kind, torch.device("cpu"), 4, seed=1)
    assert _counts(_graphed(kind)) == {s: (3, 0, 0) for s in _graphed(kind)}
    assert not graphs._stages


def test_cpu_eval_step_counts_its_solver_stages_as_eager():
    model, step = _tiny("detr", "cpu"), make_eval_step(out_size=64, solver="simple")
    with profiling.record_spans():
        for _ in range(2):
            out = step(model, _batch(2, 0, "cpu"))
    assert _counts(EVAL_STAGES) == {s: (2, 0, 0) for s in EVAL_STAGES}
    assert set(out) >= {"quat_pr", "tvec_pr", "valid", "score_tvec", "score_quat", "score"}


def test_constant_cache_hands_out_one_tensor_per_name_device_and_dtype():
    cases = [(world_points, WORLD_POINTS),
             (lambda d, t: Camera.K_torch(t, d), Camera.K)]
    for get, want in cases:
        a, b = get("cpu", torch.float32), get(torch.device("cpu"), torch.float32)
        c = get("cpu", torch.float64)
        assert a is b and c is not a
        assert torch.equal(c, torch.tensor(want)) and torch.equal(a, torch.tensor(want).float())
        assert not a.is_inference()
    t = device_constant("ransac.triples.11", lambda: _all_triples(11), "cpu")
    assert t is device_constant("ransac.triples.11", lambda: None, "cpu")
    assert torch.equal(t, torch.from_numpy(_all_triples(11))) and t.shape == (165, 3)
    with torch.inference_mode():
        d = device_constant("test.inference", lambda: [1.0, 2.0], "cpu")
    assert not d.is_inference()


def test_nothing_records_while_a_stream_is_captured(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with profiling.record_spans():
        assert profiling.capturing()
        assert profiling.span("eval.step") is profiling.span("solver.refine")
        with profiling.span("eval.step"), profiling.span("solver.refine"):
            profiling.count_graph("solver.refine", "replay")
    monkeypatch.undo()
    assert profiling.span_summary() == {"steps": 0, "spans": {}}
    with profiling.record_spans(), profiling.span("eval.step"):
        profiling.count_graph("solver.refine", "replay")
    assert profiling.span_summary()["graphs"]["solver.refine"]["replays"] == 1


class _StandIn:
    """The card's graph, imitated: a replay runs the stage on the input
    buffers and writes the output buffers in place."""

    def __init__(self, fn, static, outputs):
        self.fn, self.static = fn, static
        self.outputs = tuple(outputs.values()) if isinstance(outputs, dict) else outputs

    def replay(self):
        values = self.fn(*self.static)
        for buf, value in zip(self.outputs, values.values() if isinstance(values, dict)
                              else values):
            buf.copy_(value)


@pytest.fixture
def stand_in(monkeypatch):
    captured = []

    def capture(fn, args, tensors, device):
        inputs = [t.clone() for t in tensors]
        it = iter(inputs)
        static = [next(it) if isinstance(a, torch.Tensor) else a for a in args]
        outputs = fn(*static)
        captured.append(fn)
        return graphs._Graph(_StandIn(fn, static, outputs), inputs, outputs)

    monkeypatch.setattr(graphs, "_graphable", lambda tensors: bool(tensors))
    monkeypatch.setattr(graphs, "_capture", capture)
    return captured


def _affine(x, scale):
    return x * scale + 1.0, x.sum(-1)


def test_graph_runner_captures_on_the_second_call_and_replays_fresh_outputs(stand_in):
    xs = [torch.full((3, 2), float(k)) for k in range(4)]
    with profiling.record_spans(), profiling.span("step"):
        outs = [graphs.graphed("stage", _affine, x, 2.0) for x in xs]
    assert stand_in == [_affine]
    assert _counts(["stage"]) == {"stage": (1, 1, 2)}
    for x, (y, s) in zip(xs, outs):  # each result its own, none overwritten
        assert torch.equal(y, x * 2.0 + 1.0) and torch.equal(s, x.sum(-1))
    entry = graphs._stages["stage"][next(iter(graphs._stages["stage"]))]
    assert all(o is not e for o in outs[-1] for e in entry.outputs)
    graphs.graphed("stage", _affine, xs[0], 3.0)  # another static argument: another key
    assert len(graphs._stages["stage"]) == 2 and stand_in == [_affine]


def _scores(x):
    return {"double": x * 2.0, "total": x.sum()}


def test_graph_runner_returns_a_dict_stage_as_a_dict(stand_in):
    xs = [torch.arange(4.0) + k for k in range(3)]
    outs = [graphs.graphed("stage", _scores, x) for x in xs]
    assert stand_in == [_scores]
    for x, out in zip(xs, outs):
        assert list(out) == ["double", "total"]
        assert torch.equal(out["double"], x * 2.0) and torch.equal(out["total"], x.sum())


def test_graph_runner_keeps_the_last_used_keys(stand_in):
    shapes = [(n, 2) for n in range(1, graphs.LIMIT + 2)]
    for shape in shapes:
        for _ in range(2):
            graphs.graphed("stage", _affine, torch.ones(shape), 2.0)
    kept = [key[-1][0][0] for key in graphs._stages["stage"]]
    assert kept == shapes[1:] and len(stand_in) == len(shapes)
    with profiling.record_spans(), profiling.span("step"):
        graphs.graphed("stage", _affine, torch.ones(shapes[0]), 2.0)  # evicted: eager again
        graphs.graphed("stage", _affine, torch.ones(shapes[-1]), 2.0)
    assert _counts(["stage"]) == {"stage": (1, 0, 1)}
    assert [key[-1][0][0] for key in graphs._stages["stage"]] == (
        shapes[2:-1] + [shapes[0], shapes[-1]])


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 20])
@pytest.mark.parametrize("kind", ["simple", "sigma", "self_assessed"])
def test_card_replays_equal_the_eager_result_and_leave_it_alone(card, kind, B):
    with profiling.record_spans():
        results = []
        for seed in (1, 2, 1, 3):
            with profiling.span("step"):
                results.append(_solve(kind, card, B, seed))
    kept = [[t.clone() for t in r] for r in results]
    eager, capture, replay_a, replay_b = results
    for a, b in zip(eager, replay_a):  # the same inputs: bit for bit
        assert torch.equal(a, b)
    for a, b in zip(_solve(kind, card, B, 2), capture):
        assert torch.equal(a, b)
    assert not torch.equal(eager[0], capture[0]) and not torch.equal(eager[0], replay_b[0])
    for r, k in zip(results, kept):  # later calls wrote none of them
        assert all(torch.equal(a, b) for a, b in zip(r, k))
    valid = eager[2].cpu()
    assert not valid[::7].any() and not valid[1::5].any() and valid.any()
    assert _counts(_graphed(kind)) == {s: (1, 1, 2) for s in _graphed(kind)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["simple", "sigma", "self_assessed"])
def test_card_replay_makes_no_host_sync(card, kind):
    for seed in (1, 2):
        _solve(kind, card, 64, seed)
    fn, args = _call(kind, card, 64, 3)
    torch.cuda.synchronize()
    if kind == "self_assessed":
        # EPnP's decompositions read their status on the host, so its init
        # runs eagerly; every sync of a replayed call is there
        with profiling.record_spans(), profiling.span("step"):
            fn(*args)
        spans = profiling.span_summary()["spans"]
        assert spans["solver.refine"]["syncs_per_step"] == 0
        sites = {s for v in spans.values() for s in v["sync_sites"]}
        assert sites and all(s.startswith("geometry/epnp.py:") for s in sites)
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        quat, tvec, valid = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(quat).all() and valid.any()


@pytest.mark.cuda
def test_card_key_bound_evicts(card):
    sizes = list(range(8, 8 + graphs.LIMIT + 1))
    for B in sizes:
        for _ in range(2):
            _solve("simple", card, B, seed=B)
    assert len(graphs._stages["solver.refine"]) == graphs.LIMIT
    with profiling.record_spans(), profiling.span("step"):
        _solve("simple", card, sizes[0], seed=0)
        _solve("simple", card, sizes[-1], seed=0)
    assert _counts(["solver.refine"]) == {"solver.refine": (1, 0, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("family, solver", [("detr", "simple"), ("rtdetr", "sigma")])
def test_card_eval_step_replays_its_outputs_bit_for_bit(card, family, solver):
    model, step = _tiny(family, card), make_eval_step(out_size=64, solver=solver)
    batches = [_batch(6, seed, card) for seed in (0, 1, 0)]
    with profiling.record_spans():
        outs = [step(model, b) for b in batches]
    eager, _, replay = outs
    for k in ("quat_pr", "tvec_pr", "valid", "points", "probs", "sigmas", "score_tvec",
              "score_quat", "score"):
        assert torch.equal(eager[k], replay[k]), k
    assert _counts(EVAL_STAGES) == {s: (1, 1, 1) for s in EVAL_STAGES}
