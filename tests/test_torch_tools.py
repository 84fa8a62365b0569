"""PyTorch port, the tools against the JAX package's: the crop warp the
timing tool runs against JAX's ``crop_resize_cubic``, the timing tools'
``main`` on the CPU, the offline re-scoring tools (``simple_test_result``,
``val_p_which_p`` in both modes, with and without sigma) on a cache of
known poses, ``confidence_topn_mask``, the encoder attention maps,
``visualize``'s three subcommands, the log tools, the registry, and every
device entry point's default device."""
import argparse
import contextlib
import io
import json
import pathlib
import re
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.core import registry as jreg
from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.ops.image_warp import crop_resize_cubic as jax_crop
from satellite_pose_estimation_tpu.tools import analyze_log as janalyze
from satellite_pose_estimation_tpu.tools import gen_new_trainjson as jgen
from satellite_pose_estimation_tpu.tools import output_min_scores as jmin
from satellite_pose_estimation_tpu.tools import simple_test_result as jstr
from satellite_pose_estimation_tpu.tools import val_p_which_p as jvp
from satellite_pose_estimation_tpu.tools import visualize as jvis
from satellite_pose_estimation_tpu.tools import visualize_features as jvf
from satellite_pose_estimation_tpu_torch.core import registry as treg
from satellite_pose_estimation_tpu_torch.data.dataset import SpeedTrainDataset
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.models.position_encoding import PositionEmbeddingSine
from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
from satellite_pose_estimation_tpu_torch.tools import (
    analyze_log,
    gen_new_trainjson,
    get_backbone_time,
    get_inference_time,
    output_min_scores,
    plot_ablations,
    simple_test_result,
    train_cifar,
    val_p_which_p,
    visualize,
    visualize_features,
)
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset

from _torch_parity import port_to_flax
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_IMAGES = 6


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.mark.parametrize("normalize", [False, True])
def test_crop_warp_matches_jax_crop_resize_cubic_at_224(normalize):
    """The timing tool's warp (the matrix form) against the gather form JAX's
    tool calls, from 256 x 256 uint8 canvases with boxes reaching past the
    canvas: 1e-4 of 255 (divided by the smallest ImageNet std when
    normalised)."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (2, 256, 256, 3)).astype(np.uint8)
    boxes = np.asarray([[8, 8, 248, 248], [-20.5, 13.25, 230.75, 270.5]], np.float32)
    ref = np.asarray(jax.vmap(lambda i, b: jax_crop(i, b, 224, normalize))(
        jnp.asarray(images), jnp.asarray(boxes)))
    got = crop_resize_cubic_mxu(torch.from_numpy(images), torch.from_numpy(boxes), 224,
                                normalize).numpy()
    tol = 1e-4 * 255 / (255 * 0.225 if normalize else 1.0)
    assert np.abs(got - ref).max() <= tol


def test_timing_tools_print_their_lines_on_the_cpu(capsys):
    times = get_inference_time.main(get_inference_time.get_args_parser().parse_args(
        ["--batch_size", "2", "--input_size", "32", "--test_num", "1", "--device", "cpu"]))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "batch 2 input 32:"
    for line, name in zip(out[1:], ("data/warp:", "model:", "solver:", "total:")):
        assert re.match(rf"  {re.escape(name)} +\d+\.\d\d ms", line), line
    assert out[4].endswith("img/s") and set(times) == {"warp_ms", "model_ms", "solver_ms",
                                                       "total_ms", "img_s"}
    times = get_backbone_time.main(get_backbone_time.get_args_parser().parse_args(
        ["--batch_size", "2", "--input_size", "32", "--test_num", "1", "--device", "cpu"]))
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["resnet50 s16", "resnet50 s8 (Backbone8s)"]
    assert all(re.search(r"\d+\.\d\d ms/batch \(\d+ img/s\)", line) for line in out)
    assert all(t > 0 for t in times.values())


# -- offline re-scoring ---------------------------------------------------------

@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """A cached eval log of known poses (chip_smoke's, with an all-background
    image added, which no tool can solve) and its ground truth, with and
    without sigmas."""
    tmp = tmp_path_factory.mktemp("caches")
    log, gt = _chip_smoke().pose_cache(torch, n=N_IMAGES, seed=5)
    first = next(iter(log.values()))
    blank = {**first, "logits": [[0.0] * 11 + [1.0]] * len(first["logits"])}
    log["blank.jpg"] = blank
    gt.append({"filename": "blank.jpg", "q_vbs2tango": blank["quat_gt"],
               "r_Vo2To_vbs_true": blank["tvec_gt"]})
    paths = {"gt": tmp / "gt.json", "sigma": tmp / "sigma.json", "plain": tmp / "plain.json"}
    paths["gt"].write_text(json.dumps(gt))
    paths["sigma"].write_text(json.dumps(log))
    paths["plain"].write_text(json.dumps(
        {fn: {k: v for k, v in it.items() if k != "sigma"} for fn, it in log.items()}))
    return paths


def test_simple_test_result_matches_jax(caches, capsys):
    args = argparse.Namespace(ret_file=str(caches["plain"]), gt_file=str(caches["gt"]), repro=20,
                              device="cpu")
    got = simple_test_result.main(args)
    port_line = capsys.readouterr().out.strip()
    jstr.main(args)
    jax_line = capsys.readouterr().out.strip()
    ref = float(jax_line.rsplit(" ", 1)[1])
    assert port_line.startswith(f"mean speed score over {N_IMAGES + 1} images: ")
    assert jax_line.startswith(f"mean speed score over {N_IMAGES + 1} images: ")
    assert abs(got - ref) <= 2e-3
    # the blank image scores as the zero pose (1 + pi); the rest are near 0
    assert 1 + np.pi < got * (N_IMAGES + 1) < 1 + np.pi + 0.2


def _recorded_keeps(monkeypatch, module):
    """``module.make_solver`` wrapped to record each call's ``keep`` mask."""
    keeps, real = [], module.make_solver

    def make_solver(*a, **k):
        solve = real(*a, **k)

        def recording(points, probs, sigmas, keep):
            keeps.append(np.asarray(keep).reshape(-1, 11).copy())
            return solve(points, probs, sigmas, keep)
        return recording

    monkeypatch.setattr(module, "make_solver", make_solver)
    return keeps


@pytest.mark.parametrize("mode", ["random", "topn"])
@pytest.mark.parametrize("kind", ["sigma", "plain"])
def test_val_p_which_p_matches_jax(caches, monkeypatch, capsys, mode, kind):
    """Each N's mean SPEED within 2e-3 of JAX's, the same printed lines up to
    the sixth decimal, and the same keypoint subsets (in ``random`` mode
    drawn from one seed in JAX's order). The port solves in float64; JAX's
    tool casts to float32, which under the tests' x64 computes as float64
    (in float32, 4-point P3P is ill-conditioned: simple_test_result.py)."""
    args = argparse.Namespace(eval_log=str(caches[kind]), repro=25, mode=mode, seed=3,
                              device="cpu")
    port_keeps = _recorded_keeps(monkeypatch, val_p_which_p)
    jax_keeps = _recorded_keeps(monkeypatch, jvp)
    got = val_p_which_p.main(args)
    port_lines = capsys.readouterr().out.splitlines()
    ref = jvp.main(args)
    jax_lines = capsys.readouterr().out.splitlines()
    assert sorted(got) == sorted(ref) == list(range(4, 12))
    for n in got:
        assert abs(got[n] - ref[n]) <= 2e-3, (n, got[n], ref[n])
    assert got[11] < (1 + np.pi + 0.1) / (N_IMAGES + 1)  # every known pose solved at N = 11
    strip = re.compile(r"mean score [\d.]+ ")
    assert [strip.sub("", line) for line in port_lines] == [strip.sub("", line)
                                                             for line in jax_lines]
    assert ("(sigma-weighted)" in port_lines[0]) == (kind == "sigma")
    np.testing.assert_array_equal(np.concatenate(port_keeps), np.concatenate(jax_keeps))


def test_confidence_topn_mask_is_exact():
    """Batched against JAX's per-image mask, with tied rows and scores."""
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(12), (16, 20)).astype(np.float32)
    probs[3] = probs[2]
    probs[5, :, :] = 1.0 / 12  # every query ties: argmax 0, each label's best the same
    probs[7, 4] = probs[7, 9]
    for n in range(4, 12):
        got = val_p_which_p.confidence_topn_mask(torch.from_numpy(probs), n).numpy()
        ref = np.stack([np.asarray(jvp.confidence_topn_mask(jnp.asarray(p), n)) for p in probs])
        np.testing.assert_array_equal(got, ref)
        assert (got.sum(-1) == n).all()


# -- visualisation ----------------------------------------------------------------

def test_encoder_attention_maps_match_jax():
    cfg = dict(backbone="resnet18", hidden_dim=32, nheads=4, enc_layers=2, dec_layers=1,
               dim_feedforward=64, num_queries=12, dropout=0.0)
    model = build_detr_model(DETRConfig(**cfg), seed=3, device="cpu")
    params = port_to_flax(JaxDETR(JaxDETRConfig(**cfg)), model.state_dict(),
                          jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.RandomState(6)
    tokens = rng.randn(64, 32).astype(np.float32)
    pos = PositionEmbeddingSine(16)(8, 8).numpy().reshape(64, 32)
    for layer in (0, 1):
        got = visualize_features.encoder_attention_maps(model, tokens, pos, layer)
        ref = jvf.encoder_attention_maps(params, tokens, pos, layer)
        assert got.shape == ref.shape == (4, 64, 64)
        assert np.abs(got - ref).max() <= 1e-5


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("speed")
    info = render_dataset(str(root), 3, seed=2, n_train=2)
    return root, info["filenames"]


@pytest.fixture
def written(monkeypatch):
    """The arrays the tools hand to ``cv2.imwrite`` (before the JPEG
    encoder), by directory and file name."""
    out, real = {}, cv2.imwrite

    def imwrite(path, img):
        path = pathlib.Path(path)
        out.setdefault(path.parent.name, {})[path.name] = img.copy()
        return real(str(path), img)

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return out


def test_visualize_submission_and_points_draw_what_jax_draws(frames, tmp_path, capsys, written):
    root, names = frames
    img_dir = root / "images" / "train"
    rng = np.random.RandomState(7)
    anns = json.loads((root / "annos" / "wz_train.json").read_text())
    csv = tmp_path / "sub.csv"
    csv.write_text("".join(
        f"{a['filename']},{','.join(map(str, a['q_vbs2tango']))},"
        f"{','.join(str(v + 0.01 * rng.randn()) for v in a['r_Vo2To_vbs_true'])}\n"
        for a in anns) + "missing.jpg,1,0,0,0,0,0,10\n")
    preds = {a["filename"]: {"points": (np.asarray(a["landmarks"]).tolist()
                                        + [[5.0, 5.0]] * 9),
                             "logits": np.eye(12)[list(range(11)) + [11] * 9].tolist()}
             for a in anns}
    (tmp_path / "preds.json").write_text(json.dumps(preds))
    for cmd, extra in (("submission", ["--csv", str(csv)]),
                       ("points", ["--pred_file", str(tmp_path / "preds.json")])):
        outs = {}
        for name, module in (("port", visualize), ("jax", jvis)):
            out = tmp_path / f"{cmd}_{name}"
            args = visualize.get_args_parser().parse_args(
                [cmd, *extra, "--img_dir", str(img_dir), "--out_dir", str(out)])
            getattr(module, f"cmd_{cmd}")(args)
            outs[name] = written[out.name]
        assert sorted(outs["port"]) == sorted(outs["jax"]) == sorted(names)
        for fn in names:
            np.testing.assert_array_equal(outs["port"][fn], outs["jax"][fn])
    out = capsys.readouterr().out
    assert out.count(f"wrote {len(names) + 1} visualisations") == 2  # the CSV's row count
    assert out.count(f"wrote {len(names)} visualisations") == 2


def test_visualize_dataset_draws_what_jax_draws(frames, tmp_path, written):
    """The crops of the train split with their keypoints: equal to JAX's
    but where a warped value lies within the two warps' distance (1e-4 of
    255) of an integer, where the uint8 cast (truncation, and wrap-around
    below 0 and past 255) gives one level more or less."""
    root, _ = frames
    outs = {}
    for name, module in (("port", visualize), ("jax", jvis)):
        out = tmp_path / name
        args = visualize.get_args_parser().parse_args(
            ["dataset", "--data_root", str(root), "--resize", "96", "--out_dir", str(out),
             "--device", "cpu"])
        module.cmd_dataset(args)
        outs[name] = written[out.name]
    assert sorted(outs["port"]) == sorted(outs["jax"]) and len(outs["port"]) == 2
    ds = SpeedTrainDataset(str(root), index_file="train_1.txt", resize=96, train=False)
    for s in (ds[0], ds[1]):
        warped = crop_resize_cubic_mxu(torch.from_numpy(s["image"][None].copy()),
                                       torch.from_numpy(s["clip_bbox_buf"][None].copy()), 96,
                                       False)[0].numpy()[..., ::-1]  # BGR, as written
        near = np.abs(warped - np.round(warped)) <= 1e-4 * 255
        diff = (outs["port"][s["filename"]].astype(int)
                - outs["jax"][s["filename"]].astype(int)) % 256
        off = diff != 0
        assert np.isin(diff[off], (1, 255)).all() and near[off].all()


# -- log tools ------------------------------------------------------------------

def _log_lines():
    rng = np.random.RandomState(8)
    lines = []
    for epoch in range(4):
        e = {"epoch": epoch, "train_loss_total": float(rng.rand()),
             "train_loss_ce": float(rng.rand()), "train_loss_points": float(rng.rand())}
        if epoch % 2:  # the reference's format: the scores only in the stats string
            t, q = rng.rand(2)
            e["test_speed_eval_pose"] = (f"tvec score: {t:.6f}, quat score: {q:.6f}, final "
                                         f"score: {t + q:.6f}; median tvec: 0.1, median quat: 0.2")
        else:
            e.update(test_score=float(rng.rand()), test_score_tvec=0.1, test_score_quat=0.2)
        lines.append(json.dumps(e))
    return "\n".join(lines) + "\n\n"


def test_log_tools_print_what_jax_prints(tmp_path, capsys):
    for run in ("run_a", "run_b"):
        (tmp_path / run).mkdir()
        (tmp_path / run / "log.txt").write_text(_log_lines())
    (tmp_path / "empty").mkdir()
    log = str(tmp_path / "run_a" / "log.txt")
    assert analyze_log.load_log(log) == janalyze.load_log(log)
    assert all("test_score" in e for e in analyze_log.load_log(log))  # the backfill
    printed = []
    for fn, args in ((analyze_log.main, argparse.Namespace(log=log, plot=False, out="x.png")),
                     (janalyze.main, argparse.Namespace(log=log, plot=False, out="x.png")),
                     (output_min_scores.main, argparse.Namespace(output_root=str(tmp_path))),
                     (jmin.main, argparse.Namespace(output_root=str(tmp_path)))):
        fn(args)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].startswith("4 epochs, keys:")
    assert printed[2] == printed[3] and printed[2].count("min score") == 2


def test_gen_new_trainjson_writes_what_jax_writes(frames, tmp_path):
    root, _ = frames
    src = str(root / "annos" / "wz_train.json")
    for module, dst in ((gen_new_trainjson, tmp_path / "port.json"), (jgen, tmp_path / "jax.json")):
        module.main(argparse.Namespace(src=src, dst=str(dst), drop=[0, 1, 7]))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert all(len(a["landmarks"]) == 8 for a in json.loads((tmp_path / "port.json").read_text()))


def test_plot_tools_write_their_pngs(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text(_log_lines())
    out = tmp_path / "plots"
    plot_ablations.main(["--logs", str(log), str(log), "--labels", "a", "b", "--bar", "0.1",
                         "0.2", "--name", "layer", "--out", str(out)])
    assert sorted(p.name for p in out.iterdir()) == [
        "layer_epoch_score_all.png", "layer_epoch_score_last.png", "layer_num_bar.png"]
    with contextlib.redirect_stdout(io.StringIO()):
        analyze_log.main(argparse.Namespace(log=str(log), plot=True, out=str(tmp_path / "c.png")))
    assert (tmp_path / "c.png").stat().st_size > 0
    with pytest.raises(SystemExit):
        plot_ablations.main(["--out", str(out)])


# -- registry -------------------------------------------------------------------

def _register_case(reg, tag):
    @reg.register(name=f"Enc{tag}")
    class Enc:
        __share__ = ["num_classes"]

        def __init__(self, hidden=8, num_classes=3):
            self.hidden, self.num_classes = hidden, num_classes

    @reg.register(name=f"Head{tag}")
    class Head:
        def __init__(self, dim=2):
            self.dim = dim

    @reg.register(name=f"Net{tag}")
    class Net:
        __inject__ = ["encoder", "head"]

        def __init__(self, encoder=f"Enc{tag}", head=None, depth=2):
            self.encoder, self.head, self.depth = encoder, head, depth

    cfg = {"num_classes": 7, f"Enc{tag}": {"hidden": 16, "unknown": 1},
           f"Net{tag}": {"depth": 5, "head": {"type": f"Head{tag}", "dim": 4}}}
    net = reg.create(f"Net{tag}", cfg, depth=6)
    with pytest.raises(ValueError):
        reg.register(Head, name=f"Head{tag}")
    with pytest.raises(ValueError):
        reg.create(f"Missing{tag}")
    schemas = {k: {f: v for f, v in reg.GLOBAL_CONFIG.pop(k).items() if f != "_target"}
               for k in (f"Enc{tag}", f"Head{tag}", f"Net{tag}")}
    return (net.depth, vars(net.encoder), vars(net.head)), schemas


def test_registry_copy_matches_jax():
    """register / create with an ``__inject__`` by name and by an inline
    ``{type: ...}`` dict and a ``__share__`` global: the same objects and
    schemas from both packages' registries."""
    got = _register_case(treg, "PortCase")
    ref = _register_case(jreg, "PortCase")
    assert got == ref
    assert got[0] == (6, {"hidden": 16, "num_classes": 7}, {"dim": 4})


# -- devices ----------------------------------------------------------------------

ENTRY_POINTS = {
    "train_cifar": (train_cifar.get_args_parser, ["--root", "none"]),
    "get_inference_time": (get_inference_time.get_args_parser, ["--batch_size", "1"]),
    "get_backbone_time": (get_backbone_time.get_args_parser, ["--batch_size", "1"]),
    "simple_test_result": (simple_test_result.get_args_parser, []),
    "val_p_which_p": (val_p_which_p.get_args_parser, ["--eval_log", "none"]),
    "visualize_features": (visualize_features.get_args_parser, ["-c", "none", "-r", "none"]),
    "visualize_dataset": (visualize.get_args_parser, ["dataset"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_entry_points_default_to_the_card(name):
    parser, argv = ENTRY_POINTS[name]
    assert parser().parse_args(argv).device == "cuda"


def test_device_entry_points_raise_without_a_card(caches, frames, tmp_path):
    """On a machine without a card the default device raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: tests/test_torch_cuda.py runs the tools there")
    root, _ = frames
    runs = [
        (get_backbone_time.main, get_backbone_time.get_args_parser().parse_args(
            ["--batch_size", "1", "--input_size", "32", "--test_num", "1"])),
        (simple_test_result.main, simple_test_result.get_args_parser().parse_args(
            ["--ret_file", str(caches["plain"]), "--gt_file", str(caches["gt"])])),
        (val_p_which_p.main, val_p_which_p.get_args_parser().parse_args(
            ["--eval_log", str(caches["sigma"])])),
        (visualize.main, visualize.get_args_parser().parse_args(
            ["dataset", "--data_root", str(root), "--out_dir", str(tmp_path)])),
    ]
    for main, args in runs:
        with pytest.raises((AssertionError, RuntimeError)):
            main(args)
