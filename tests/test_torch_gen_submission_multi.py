"""PyTorch port, the checkpoint-ensemble submission CLI
(tools/gen_submission_multi.py): ``main`` end to end on the CPU over two
checkpoints in ``SpeedSolver``'s format and a few rendered PPM frames, and
its ``ensemble_solve`` against JAX's on the same pooled per-image points
and probabilities (made from seeded known poses, so that the poses mean
something): poses to 2e-3 rad and 1e-4 relative translation, as the R1
solver is held, and the same CSV rows and columns. No JAX checkpoint is
built."""
import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.tools import gen_submission_multi as jax_multi
from satellite_pose_estimation_tpu.utils.submission import SubmissionWriter as JaxWriter
from satellite_pose_estimation_tpu_torch.tools import gen_submission_multi as multi
from satellite_pose_estimation_tpu_torch.tools.main import args_to_config
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver
from satellite_pose_estimation_tpu_torch.utils.submission import SubmissionWriter

from _torch_parity import one_thread, poses, project_tango, quat_angle

FLAGS = ["--backbone", "resnet18", "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
         "--dec_layers", "1", "--dim_feedforward", "64", "--num_queries", "12",
         "--input_size", "64", "--batch_size", "2", "--device", "cpu",
         "--real_img_dir", "images/train", "--synt_img_dir", "images/train"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two seeded R1 checkpoints saved by ``SpeedSolver``, then ``main``
    over them: (args, CSV path, checkpoint paths)."""
    tmp = tmp_path_factory.mktemp("multi")
    root = str(tmp / "speed")
    render_dataset(root, 5, seed=2, n_train=2, fmt="ppm")
    parser = multi.get_submission_parser()
    ckpts = []
    for seed in (0, 1):
        args = parser.parse_args(FLAGS + ["--data_root", root, "--checkpoints", "-",
                                          "--output_dir", str(tmp / f"train{seed}")])
        solver = SpeedSolver(args_to_config(args), data_root=root, seed=seed, device="cpu")
        solver._build()
        solver.save_checkpoint(0, "checkpoint")
        ckpts.append(os.path.join(str(tmp / f"train{seed}"), "checkpoint"))
    args = parser.parse_args(FLAGS + ["--data_root", root, "--checkpoints", *ckpts,
                                      "--output_dir", str(tmp / "unused"),
                                      "--submission_dir", str(tmp / "sub")])
    with pytest.MonkeyPatch.context() as mp:  # the raw JSON goes to the working directory
        mp.chdir(tmp)
        return args, multi.main(args), ckpts, str(tmp)


def test_main_writes_the_csv_and_the_raw_predictions(run):
    args, path, ckpts, cwd = run
    with open(path) as f:
        rows = list(csv.reader(f))
    with open(os.path.join(args.data_root, "annos", args.real_ann_file)) as f:
        n_real = len(json.load(f))
    with open(os.path.join(args.data_root, "annos", args.synt_ann_file)) as f:
        n_synt = len(json.load(f))
    assert len(rows) == n_real + n_synt and all(len(r) == 8 for r in rows)
    dumps = sorted(glob.glob(os.path.join(cwd, "points_logits_*.json")))
    assert [os.path.basename(p).split("_")[2] for p in dumps] == ["real", "synt"]
    with open(dumps[0]) as f:
        real = json.load(f)
    assert len(real) == n_real
    for models in real.values():
        assert len(models) == len(ckpts)
        for m in models:
            assert np.asarray(m["points"]).shape == (12, 2)
            np.testing.assert_allclose(np.asarray(m["logits"]).sum(-1), 1.0, rtol=1e-5)
    # the two checkpoints differ, so the pooled predictions do
    first = next(iter(real.values()))
    assert not np.allclose(first[0]["points"], first[1]["points"])


def test_parallel_ensemble_raises_until_the_parallel_layer_is_ported(run, tmp_path):
    """``--parallel_ensemble`` (both checkpoints' forwards at once through
    ``parallel.ensemble.ensemble_apply``; on the CPU one after another on
    one device) writes the serial route's CSV, row for row."""
    args, path, _, _ = run
    with open(path) as f:
        serial = list(csv.reader(f))
    args.parallel_ensemble, submission_dir = True, args.submission_dir
    args.submission_dir = str(tmp_path / "parallel")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(tmp_path)
            with open(multi.main(args)) as f:
                assert list(csv.reader(f)) == serial
    finally:
        args.parallel_ensemble, args.submission_dir = False, submission_dir


def test_parallel_ensemble_places_the_models_once_a_split(run, monkeypatch):
    """Over two devices (two entries for the CPU), ``gen_prediction_parallel``
    builds each device's replica and weights once for the whole split, not
    once a batch, and predicts what the one-device route predicts."""
    from satellite_pose_estimation_tpu_torch.data.dataset import SpeedSubmissionDataset
    from satellite_pose_estimation_tpu_torch.parallel import ensemble

    args, _, ckpts, _ = run
    trees = []
    for ckpt in ckpts:
        solver = SpeedSolver(args_to_config(args), data_root=args.data_root, seed=args.seed,
                             device="cpu")
        solver.resume(ckpt)
        solver._build()
        trees.append({k: v.detach().clone() for k, v in solver.state.model.state_dict().items()})
    model = solver.state.model
    ds = SpeedSubmissionDataset(args.data_root, args.synt_ann_file, args.synt_img_dir,
                                resize=args.input_size)  # 2 frames: 2 batches of 1
    calls = {"place": 0, "apply": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(multi, "place_ensemble", counted("place", ensemble.place_ensemble))
    monkeypatch.setattr(multi, "ensemble_apply", counted("apply", ensemble.ensemble_apply))
    got = multi.gen_prediction_parallel(model, trees, ds, 1, args.input_size, None, "cpu",
                                        devices=["cpu", "cpu"])
    assert calls == {"place": 1, "apply": 2}, calls
    ref = multi.gen_prediction_parallel(model, trees, ds, 1, args.input_size, None, "cpu")
    assert sorted(got) == sorted(ref)
    for f in ref:
        for a, b in zip(got[f], ref[f]):
            np.testing.assert_allclose(a["points"], b["points"], rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(a["logits"], b["logits"], rtol=1e-5, atol=1e-6)


def _pooled(seed, n_images=4, M=3, Q=20):
    """{filename: [{points, logits} x M]} from seeded known poses: each
    model's 11 foreground queries 1 px around the keypoints, the rest
    background."""
    rng = np.random.RandomState(seed)
    q, t = poses(rng, n_images)
    pix = project_tango(q, t)
    out = {}
    for i in range(n_images):
        models = []
        for _ in range(M):
            points = rng.rand(Q, 2).astype(np.float32) * 100
            probs = np.zeros((Q, 12), np.float32)
            probs[:, 11] = 0.9
            for label, qi in enumerate(rng.permutation(Q)[:11]):
                points[qi] = pix[i, label] + rng.randn(2)
                probs[qi] = 0.01
                probs[qi, label] = 0.8
            models.append({"points": points, "logits": probs})
        out[f"img{seed}_{i:03d}.jpg"] = models
    return out


def test_ensemble_solve_matches_jax(tmp_path):
    """The pooled solve on the CPU, asked for (``ensemble_solve`` runs on the
    card by default, as every entry point of the port does), against JAX's."""
    import inspect

    assert inspect.signature(multi.ensemble_solve).parameters["device"].default == "cuda"
    real, synt = _pooled(0), _pooled(1)
    writer, jwriter = SubmissionWriter(), JaxWriter()
    multi.ensemble_solve(real, writer.append_real_test, device="cpu")
    multi.ensemble_solve(synt, writer.append_test, device="cpu")
    jax_multi.ensemble_solve(real, jwriter.append_real_test)
    jax_multi.ensemble_solve(synt, jwriter.append_test)
    rows = list(csv.reader(open(writer.export(str(tmp_path / "port"), suffix="x"))))
    jrows = list(csv.reader(open(jwriter.export(str(tmp_path / "jax"), suffix="x"))))
    assert [r[0] for r in rows] == [r[0] for r in jrows] and len(rows) == 8
    assert all(len(r) == len(j) == 8 for r, j in zip(rows, jrows))
    vals = np.asarray([[float(x) for x in r[1:]] for r in rows])
    jvals = np.asarray([[float(x) for x in r[1:]] for r in jrows])
    assert np.all(quat_angle(vals[:, :4], jvals[:, :4]) < 2e-3)
    rel = np.linalg.norm(vals[:, 4:] - jvals[:, 4:], axis=-1) / np.linalg.norm(jvals[:, 4:], axis=-1)
    assert np.all(rel < 1e-4), rel
