"""Batched submission inference over detector boxes, one checkpoint
(R1/gen_submission_single.py:112-251; counterpart of
tools/gen_submission_single.py).

For each of the two SPEED test splits (real_test from wz_real_test.json,
the synthetic test from wz_synt_test.json): crop around the detector box
(pad-to-square canvas), run the keypoint model and the per-image PnP in one
eval step per batch on the device, and export one submission CSV through
``SubmissionWriter``. Runs on the card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time

from ..data.dataset import SpeedSubmissionDataset
from ..data.prefetch import prefetch_to_device
from ..train.solver import SpeedSolver
from ..utils.metric_logger import SmoothedValue
from ..utils.submission import SubmissionWriter
from .main import args_to_config, attach_checkpoint, get_args_parser


def gen_submission(solver, dataset, append_fn, batch_size):
    """Eval steps of ``solver`` over ``dataset``; ``append_fn(filename, q,
    r)`` takes each image's pose (the pad images of the last batch
    skipped)."""
    model_solver_time = SmoothedValue(fmt="{avg:.4f}")
    for batch in prefetch_to_device(dataset.batches(batch_size), size=2, device=solver.device):
        pad = batch.pop("pad", 0)
        filenames = batch.pop("filename")
        t0 = time.perf_counter()
        results = solver.eval_step(solver.state, batch)
        quat = results["quat_pr"].cpu().tolist()
        tvec = results["tvec_pr"].cpu().tolist()
        model_solver_time.update(time.perf_counter() - t0)
        for i in range(len(filenames) - pad):
            append_fn(filenames[i], quat[i], tvec[i])
    print(f"model+solver time per batch: {model_solver_time}")


def main(args):
    """Returns the CSV's path."""
    cfg = args_to_config(args)
    solver = SpeedSolver(cfg, data_root=args.data_root, seed=args.seed, device=args.device)
    if args.resume:
        attach_checkpoint(solver, args.resume)
    solver._build()

    writer = SubmissionWriter()
    real_ds = SpeedSubmissionDataset(args.data_root, args.real_ann_file, args.real_img_dir,
                                     resize=args.input_size)
    synt_ds = SpeedSubmissionDataset(args.data_root, args.synt_ann_file, args.synt_img_dir,
                                     resize=args.input_size)
    gen_submission(solver, real_ds, writer.append_real_test, args.batch_size)
    gen_submission(solver, synt_ds, writer.append_test, args.batch_size)
    return writer.export(args.submission_dir)


def get_submission_parser():
    parser = argparse.ArgumentParser("gen submission (single model)",
                                     parents=[get_args_parser()])
    parser.add_argument("--real_ann_file", default="wz_real_test.json")
    parser.add_argument("--real_img_dir", default="images/real_test")
    parser.add_argument("--synt_ann_file", default="wz_synt_test.json")
    parser.add_argument("--synt_img_dir", default="images/test")
    parser.add_argument("--submission_dir", default="./submission")
    return parser


if __name__ == "__main__":
    main(get_submission_parser().parse_args())
