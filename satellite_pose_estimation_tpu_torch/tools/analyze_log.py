"""Training-log analysis (a copy of the JAX package's tools/analyze_log.py;
the R1/analyze_log.py surface): parse the JSON-lines log.txt and
plot/print loss + score curves.

Expected keys per line: train_loss_total, train_loss_ce, train_loss_points,
test_score, test_score_tvec, test_score_quat, epoch — the same flattened
train_*/test_* scheme the reference documents (R1/analyze_log.py:13-33).
"""
from __future__ import annotations

import argparse
import json


_STATS_RE = (
    r"tvec score: ([\d.]+), quat score: ([\d.]+), final score: ([\d.]+)"
)


def load_log(path):
    """Parse JSON-lines log.txt. Reference-format logs carry the scores
    only inside the test_speed_eval_pose stats string (the TB extraction
    regex of R2/solver/speed_solver.py:167-189); backfill test_score*
    scalars from it so both our logs and the reference's own log.txt
    analyze identically."""
    import re

    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    for e in entries:
        stats = e.get("test_speed_eval_pose")
        if isinstance(stats, str) and "test_score" not in e:
            m = re.search(_STATS_RE, stats)
            if m:
                e["test_score_tvec"] = float(m.group(1))
                e["test_score_quat"] = float(m.group(2))
                e["test_score"] = float(m.group(3))
    return entries


def main(args):
    entries = load_log(args.log)
    keys = sorted({k for e in entries for k in e if k != "epoch"})
    print(f"{len(entries)} epochs, keys: {keys}")

    best = min(
        (e for e in entries if "test_score" in e),
        key=lambda e: e["test_score"],
        default=None,
    )
    if best:
        print(
            f"best epoch {best['epoch']}: score {best['test_score']:.6f} "
            f"(tvec {best.get('test_score_tvec', float('nan')):.6f}, "
            f"quat {best.get('test_score_quat', float('nan')):.6f})"
        )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(12, 4))
        epochs = [e["epoch"] for e in entries]
        for key in ("train_loss_total", "train_loss_ce", "train_loss_points"):
            vals = [e.get(key) for e in entries]
            if any(v is not None for v in vals):
                axes[0].plot(epochs, vals, label=key)
        axes[0].set_title("train losses"); axes[0].legend()
        for key in ("test_score", "test_score_tvec", "test_score_quat"):
            vals = [e.get(key) for e in entries]
            if any(v is not None for v in vals):
                axes[1].plot(epochs, vals, label=key)
        axes[1].set_title("eval scores"); axes[1].legend()
        fig.savefig(args.out)
        print(f"saved {args.out}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--log", default="output/run/log.txt")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--out", default="log_curves.png")
    main(parser.parse_args())
