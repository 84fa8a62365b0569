"""Ablation-sweep plotting (a copy of the JAX package's tools/plot_ablations.py;
R1/plot_enc_num.py equivalent).

The reference tool compares several training runs (encoder/decoder layer
count, query count, input size sweeps) by plotting val score vs epoch per
run — full curve and a last-N zoom — plus bar charts of final scores
(R1/plot_enc_num.py:68-118,122-140). This version reads our JSON-lines
``log.txt`` files (``test_score`` per epoch, written by
train/solver.py) instead of regex-scraping a stats string.

Usage:
  python -m satellite_pose_estimation_tpu_torch.tools.plot_ablations \
      --logs run_ed1/log.txt run_ed2/log.txt --labels 1 2 \
      --name layer --out show_analyze
  python -m ...plot_ablations --bar 0.047 0.036 0.033 \
      --ticks 1 2 3 --name layer --out show_analyze
"""
from __future__ import annotations

import argparse
import json
import os


def read_scores(path):
    epochs, scores = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            e = json.loads(line)
            if "epoch" in e and "test_score" in e:
                epochs.append(int(e["epoch"]))
                scores.append(float(e["test_score"]))
    return epochs, scores


def plot_runs(log_paths, labels, name, out_dir, last_n=30, score_cap=4.0):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = [read_scores(p) for p in log_paths]
    for zoom, suffix in ((False, "epoch_score_all"), (True, "epoch_score_last")):
        fig, ax = plt.subplots(figsize=(8.5, 6.5) if not zoom else (5, 3))
        for (epochs, scores), label in zip(runs, labels):
            pts = [(e, s) for e, s in zip(epochs, scores) if s < score_cap]
            if zoom:
                pts = pts[-last_n:]
            if pts:
                ax.plot(*zip(*pts), label=f"{name}: {label}")
        ax.set_xlabel("epoch")
        ax.set_ylabel("score")
        if not zoom:
            ax.legend()
        path = os.path.join(out_dir, f"{name}_{suffix}.png")
        fig.savefig(path, bbox_inches="tight", dpi=200)
        plt.close(fig)
        print(f"saved {path}")


def plot_bar(scores, ticks, name, out_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 5.3))
    ax.bar([str(t) for t in ticks], scores, width=0.4)
    ax.set_xlabel(name)
    ax.set_ylabel("score")
    path = os.path.join(out_dir, f"{name}_num_bar.png")
    fig.savefig(path, bbox_inches="tight", dpi=200)
    plt.close(fig)
    print(f"saved {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--logs", nargs="*", default=[],
                    help="log.txt files, one per run")
    ap.add_argument("--labels", nargs="*", default=None,
                    help="legend labels (default: 1..N)")
    ap.add_argument("--bar", nargs="*", type=float, default=None,
                    help="final scores for a bar chart")
    ap.add_argument("--ticks", nargs="*", default=None,
                    help="x ticks for the bar chart")
    ap.add_argument("--name", default="layer")
    ap.add_argument("--out", default="show_analyze")
    ap.add_argument("--last_n", type=int, default=30)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.bar:
        ticks = args.ticks or [str(i + 1) for i in range(len(args.bar))]
        plot_bar(args.bar, ticks, args.name, args.out)
    if args.logs:
        labels = args.labels or [str(i + 1) for i in range(len(args.logs))]
        plot_runs(args.logs, labels, args.name, args.out, args.last_n)
    if not args.bar and not args.logs:
        ap.error("provide --logs and/or --bar")


if __name__ == "__main__":
    main()
