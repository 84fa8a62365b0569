"""Best-epoch selection across runs (a copy of the JAX package's
tools/output_min_scores.py; the R2/output_min_scores.py:13-50 surface):
scan output/*/log.txt, report the minimum mean score with its epoch and
tvec/quat components per run directory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def main(args):
    for run_dir in sorted(glob.glob(os.path.join(args.output_root, "*"))):
        log_path = os.path.join(run_dir, "log.txt")
        if not os.path.exists(log_path):
            continue
        entries = []
        with open(log_path) as f:
            for line in f:
                if line.strip():
                    entries.append(json.loads(line))
        scored = [e for e in entries if "test_score" in e]
        if not scored:
            continue
        best = min(scored, key=lambda e: e["test_score"])
        print(
            f"{os.path.basename(run_dir)}: min score "
            f"{best['test_score']:.6f} @ epoch {best['epoch']} "
            f"(t {best.get('test_score_tvec', float('nan')):.6f}, "
            f"q {best.get('test_score_quat', float('nan')):.6f})"
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_root", default="output")
    main(parser.parse_args())
