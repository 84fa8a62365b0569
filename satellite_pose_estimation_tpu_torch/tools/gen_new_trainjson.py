"""Annotation surgery: drop selected landmark indices from a train JSON
(a copy of the JAX package's tools/gen_new_trainjson.py; the
R2/tools/gen_new_trainjson.py surface — the reference drops landmarks
0-1).
"""
from __future__ import annotations

import argparse
import json


def main(args):
    with open(args.src) as f:
        anns = json.load(f)
    drop = set(args.drop)
    for item in anns:
        item["landmarks"] = [
            lm for i, lm in enumerate(item["landmarks"]) if i not in drop
        ]
    with open(args.dst, "w") as f:
        json.dump(anns, f)
    print(f"wrote {args.dst}: dropped landmarks {sorted(drop)} "
          f"from {len(anns)} annotations")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--drop", type=int, nargs="+", default=[0, 1])
    main(parser.parse_args())
