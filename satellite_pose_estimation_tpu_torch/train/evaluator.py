"""SpeedEval equivalent (counterpart of train/evaluator.py): accumulates per-image results and produces the
reference's summary stats string and per-image JSON log.

Contract (R1/datasets/speed.py:337-421, R2/.../speed_dataset.py:352-483):
per image store rounded points/logits/gt/pred/scores; summarize() builds
  "tvec score: X, quat score: Y, final score: Z; median tvec: ..., median
   quat: ...; mean tvec abs: [...], median tvec abs: [...]"
Failure images carry the zero pose (valid=False from the device solver).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


class SpeedEvaluator:
    def __init__(self, ground_truth: Optional[Dict[str, dict]] = None):
        self.ground_truth = ground_truth or {}
        self.log: Dict[str, dict] = {}

    def update_batch(self, filenames: List[str], results: dict, pad: int = 0):
        """results: make_eval_step's dict as numpy arrays (host-fetched)."""
        n = len(filenames) - pad if pad else len(filenames)
        get = lambda k: np.asarray(results[k])
        for i in range(n):
            fn = filenames[i]
            quat_pr = get("quat_pr")[i]
            tvec_pr = get("tvec_pr")[i]
            entry = {
                "points": np.around(get("points")[i], 2).tolist(),
                "logits": np.around(get("probs")[i], 6).tolist(),
                "quat_pr": np.around(quat_pr, 6).tolist(),
                "tvec_pr": np.around(tvec_pr, 6).tolist(),
                "valid": bool(get("valid")[i]),
            }
            if "sigmas" in results:
                entry["sigma"] = np.around(get("sigmas")[i], 8).tolist()
            for key in results:
                if key.startswith("aux_points_"):
                    entry[key] = np.around(get(key)[i], 2).tolist()
            if "score" in results:
                entry["score_tvec"] = float(np.around(get("score_tvec")[i], 8))
                entry["score_quat"] = float(np.around(get("score_quat")[i], 8))
                entry["score"] = float(np.around(get("score")[i], 8))
                if "quat_gt" in results:
                    entry["quat_gt"] = get("quat_gt")[i].tolist()
                    entry["tvec_gt"] = get("tvec_gt")[i].tolist()
                else:
                    gt = self.ground_truth.get(fn)
                    if gt is not None:
                        entry["quat_gt"] = np.asarray(gt["quat"]).tolist()
                        entry["tvec_gt"] = np.asarray(gt["tvec"]).tolist()
            self.log[fn] = entry

    def summarize(self) -> str:
        items = list(self.log.values())
        scored = [it for it in items if "score" in it]
        if not scored:
            # GT-less split (submission canvas): degrade to a points-only
            # summary rather than KeyError — the reference never summarizes
            # GT-less runs, so any stable string here is an extension.
            n_valid = sum(bool(it.get("valid")) for it in items)
            self.stats = (
                f"no ground truth: {len(items)} images, "
                f"{n_valid} valid poses (points-only summary)"
            )
            return self.stats
        items = scored
        scores = np.asarray([it["score"] for it in items])
        tvec_score = np.asarray([it["score_tvec"] for it in items])
        quat_score = np.asarray([it["score_quat"] for it in items])
        tvec_abs = np.stack(
            [
                np.abs(np.asarray(it["tvec_pr"]) - np.asarray(it["tvec_gt"]))
                for it in items
                if "tvec_gt" in it
            ]
        ) if any("tvec_gt" in it for it in items) else np.zeros((1, 3))

        mean_s = float(np.mean(scores))
        mean_t = float(np.mean(tvec_score))
        mean_q = float(np.mean(quat_score))

        stats = (
            "tvec score: {:.6f}, quat score: {:.6f}, final score: {:.6f}; "
            .format(mean_t, mean_q, mean_s)
        )
        # Reference quirk, reproduced verbatim: both SpeedEvals reduce the
        # per-image scores to a scalar mean BEFORE the median
        # (R1/datasets/speed.py:398-412, R2/.../speed_dataset.py:456-474:
        # ``tvec_score = np.mean(tvec_score).item()`` then
        # ``np.median(tvec_score)``), so the "median" fields in the shipped
        # stats string are the means again. True medians are available in
        # scalar_summary() as an extension.
        stats += "median tvec: {:.6f}, median quat: {:.6f}; ".format(
            mean_t, mean_q
        )
        am = np.mean(tvec_abs, 0).tolist()
        ad = np.median(tvec_abs, 0).tolist()
        stats += (
            "mean tvec abs: [{:.6f}, {:.6f}, {:.6f}], median tvec abs:"
            "[{:.6f}, {:.6f}, {:.6f}]".format(*(am + ad))
        )
        self.stats = stats
        return stats

    def scalar_summary(self) -> dict:
        items = list(self.log.values())
        scored = [it for it in items if "score" in it]
        out = {"num_images": len(items)}
        if scored:
            out.update(
                score=float(np.mean([it["score"] for it in scored])),
                score_tvec=float(
                    np.mean([it["score_tvec"] for it in scored])
                ),
                score_quat=float(
                    np.mean([it["score_quat"] for it in scored])
                ),
                # true per-image medians (the stats string's "median"
                # fields repeat the means — reference quirk, see summarize)
                median_tvec=float(
                    np.median([it["score_tvec"] for it in scored])
                ),
                median_quat=float(
                    np.median([it["score_quat"] for it in scored])
                ),
            )
        else:
            out["num_valid"] = sum(bool(it.get("valid")) for it in items)
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.log, f)
