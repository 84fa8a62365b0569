"""SPEED submission collection/export (counterpart of utils/submission.py).

Contract (R1/utils/submission.py:6-56): collect (filename, q, r) for the
synthetic-test and real-test splits; export one CSV, synthetic rows first
then real rows, each split sorted by filename; row = filename, q0..q3,
r0..r2; file named submission_<suffix>.csv.
"""
from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Optional, Sequence


class SubmissionWriter:
    def __init__(self):
        self.test_results = []
        self.real_test_results = []

    def append_test(self, filename: str, q: Sequence[float], r: Sequence[float]):
        self.test_results.append(
            {"filename": filename, "q": list(q), "r": list(r)}
        )

    def append_real_test(self, filename: str, q, r):
        self.real_test_results.append(
            {"filename": filename, "q": list(q), "r": list(r)}
        )

    def export(self, out_dir: str = "", suffix: Optional[str] = None) -> str:
        os.makedirs(out_dir, exist_ok=True) if out_dir else None
        if suffix is None:
            suffix = datetime.now().strftime("%Y%m%d-%H%M")
        path = os.path.join(out_dir, f"submission_{suffix}.csv")
        rows = sorted(self.test_results, key=lambda k: k["filename"]) + sorted(
            self.real_test_results, key=lambda k: k["filename"]
        )
        with open(path, "w") as f:
            writer = csv.writer(f, lineterminator="\n")
            for r_ in rows:
                writer.writerow([r_["filename"], *(r_["q"] + r_["r"])])
        print(f"Submission saved to {path}.")
        return path
