"""Results-CSV appender: a copy of ``genrec_tpu/utils/csv_results.py``.

Equivalent of `SASRec/evaluate.py:57-89` / `RQVAE-T5/evaluate.py:85-125`:
append one row of {task_id, hyperparams..., metrics...} per eval run,
writing the header only when the file is created.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Mapping


def append_results_csv(csv_path: str, row: Mapping[str, object],
                       float_fmt: str = "{:.6f}") -> None:
    d = os.path.dirname(csv_path)
    if d:
        os.makedirs(d, exist_ok=True)
    formatted: Dict[str, str] = {}
    for k, v in row.items():
        if isinstance(v, float):
            formatted[k] = float_fmt.format(v)
        else:
            formatted[k] = str(v)
    file_exists = os.path.exists(csv_path)
    with open(csv_path, "a", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        if not file_exists:
            writer.writerow(formatted.keys())
        writer.writerow(formatted.values())
