"""Semantic-ID code file contract (``course_rqvae_codes.npy``).

``course_rqvae_codes.npy`` holds an (N_items + 1, L + 1) int table: row i
is dense item i (row 0 is padding), L RQ levels plus a collision-
disambiguation digit (`RQ-VAE/infer.py:149-184`). Written beside it,
``*_mapping.json`` maps each row index to its code list. The other file
contracts of the reference come with the slices that read them.
"""

from __future__ import annotations

import json
import os

import numpy as np


def write_codes(path: str, codes: np.ndarray, write_mapping_json: bool = True) -> None:
    """``course_rqvae_codes.npy`` + ``*_mapping.json`` (RQ-VAE/infer.py:173-184)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    codes = np.asarray(codes)
    np.save(path, codes)
    if write_mapping_json:
        mapping_file = path.replace(".npy", "_mapping.json")
        index_to_code = {i: c.tolist() for i, c in enumerate(codes)}
        with open(mapping_file, "w") as f:
            json.dump(index_to_code, f, indent=2)


def read_codes(path: str) -> np.ndarray:
    return np.load(path)
