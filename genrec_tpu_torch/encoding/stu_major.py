"""Alternative student-vector path: per-interaction BERT vectors → mean →
top-5 major retrieval; the port's copy of ``genrec_tpu/encoding/stu_major.py``.

Equivalent of `stu-major/stu_major.py:55-128`: reads an interaction CSV
whose rows carry a serialized per-record BERT vector column (auto-detected
by name), averages per student, and retrieves the top-k majors per level
via cosine similarity → the prof_lvl{1,2,3}.h5 payload.
"""

from __future__ import annotations

import ast
import csv
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EMB_DIM = 768


def _find_bert_column(header: Sequence[str]) -> Optional[str]:
    for col in header:
        c = col.strip().lower()
        if "bert" in c and "vector" in c:
            return col
    return None


def load_student_matrix(csv_path: str, emb_dim: int = EMB_DIM
                        ) -> Tuple[List[str], np.ndarray]:
    """Per-student mean of valid per-interaction vectors
    (`stu_major.py:58-100`); invalid/missing vectors are skipped, students
    with none get a zero vector. Student order = first appearance."""
    by_student: Dict[str, List[np.ndarray]] = {}
    order: List[str] = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        bert_col = _find_bert_column(reader.fieldnames or [])
        if bert_col is None:
            raise ValueError(
                f"no BERT vector column found; columns: {reader.fieldnames}")
        for row in reader:
            sid = (row.get("student_id") or "").strip()
            if not sid:
                continue
            if sid not in by_student:
                by_student[sid] = []
                order.append(sid)
            raw = row.get(bert_col)
            if not raw:
                continue
            try:
                v = np.asarray(ast.literal_eval(raw), dtype=np.float32)
            except (ValueError, SyntaxError):
                continue
            if v.shape == (emb_dim,):
                by_student[sid].append(v)

    mat = np.stack([
        np.mean(by_student[s], axis=0) if by_student[s]
        else np.zeros(emb_dim, np.float32)
        for s in order
    ]) if order else np.zeros((0, emb_dim), np.float32)
    return order, mat


def retrieve_top_k(student_matrix: np.ndarray, prof_embs: np.ndarray,
                   top_k: int = 5):
    """Cosine top-k: (vecs (N,K,D), indices (N,K), sims (N,K))
    (`stu_major.py:106-128`)."""
    def _norm(m):
        return m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)

    sims = _norm(student_matrix) @ _norm(prof_embs).T
    idx = np.argsort(sims, axis=1)[:, -top_k:][:, ::-1]
    top_sims = np.take_along_axis(sims, idx, axis=1)
    return prof_embs[idx], idx, top_sims


def build_prof_files_from_csv(csv_path: str, level_embs: Sequence[np.ndarray],
                              out_paths: Sequence[str], top_k: int = 5) -> None:
    """CSV student vectors → prof_lvl{1,2,3}.h5 files (end-to-end driver)."""
    from genrec_tpu_torch.data.contracts import write_prof_lvl
    sids, mat = load_student_matrix(csv_path)
    user_ids = np.arange(1, len(sids) + 1, dtype=np.int32)
    for embs, path in zip(level_embs, out_paths):
        vecs, _, _ = retrieve_top_k(mat, embs, top_k)
        write_prof_lvl(path, user_ids, vecs.astype(np.float32))
