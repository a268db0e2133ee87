"""Text-embedding toolchain of the port: a copy of the weight-free paths of
``genrec_tpu/encoding/bert_encoders.py``.

- :func:`encode_item_texts` / :func:`encode_user_profiles` —
  `T5/item_encode.py:59-128`: item row 0 is the empty padding text;
- :func:`encode_major_hierarchy` — `major-encode/bert_emb.py:131-168`:
  per-level major-name (or assembled description) embeddings, and
  :func:`load_major_hierarchy_xlsx`, the 3-sheet workbook on the copied
  stdlib reader (``utils/xlsx.py``);
- :func:`user_embedding_from_items` — `major-encode/make_user_embs.py:46-70`;
- :func:`top5_major_retrieval` and :func:`build_prof_lvl_files` —
  `major-encode/top5_major.py:17-63`: cosine top-5 majors per user per level
  → the prof_lvl{1,2,3}.h5 payload;
- :func:`word_drop` — `Baseline/Rec.py:26-37`.

``encoder=None`` embeds with the deterministic hashing fallback
(:func:`_hash_embed`), as the reference does; an encoder object with the
reference's ``encode(texts, pooling=...)`` may be passed instead. The
reference's ``from_pretrained`` BERT path (``BertEncoder``,
``load_quantized_encoder``, ``fetch_pretrained``) needs pretrained weights
that the repository does not hold, and waits until it does.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _hash_embed(texts: Sequence[str], dim: int = 768) -> np.ndarray:
    """Deterministic fallback embedding for offline environments."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        if not t:
            continue
        h = hashlib.sha256(t.encode("utf-8")).digest()
        rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
        out[i] = rng.normal(0, 1, dim).astype(np.float32)
    return out


def word_drop(texts: Sequence[str], ratio: float,
              rng: Optional[np.random.Generator] = None) -> List[str]:
    """Random word-drop augmentation (`Baseline/Rec.py:26-37`): each
    whitespace token is kept with probability ``1 - ratio``."""
    rng = rng or np.random.default_rng(0)
    out = []
    for t in texts:
        words = t.split(" ")
        keep = rng.random(len(words)) > ratio
        out.append(" ".join(w for w, k in zip(words, keep) if k))
    return out


def encode_item_texts(item_info: Dict[int, str], encoder=None, dim: int = 768,
                      word_drop_ratio: float = -1.0, seed: int = 0) -> np.ndarray:
    """(max_item_id+1, D) table; row 0 = empty padding text
    (`T5/item_encode.py:96-101`). ``word_drop_ratio > 0`` applies the
    Baseline's augmentation (`Baseline/Rec.py:9-52`) before encoding."""
    max_id = max(item_info) if item_info else 0
    order_texts = ["" if k == 0 else item_info.get(k, "")
                   for k in range(max_id + 1)]
    if word_drop_ratio > 0:
        order_texts = word_drop(order_texts, word_drop_ratio,
                                np.random.default_rng(seed))
    if encoder is None:
        return _hash_embed(order_texts, dim)
    return encoder.encode(order_texts, pooling="mean_no_cls")


def encode_user_profiles(user_profile_map: Dict[int, str], encoder=None,
                         dim: int = 768) -> np.ndarray:
    """(N, D) in user_id order — [CLS] embedding of the profile text
    (`T5/item_encode.py:11-34`)."""
    uids = sorted(user_profile_map)
    texts = [user_profile_map[u] for u in uids]
    if encoder is None:
        return _hash_embed(texts, dim)
    return encoder.encode(texts, pooling="cls")


def encode_major_hierarchy(levels: Sequence[Sequence[Tuple[str, ...]]], encoder=None,
                           dim: int = 768) -> List[Dict[str, np.ndarray]]:
    """[(code, name[, text])...] per level → per-level {codes, names, embs}
    (`major-encode/bert_emb.py:131-168`). When a row carries an assembled
    description text (third element — the Excel ingestion path,
    :func:`load_major_hierarchy_xlsx`), that text is encoded; otherwise the
    name is."""
    out = []
    for level in levels:
        codes = [row[0] for row in level]
        names = [row[1] for row in level]
        texts = [row[2] if len(row) > 2 and row[2] else row[1]
                 for row in level]
        embs = (_hash_embed(texts, dim) if encoder is None
                else encoder.encode(texts, pooling="mean_no_cls"))
        out.append({"codes": np.array(codes, dtype=object),
                    "names": np.array(names, dtype=object),
                    "embs": embs})
    return out


def load_major_hierarchy_xlsx(path: str) -> List[List[Tuple[str, str, str]]]:
    """3-sheet major-hierarchy workbook → [(code, name, text)...] ×3.

    Semantics of `major-encode/bert_emb.py:50-124` on sheets
    Level1/Level2/Level3 (header row skipped, rows with empty code
    dropped):
    - Level1: text = intro + "大类通识课程：" + general courses,
    - Level2: text = intro + "专业核心课程：" + core courses (one row per
      分流专业 — duplicate codes are kept),
    - Level3: text = the intro column, falling back to the name when empty.

    Implemented on the stdlib xlsx reader (`genrec_tpu_torch.utils.xlsx`) —
    openpyxl is not required.
    """
    from genrec_tpu_torch.utils.xlsx import Workbook

    wb = Workbook(path)
    try:
        out: List[List[Tuple[str, str, str]]] = []
        for sheet, course_label in (("Level1", "大类通识课程："),
                                    ("Level2", "专业核心课程："),
                                    ("Level3", None)):
            rows: List[Tuple[str, str, str]] = []
            for row in wb.rows(sheet)[1:]:  # skip header
                row = list(row) + [None] * (4 - len(row))
                code, name, intro, courses = row[:4]
                if code is None:
                    continue
                if course_label is None:  # Level3
                    text = str(intro).strip() if intro else str(name)
                else:
                    parts = []
                    if intro:
                        parts.append(str(intro))
                    if courses:
                        parts.append(course_label + str(courses))
                    text = " ".join(parts)
                rows.append((str(code), str(name), text))
            out.append(rows)
        return out
    finally:
        wb.close()


def user_embedding_from_items(item_embs: np.ndarray,
                              history: Sequence[int]) -> np.ndarray:
    """Mean of item embeddings, excluding the last item when ≥2
    (`major-encode/make_user_embs.py:46-70`)."""
    hist = list(history)
    if len(hist) >= 2:
        hist = hist[:-1]
    if not hist:
        return np.zeros(item_embs.shape[1], np.float32)
    return item_embs[hist].mean(axis=0).astype(np.float32)


def top5_major_retrieval(user_vecs: np.ndarray, major_embs: np.ndarray,
                         top_k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine top-k majors per user → (indices (N,k), embs (N,k,D))
    (`major-encode/top5_major.py:17-51`)."""
    def _norm(m):
        return m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)

    sims = _norm(user_vecs) @ _norm(major_embs).T  # (N, M)
    k = min(top_k, sims.shape[1])
    part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    # sort the top-k by similarity descending (top5_major.py argpartition+sort)
    row_sims = np.take_along_axis(sims, part, axis=1)
    order = np.argsort(-row_sims, axis=1)
    idx = np.take_along_axis(part, order, axis=1)
    embs = major_embs[idx]
    if k < top_k:  # pad to the contract's fixed width
        pad = top_k - k
        idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        embs = np.pad(embs, ((0, 0), (0, pad), (0, 0)))
    return idx, embs.astype(np.float32)


def build_prof_lvl_files(user_ids: np.ndarray, user_vecs: np.ndarray,
                         level_embs: Sequence[np.ndarray],
                         paths: Sequence[str]) -> None:
    """Write prof_lvl{1,2,3}.h5 (`major-encode/top5_major.py:54-63`)."""
    from genrec_tpu_torch.data.contracts import write_prof_lvl
    for embs, path in zip(level_embs, paths):
        _, top = top5_major_retrieval(user_vecs, embs)
        write_prof_lvl(path, user_ids, top)
