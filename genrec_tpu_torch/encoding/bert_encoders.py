"""Text embeddings of the port: a copy of the deterministic hashing
fallback of ``genrec_tpu/encoding/bert_encoders.py`` (``_hash_embed``,
:29-38), which the backend's mini-RAG embeds with. The HF BERT encoders of
that module (``from_pretrained``) are still to port (ROADMAP Queue 1
item 5)."""

from __future__ import annotations

import hashlib
from typing import Sequence

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
