"""Leave-one-out evaluation of the hybrid recommender: a copy of
``genrec_tpu/serving/evaluation.py``.

Equivalent of `Baseline/evaluation.py:54-252`: per-user leave-one-out over
the app dataset; Precision/Recall/Hit/NDCG@k; ``use_llm`` toggles the γ
component (off → α=β=0.5 reweighting); ``max_users`` cap with fixed seed.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np

from genrec_tpu_torch.serving.recommend import HybridRecommender


def evaluate_leave_one_out(recommender: HybridRecommender,
                           user_histories: Dict[int, List[int]],
                           user_profiles: Dict[int, str],
                           k: int = 10, max_users: int = 14,
                           seed: int = 42) -> Dict[str, float]:
    rng = random.Random(seed)
    eligible = [u for u, h in user_histories.items() if len(h) >= 2]
    if len(eligible) > max_users:
        eligible = rng.sample(eligible, max_users)

    precisions, recalls, hits, ndcgs = [], [], [], []
    for u in eligible:
        hist = list(user_histories[u])
        target = hist[-1]
        recs = recommender.recommend(hist[:-1], user_profiles.get(u, ""), k)
        rec_ids = [r["item_id"] for r in recs]
        hit = target in rec_ids
        hits.append(1.0 if hit else 0.0)
        precisions.append((1.0 if hit else 0.0) / max(k, 1))
        recalls.append(1.0 if hit else 0.0)  # one relevant item
        if hit:
            rank = rec_ids.index(target) + 1
            ndcgs.append(1.0 / np.log2(rank + 1))
        else:
            ndcgs.append(0.0)

    n = max(len(eligible), 1)
    return {
        f"Precision@{k}": float(np.sum(precisions) / n),
        f"Recall@{k}": float(np.sum(recalls) / n),
        f"Hit@{k}": float(np.sum(hits) / n),
        f"NDCG@{k}": float(np.sum(ndcgs) / n),
        "num_users": len(eligible),
    }
