"""LLM-hybrid recommender (the `Baseline/direct_rec.py` capability): a copy
of ``genrec_tpu/serving/recommend.py``, which imports no JAX.

Score(candidate) = α·keyword-match + β·embedding-similarity + γ·LLM-match,
each min-max normalized over the candidate set
(`Baseline/direct_rec.py:417-477`):

- keyword match `f_mat` (`:195-203`): Σ |pos-keywords ∩ pos-history-keywords|
  − Σ |neg-keywords ∩ neg-history-keywords| over labeled history,
- embedding similarity `f_sim` (`:206-219`): max cosine to positive history
  minus max cosine to negative history — vectorized here over the whole
  candidate set as two matmuls (the reference loops per candidate),
- LLM score (`:240-269`): generated recommendation text matched to
  candidate names by embedding cosine. The LLM client is injected and
  env-configured (GENREC_LLM_API_KEY / GENREC_LLM_BASE_URL) — the
  reference hard-codes an API key at `Baseline/Rec.py:6-7`, which we
  deliberately do not reproduce.

Cold-start (`:155-192`): no history → LLM generation from profile, or the
head of the item pool without an LLM.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

LLMClient = Callable[[str, str], str]  # (user_prompt, system_prompt) -> text


@dataclasses.dataclass
class ItemCatalog:
    item_pool: List[int]
    item_names: Dict[int, str]
    item_keywords_pos: Dict[int, Set[str]]
    item_keywords_neg: Dict[int, Set[str]]
    item_content: Dict[int, str]
    item_url: Dict[int, str]
    item_embeddings: np.ndarray  # (max_id+1, D); row 0 = padding

    @classmethod
    def from_recommendation_data(cls, classes: Dict[str, np.ndarray],
                                 item_embeddings: np.ndarray) -> "ItemCatalog":
        ids = [int(i) for i in classes["class_ids"]]
        split = lambda s: {w.strip() for w in str(s).replace("，", ",").split(",")
                           if w.strip()}
        return cls(
            item_pool=ids,
            item_names={i: str(n) for i, n in zip(ids, classes["class_names"])},
            item_keywords_pos={i: split(k) for i, k in zip(ids, classes["keywords_pos"])},
            item_keywords_neg={i: split(k) for i, k in zip(ids, classes["keywords_neg"])},
            item_content={i: str(c) for i, c in zip(ids, classes.get("content", [""] * len(ids)))},
            item_url={i: str(u) for i, u in zip(ids, classes.get("url", [""] * len(ids)))},
            item_embeddings=np.asarray(item_embeddings, dtype=np.float32),
        )


def f_mat(history: Sequence[Tuple[int, int]], candidate: int,
          kw_pos: Dict[int, Set[str]], kw_neg: Dict[int, Set[str]]) -> float:
    """Keyword-match score (`Baseline/direct_rec.py:195-203`)."""
    pos_hist = [i for i, fb in history if fb == 1]
    neg_hist = [i for i, fb in history if fb == 0]
    dpos = kw_pos.get(candidate, set())
    dneg = kw_neg.get(candidate, set())
    a_pos = sum(len(dpos & kw_pos.get(i, set())) for i in pos_hist)
    a_neg = sum(len(dneg & kw_neg.get(i, set())) for i in neg_hist)
    return float(a_pos - a_neg)


def f_sim_batch(history: Sequence[Tuple[int, int]], candidates: Sequence[int],
                item_embeddings: np.ndarray) -> np.ndarray:
    """Vectorized embedding-similarity scores for all candidates at once
    (semantics of `Baseline/direct_rec.py:206-219`, two matmuls instead of
    a per-candidate Python loop)."""
    def _norm(m):
        n = np.linalg.norm(m, axis=-1, keepdims=True)
        return m / np.maximum(n, 1e-12)

    cand = _norm(item_embeddings[list(candidates)])
    pos_hist = [i for i, fb in history if fb == 1]
    neg_hist = [i for i, fb in history if fb == 0]
    beta_pos = np.zeros(len(candidates))
    beta_neg = np.zeros(len(candidates))
    if pos_hist:
        beta_pos = (cand @ _norm(item_embeddings[pos_hist]).T).max(axis=1)
    if neg_hist:
        beta_neg = (cand @ _norm(item_embeddings[neg_hist]).T).max(axis=1)
    return beta_pos - beta_neg


def normalize_scores(scores: Sequence[float]) -> List[float]:
    """Min-max normalize (`Baseline/direct_rec.py:451-459`)."""
    scores = list(scores)
    if not scores:
        return scores
    lo, hi = min(scores), max(scores)
    if hi > lo:
        return [(s - lo) / (hi - lo) for s in scores]
    return [0.0] * len(scores)


def get_user_history_labels(user_history: Sequence[int],
                            candidate_items: Sequence[int],
                            rng: Optional[random.Random] = None
                            ) -> List[Tuple[int, int]]:
    """Positive history + equally many sampled negatives
    (`Baseline/direct_rec.py:400-415`)."""
    rng = rng or random
    positives = [(i, 1) for i in user_history]
    n = len(user_history)
    negs = list(candidate_items) if len(candidate_items) < n else \
        rng.sample(list(candidate_items), n)
    return positives + [(i, 0) for i in negs]


def match_text_to_items(text: str, candidates: Sequence[int],
                        item_names: Dict[int, str],
                        text_encoder: Optional[Callable[[List[str]], np.ndarray]]
                        ) -> List[Tuple[int, float]]:
    """Cosine-match generated text to candidate names
    (`Baseline/direct_rec.py:370-398`). Without an encoder, fall back to
    token-overlap Jaccard (keeps the path dependency-free)."""
    names = [item_names.get(c, "") for c in candidates]
    if text_encoder is not None:
        vecs = text_encoder([text] + names)
        q, m = vecs[0:1], vecs[1:]
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        m = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
        sims = (m @ q.T)[:, 0]
        return list(zip(candidates, sims.tolist()))
    t = set(text.lower().split())
    out = []
    for c, name in zip(candidates, names):
        w = set(str(name).lower().split())
        out.append((c, len(t & w) / max(len(t | w), 1)))
    return out


def make_env_llm_client() -> Optional[LLMClient]:
    """LLM chat client from env config; None when unset.

    Supports the reference's dual endpoint formats
    (`Baseline/direct_rec.py:271-368`): OpenAI-compatible
    ``/chat/completions`` (default) and DashScope-native generation
    (``GENREC_LLM_API_FORMAT=dashscope`` or a dashscope base URL),
    whose response carries ``output.text`` / ``output.choices``.
    """
    api_key = os.environ.get("GENREC_LLM_API_KEY")
    base_url = os.environ.get("GENREC_LLM_BASE_URL")
    model = os.environ.get("GENREC_LLM_MODEL", "qwen-plus")
    fmt = os.environ.get("GENREC_LLM_API_FORMAT",
                         "dashscope" if base_url and "dashscope" in base_url
                         else "openai")
    if not api_key or not base_url:
        return None

    def client(user_prompt: str, system_prompt: str) -> str:
        import json
        import urllib.request
        messages = [{"role": "system", "content": system_prompt},
                    {"role": "user", "content": user_prompt}]
        if fmt == "dashscope":
            url = (base_url.rstrip("/") +
                   "/services/aigc/text-generation/generation")
            payload = {"model": model, "input": {"messages": messages},
                       "parameters": {"result_format": "message"}}
        else:
            url = base_url.rstrip("/") + "/chat/completions"
            payload = {"model": model, "messages": messages}
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Authorization": f"Bearer {api_key}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        if fmt == "dashscope":
            out = body.get("output", {})
            if out.get("choices"):
                return out["choices"][0]["message"]["content"]
            return out.get("text", "")
        return body["choices"][0]["message"]["content"]

    return client


@dataclasses.dataclass
class HybridRecommender:
    """The `recommender(userid, topk)` capability
    (`Baseline/direct_rec.py:108-192`)."""

    catalog: ItemCatalog
    llm_client: Optional[LLMClient] = None
    text_encoder: Optional[Callable[[List[str]], np.ndarray]] = None
    alpha: float = 0.1
    beta: float = 0.2
    gamma: float = 0.7
    seed: Optional[int] = None

    def recommend_top_k(self, user_history: Sequence[int], user_profile: str,
                        k: int = 10) -> List[Dict[str, str]]:
        cat = self.catalog
        candidates = [i for i in cat.item_pool if i not in set(user_history)]
        if not candidates:
            return []
        rng = random.Random(self.seed) if self.seed is not None else random
        labels = get_user_history_labels(user_history, candidates, rng)

        mat = [f_mat(labels, c, cat.item_keywords_pos, cat.item_keywords_neg)
               for c in candidates]
        sim = f_sim_batch(labels, candidates, cat.item_embeddings).tolist()

        alpha, beta, gamma = self.alpha, self.beta, self.gamma
        if self.llm_client is not None:
            text = self._llm_generate(user_history, user_profile, k)
            llm = [s for _, s in match_text_to_items(
                text, candidates, cat.item_names, self.text_encoder)]
        else:
            # no LLM configured: reweight to keyword+embedding only, the
            # `use_llm=False` mode of `Baseline/evaluation.py:54-62`
            llm = [0.0] * len(candidates)
            alpha, beta, gamma = 0.5, 0.5, 0.0

        total = [alpha * m + beta * s + gamma * l for m, s, l in
                 zip(normalize_scores(mat), normalize_scores(sim),
                     normalize_scores(llm))]
        order = sorted(zip(candidates, total), key=lambda x: x[1], reverse=True)
        return [{"item_id": c, "name": cat.item_names.get(c, f"course_{c}"),
                 "url": cat.item_url.get(c, ""), "score": float(s)}
                for c, s in order[:k]]

    def recommend(self, user_history: Sequence[int], user_profile: str,
                  k: int = 10) -> List[Dict[str, str]]:
        """History → hybrid path; empty history → cold start
        (`Baseline/direct_rec.py:143-192`)."""
        if user_history:
            return self.recommend_top_k(user_history, user_profile, k)
        cat = self.catalog
        if self.llm_client is not None and user_profile:
            text = self.llm_client(
                COLD_START_USER_PROMPT.format(
                    major=user_profile
                    or "未提供专业信息，请基于通用技术发展趋势推荐",
                    interests=user_profile
                    or "未提供兴趣信息，请基于专业发展需求推荐"),
                SYSTEM_PROMPT_COLD_START)
            sims = match_text_to_items(text, cat.item_pool, cat.item_names,
                                       self.text_encoder)
            sims.sort(key=lambda x: x[1], reverse=True)
            picks = [c for c, _ in sims[:k]]
        else:
            picks = cat.item_pool[:k]
        return [{"item_id": c, "name": cat.item_names.get(c, f"course_{c}"),
                 "url": cat.item_url.get(c, ""), "score": 0.0} for c in picks]

    def _llm_generate(self, user_history, user_profile, k) -> str:
        # the reference sends the full item *content* text for liked items
        # (`direct_rec.py:243`), falling back to the name when absent
        texts = [self.catalog.item_content.get(i)
                 or self.catalog.item_names.get(i, "") for i in user_history]
        pos = "\n".join(f"  - {t}" for t in texts) or "  - 无相关历史记录"
        prompt = REGULAR_USER_PROMPT.format(
            profile=user_profile or "暂无用户画像信息，请基于交互历史进行推断",
            pos_items=pos)
        return self.llm_client(prompt, SYSTEM_PROMPT_REGULAR.format(k=k))


# Prompt templates reproduced verbatim from the reference
# (`Baseline/prompts/system_prompt_regular_user.txt`,
#  `Baseline/prompts/system_prompt_cold_start.txt`; user prompts from
#  `Baseline/direct_rec.py:226-233,256-263`) — the LLM arm's prompt
# engineering is part of the baseline's behavior surface.
SYSTEM_PROMPT_REGULAR = """你是一个专业的人工智能领域学习资源推荐系统，请综合分析用户画像和历史交互行为，为该学生推荐{k}个合适的学习资源。

推荐策略要求：

核心原则
1. **双重考量**：必须同时考虑用户画像特征和历史学习偏好
2. **个性化匹配**：推荐内容应与学生的专业背景、兴趣爱好和学习目标高度匹配
3. **偏好学习**：深度分析学生喜欢内容的共同特征，识别学习偏好模式
4. **规避策略**：避免推荐与学生不喜欢内容相似的资源类型

输出格式
请严格按照以下格式输出推荐的学习资源：

**[资源标题]**
   - 关键词：[3-5个描述该资源内容的核心关键词]

注意事项
- 生成的学习资源应该是具体的论文、课程、博客或技术文档
- 避免重复推荐相似内容
- 如果专业或兴趣信息不够具体，请基于常见的专业发展路径进行推荐"""

SYSTEM_PROMPT_COLD_START = """你是一个专业的人工智能领域学习资源推荐系统，专门为新用户提供个性化的学习资源推荐。

推荐策略要求：

核心原则
1. **专业匹配**：根据用户的专业背景，推荐与该专业高度相关的学习资源
2. **兴趣导向**：结合用户的兴趣标签，确保推荐内容能够激发学习兴趣
3. **多样性平衡**：推荐内容应涵盖该专业的核心领域和前沿技术
4. **实用性优先**：推荐具体的、可操作的学习资源，避免过于抽象的概念


输出格式
请严格按照以下格式输出推荐的学习资源：

**[资源标题]**
   - 关键词：[3-5个描述该资源内容的核心关键词]


注意事项
- 生成的学习资源应该是具体的论文、课程、博客或技术文档
- 避免重复推荐相似内容
- 如果专业或兴趣信息不够具体，请基于常见的专业发展路径进行推荐"""

REGULAR_USER_PROMPT = """## 学生信息
    ### 用户画像
    {profile}
    ### 历史学习偏好分析
    **该学生喜欢的学习资源内容：**
    {pos_items}
    请根据以上信息为该学生推荐合适的学习资源。"""

COLD_START_USER_PROMPT = """## 新用户信息

### 用户专业背景
专业：{major}

### 用户兴趣标签
兴趣标签：{interests}

请生成推荐内容："""
