"""FastAPI serving surface of the port: a copy of ``genrec_tpu/serving/app.py``
with ``make_sasrec_recommend_fn`` ported to torch.

Equivalent of the reference backend (`backend/app/main.py:29-127`) reduced
to the recommendation-relevant surface plus health/chat scaffolding —
and extended with what the reference *lacks*: an actual HTTP
recommendation route backed by the trained models (the reference's
`Baseline/recommender()` is never wired to a route, SURVEY.md §2.4).

Routes:
- GET  /health, GET /
- POST /api/v1/recommend          — hybrid recommender (history+profile)
- POST /api/v1/recommend/model    — model-backed (SASRec or TIGER artifacts)
- POST /api/v1/chat/ask           — LLM chat (env-configured; 503 when unset)
- GET  /api/v1/courses            — course catalog from the shared data

FastAPI is imported lazily so the core framework has no hard dependency.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


def create_app(recommender=None, model_recommend_fn: Optional[Callable] = None,
               catalog=None, llm_client=None):
    from fastapi import FastAPI, HTTPException
    from fastapi.middleware.cors import CORSMiddleware
    from pydantic import BaseModel

    app = FastAPI(title="genrec-tpu", version="0.1.0")
    app.add_middleware(
        CORSMiddleware,
        allow_origins=[f"http://localhost:{p}" for p in range(3000, 3006)],
        allow_methods=["*"], allow_headers=["*"],
    )

    class RecommendRequest(BaseModel):
        user_id: Optional[int] = None
        history: List[int] = []
        profile: str = ""
        top_k: int = 10

    class ChatRequest(BaseModel):
        question: str
        context: Optional[str] = None

    @app.get("/")
    def root():
        return {"app": "genrec-tpu", "status": "running"}

    @app.get("/health")
    def health():
        return {"status": "healthy"}

    @app.post("/api/v1/recommend")
    def recommend(req: RecommendRequest):
        if recommender is None:
            raise HTTPException(503, "hybrid recommender not configured")
        recs = recommender.recommend(req.history, req.profile, req.top_k)
        return {"success": True, "data": recs}

    @app.post("/api/v1/recommend/model")
    def recommend_model(req: RecommendRequest):
        if model_recommend_fn is None:
            raise HTTPException(503, "model recommender not configured")
        items = model_recommend_fn(req.history, req.top_k)
        return {"success": True, "data": [{"item_id": int(i)} for i in items]}

    @app.get("/api/v1/courses")
    def courses():
        if catalog is None:
            raise HTTPException(503, "catalog not configured")
        return {"success": True, "data": [
            {"item_id": i, "name": catalog.item_names.get(i, ""),
             "url": catalog.item_url.get(i, "")} for i in catalog.item_pool]}

    @app.post("/api/v1/chat/ask")
    def chat(req: ChatRequest):
        if llm_client is None:
            raise HTTPException(503, "LLM client not configured "
                                     "(set GENREC_LLM_API_KEY / GENREC_LLM_BASE_URL)")
        answer = llm_client(req.question,
                            "You are a helpful education assistant.")
        return {"success": True, "data": {"answer": answer}}

    @app.get("/api/v1/chat/suggestions")
    def suggestions():
        return {"success": True, "data": [
            "推荐一些机器学习入门课程", "我适合学什么专业课？",
            "根据我的历史推荐下一门课",
        ]}

    return app


def make_sasrec_recommend_fn(model, max_len: int):
    """Model-backed top-k: last-step features · item table, history masked.

    ``model`` is a ``models.sasrec.SASRec`` on its device. The semantics are
    the JAX function's (`genrec_tpu/serving/app.py:98-119`): the last
    ``max_len`` ids of the history, raw, left-padded into an int32 row; the
    padding row and every history id in [0, I] at −1e9; an argsort of the
    whole vocabulary. An id the table does not hold is never put on the
    card: JAX's gather wraps a negative id in [−(I+1), 0) to the table's end
    and fills an id outside [−(I+1), I] with NaN, so its row here is
    gathered at the wrapped index or set to NaN on the device, and the
    logits come out as JAX's do (all NaN when a NaN row lies in the window,
    which NumPy's argsort puts after the −1e9 entries). Unlike the JAX
    function as it stands, it copies the logits before masking them: NumPy's
    view of a ``jax.Array`` is read-only, so there ``logits[0] = -1e9``
    raises on every call.
    """
    import torch

    dev = model.item_emb.weight.device
    n = model.item_emb.weight.shape[0]

    @torch.no_grad()
    def fn(history: List[int], top_k: int) -> List[int]:
        seq = np.zeros((1, max_len), np.int32)
        h = history[-max_len:]
        if h:
            seq[0, -len(h):] = h
        held = (seq >= -n) & (seq < n)
        rows = np.where(held, np.where(seq < 0, seq + n, seq), 0)
        emb = model.item_emb.weight[torch.from_numpy(rows.astype(np.int64)).to(dev)]
        emb = emb * torch.from_numpy(seq != 0).to(dev)[..., None]
        emb = torch.where(torch.from_numpy(~held).to(dev)[..., None],
                          torch.full_like(emb, float("nan")), emb)
        feats = model.encode(emb)[:, -1, :]
        logits = (feats @ model.item_emb.weight.T)[0].cpu().numpy().copy()
        logits[0] = -1e9
        for i in history:
            if 0 <= i < len(logits):
                logits[i] = -1e9
        return np.argsort(-logits)[:top_k].tolist()

    return fn
