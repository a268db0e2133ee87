"""Backend services: AI chat (mini-RAG + env-configured LLM) and the
text-organization processing pipeline.

Reference: `backend/app/services/ai_service.py:16-119` (OpenRouter chat
completions with regex sentence chunking + MiniLM cosine top-3 context
injection) and `backend/app/services/text_organization_service.py`
(mock processing pipeline).

Differences by design:
- **No hard-coded API key** (the reference embeds one at
  `ai_service.py:21`); the client is configured from
  ``GENREC_LLM_API_KEY`` / ``GENREC_LLM_BASE_URL`` / ``GENREC_LLM_MODEL``
  and the route degrades to 503 when unset.
- The RAG embedder is :mod:`genrec_tpu_torch.encoding`'s deterministic
  hashing embedding (``_hash_embed``) instead of a downloaded MiniLM.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np

from genrec_tpu_torch.backend.db import Database, utcnow_iso
from genrec_tpu_torch.backend.utils import ApiError, get_logger

logger = get_logger("genrec_backend.services")

EmbedFn = Callable[[List[str]], np.ndarray]
LLMFn = Callable[[List[Dict[str, str]]], str]  # messages -> answer


def default_embed_fn(texts: List[str]) -> np.ndarray:
    from genrec_tpu_torch.encoding.bert_encoders import _hash_embed
    return _hash_embed(texts, dim=256)


def make_env_llm() -> Optional[LLMFn]:
    """OpenAI-compatible chat-completions client from env, or None.

    Mirrors the request shape of `ai_service.py:65-111` (messages =
    history + final user question) without the hard-coded key.
    """
    import os
    api_key = os.environ.get("GENREC_LLM_API_KEY")
    base_url = os.environ.get("GENREC_LLM_BASE_URL")
    model = os.environ.get("GENREC_LLM_MODEL", "")
    if not api_key or not base_url:
        return None

    def call(messages: List[Dict[str, str]]) -> str:
        import httpx
        resp = httpx.post(
            base_url.rstrip("/") + "/chat/completions",
            headers={"Authorization": f"Bearer {api_key}",
                     "Content-Type": "application/json"},
            json={"model": model, "messages": messages}, timeout=60.0)
        resp.raise_for_status()
        out = resp.json()
        if not out.get("choices") or not out["choices"][0].get("message"):
            raise ValueError("invalid LLM API response")
        return out["choices"][0]["message"]["content"]

    return call


class AIService:
    """Chat with optional retrieval over a caller-provided document."""

    def __init__(self, llm: Optional[LLMFn] = None,
                 embed_fn: EmbedFn = default_embed_fn):
        self.llm = llm
        self.embed_fn = embed_fn

    @staticmethod
    def split_text_into_chunks(text: str, max_chunk_size: int = 500) -> List[str]:
        """Sentence-boundary chunking (CJK + latin punctuation), greedy
        packing to ``max_chunk_size`` chars (`ai_service.py:25-42`)."""
        sentences = re.split(r"(?<=[.!?。！？\n])\s+", text)
        chunks: List[str] = []
        cur = ""
        for s in sentences:
            if len(cur) + len(s) <= max_chunk_size:
                cur += s + " "
            else:
                if cur.strip():
                    chunks.append(cur.strip())
                cur = s + " "
        if cur.strip():
            chunks.append(cur.strip())
        return chunks

    def get_relevant_context(self, question: str, document_text: str,
                             top_k: int = 3) -> str:
        """Cosine top-k chunks for the question (`ai_service.py:44-63`)."""
        chunks = self.split_text_into_chunks(document_text)
        if not chunks:
            return ""
        embs = self.embed_fn([question] + chunks)
        q, c = embs[:1], embs[1:]

        def _norm(m):
            return m / np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-9)

        sims = (_norm(q) @ _norm(c).T)[0]
        top = np.argsort(sims)[-top_k:][::-1]
        return "\n".join(chunks[i] for i in top)

    def ask(self, question: str, document_text: Optional[str] = None,
            history: Optional[List[Dict[str, str]]] = None) -> str:
        if self.llm is None:
            raise ApiError(503, "LLM client not configured "
                                "(set GENREC_LLM_API_KEY / GENREC_LLM_BASE_URL)")
        final_question = question
        if document_text:
            try:
                ctx = self.get_relevant_context(question, document_text)
                if ctx:
                    final_question = (
                        "请根据以下上下文回答问题。\n\n上下文：\n---\n"
                        f"{ctx}\n---\n\n问题：{question}")
            except Exception as e:  # RAG failure degrades to plain chat
                logger.warning("RAG retrieval failed: %s", e)
        messages = list(history or [])
        messages.append({"role": "user", "content": final_question})
        try:
            return self.llm(messages)
        except ApiError:
            raise
        except Exception as e:
            logger.error("LLM call failed: %s", e)
            raise ApiError(502, "AI服务暂时不可用")


class TextOrganizationService:
    """Document upload + deterministic processing pipeline.

    The reference's service (`text_organization_service.py`, 312 LoC)
    mocks its processing; here the documents live in the
    ``knowledge_base`` table and "processing" computes real summary
    statistics + an extractive first-sentences summary, deterministic
    for tests.
    """

    def __init__(self, db: Database):
        self.db = db
        self._tasks: Dict[int, Dict] = {}
        self._next_task = 1

    def upload(self, file_name: str, file_type: str, content: str) -> Dict:
        doc_id = self.db.insert("knowledge_base", {
            "document_name": file_name, "uploader": "api",
            "document_content": content, "upload_time": utcnow_iso()})
        return {"document_id": doc_id, "file_name": file_name,
                "file_type": file_type, "size": len(content),
                "uploaded_at": utcnow_iso()}

    def start_processing(self, document_id: int, operations: List[str]) -> Dict:
        doc = self.db.query_one(
            "SELECT * FROM knowledge_base WHERE id=?", (document_id,))
        if doc is None:
            raise ApiError(404, f"document {document_id} not found")
        task_id = self._next_task
        self._next_task += 1
        text = doc["document_content"]
        sentences = [s for s in re.split(r"(?<=[.!?。！？])\s*", text) if s]
        result = {
            "document_id": document_id,
            "operations": operations,
            "summary": " ".join(sentences[:3]),
            "num_sentences": len(sentences),
            "num_chars": len(text),
            "keywords": sorted({w for w in re.findall(r"[\w一-鿿]{2,}",
                                                      text)})[:10],
        }
        self._tasks[task_id] = {"task_id": task_id, "status": "completed",
                                "progress": 100, "result": result,
                                "created_at": utcnow_iso()}
        return {"task_id": task_id, "status": "completed"}

    def status(self, task_id: int) -> Dict:
        t = self._tasks.get(task_id)
        if t is None:
            raise ApiError(404, f"task {task_id} not found")
        return {"task_id": task_id, "status": t["status"],
                "progress": t["progress"]}

    def results(self, task_id: int) -> Dict:
        t = self._tasks.get(task_id)
        if t is None:
            raise ApiError(404, f"task {task_id} not found")
        return {"task_id": task_id, "status": t["status"],
                "results": t["result"]}

    def documents(self, page: int = 1, page_size: int = 10) -> Dict:
        total = self.db.count("knowledge_base")
        rows = self.db.query(
            "SELECT id, document_name, uploader, upload_time, "
            "LENGTH(document_content) AS size FROM knowledge_base "
            "ORDER BY id LIMIT ? OFFSET ?",
            (page_size, (page - 1) * page_size))
        return {"total": total, "page": page, "page_size": page_size,
                "documents": rows}

    def history(self, page: int = 1, page_size: int = 10) -> Dict:
        tasks = sorted(self._tasks.values(), key=lambda t: t["task_id"])
        lo = (page - 1) * page_size
        return {"total": len(tasks), "page": page,
                "history": [{k: t[k] for k in
                             ("task_id", "status", "created_at")}
                            for t in tasks[lo:lo + page_size]]}

    def delete_document(self, document_id: int) -> None:
        if self.db.query_one("SELECT id FROM knowledge_base WHERE id=?",
                             (document_id,)) is None:
            raise ApiError(404, f"document {document_id} not found")
        self.db.execute("DELETE FROM knowledge_base WHERE id=?", (document_id,))

    def stats(self) -> Dict:
        return {"total_documents": self.db.count("knowledge_base"),
                "total_tasks": len(self._tasks),
                "completed_tasks": sum(1 for t in self._tasks.values()
                                       if t["status"] == "completed")}
