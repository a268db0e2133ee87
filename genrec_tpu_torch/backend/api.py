"""All HTTP route handlers, framework-agnostic.

Reference routers under `backend/app/api/v1/` (`__init__.py:10-18`
mounts them at `/api/v1` plus a legacy `/api` prefix):
chat `chat.py:16-61`; text-organization `text_organization.py:27-246`;
ppt-creation `ppt_creation.py:20-231`; lesson-plan
`lesson_plan.py:40-238`; learning-path `learning_path.py:38-221`;
homework-grading `homework_grading.py:19-94`; file-upload
`file_upload.py:8-23`; app factory + root/health `app/main.py:29-127`.
Like the reference, the content-generation routes return deterministic
mocked payloads; only chat reaches a real LLM (env-configured here).

Each handler is ``fn(ctx, path_params, query, body) -> (status, payload)``
so both HTTP adapters in :mod:`genrec_tpu_torch.backend.server` (stdlib and
FastAPI) dispatch through the same table.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from genrec_tpu_torch.backend.config import Settings
from genrec_tpu_torch.backend.db import Database, utcnow_iso
from genrec_tpu_torch.backend.services import AIService, TextOrganizationService
from genrec_tpu_torch.backend.utils import ApiError, success_response

Handler = Callable[["AppContext", Dict[str, str], Dict[str, str], Dict[str, Any]],
                   Tuple[int, Dict[str, Any]]]


@dataclass
class AppContext:
    settings: Settings
    db: Database
    ai: AIService
    textorg: TextOrganizationService
    recommender: Any = None          # genrec_tpu_torch.serving.recommend.HybridRecommender
    model_recommend_fn: Any = None   # fn(history, top_k) -> [item_id]
    catalog: Any = None              # genrec_tpu_torch.serving.recommend.ItemCatalog
    state: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def create(cls, settings: Optional[Settings] = None,
               db: Optional[Database] = None, llm=None, **kw) -> "AppContext":
        from genrec_tpu_torch.backend.services import make_env_llm
        settings = settings or Settings.from_env()
        db = db or Database(settings.database_path)
        db.create_all()
        return cls(settings=settings, db=db,
                   ai=AIService(llm=llm if llm is not None else make_env_llm()),
                   textorg=TextOrganizationService(db), **kw)


def _require(body: Dict[str, Any], *keys: str) -> None:
    missing = [k for k in keys if body.get(k) in (None, "")]
    if missing:
        raise ApiError(422, f"missing required field(s): {', '.join(missing)}")


# --- root / health ----------------------------------------------------------


def root(ctx, p, q, b):
    return 200, {"app": ctx.settings.app_name, "status": "running",
                 "version": ctx.settings.version, "docs": "/api/v1"}


def health(ctx, p, q, b):
    return 200, {"status": "healthy", "app": ctx.settings.app_name,
                 "version": ctx.settings.version}


# --- chat (`chat.py:16-61`) -------------------------------------------------


def chat_ask(ctx, p, q, b):
    _require(b, "question")
    answer = ctx.ai.ask(b["question"], b.get("document_text"),
                        [{"role": h["role"], "content": h["content"]}
                         for h in b.get("history", [])])
    conv_id = b.get("conversation_id")
    if conv_id is not None and ctx.db.query_one(
            "SELECT id FROM conversation WHERE id=?", (int(conv_id),)) is None:
        # don't silently attach messages to a nonexistent conversation
        # (sqlite FK enforcement is off by default)
        conv_id = None
    if conv_id is None:
        conv_id = ctx.db.new_conversation(str(b.get("user_id", "anon")),
                                          title=b["question"][:50])
    ctx.db.add_message(int(conv_id), "user", b["question"])
    ctx.db.add_message(int(conv_id), "assistant", answer)
    return 200, {"answer": answer, "conversation_id": int(conv_id)}


def chat_suggestions(ctx, p, q, b):
    return 200, ["推荐一些机器学习入门课程", "我适合学什么专业课？",
                 "如何制定我的学习计划？", "根据我的历史推荐下一门课"]


# --- file upload (`file_upload.py:8-23`) ------------------------------------


def upload_pdf(ctx, p, q, b):
    _require(b, "file_name")
    doc = ctx.textorg.upload(b["file_name"], "pdf", b.get("content", ""))
    return 200, success_response(doc, "PDF上传成功")


def upload_image(ctx, p, q, b):
    _require(b, "file_name")
    return 200, success_response(
        {"file_name": b["file_name"], "file_type": "image",
         "uploaded_at": utcnow_iso()}, "图片上传成功")


# --- homework grading (`homework_grading.py:19-94`) --------------------------


def homework_submit(ctx, p, q, b):
    _require(b, "student_id", "title", "content")
    # Stable, restart-safe TEXT id (Python's str hash is per-process salted);
    # resubmitting the same student+title updates the stored document instead
    # of tripping the UNIQUE constraint.
    digest = hashlib.sha256(
        f"{b['student_id']}\x00{b['title']}".encode()).hexdigest()[:12]
    hw_id = f"hw-{digest}"
    ctx.db.execute(
        "INSERT INTO corrective_records (id, document, mark_records) "
        "VALUES (?, ?, NULL) ON CONFLICT(id) DO UPDATE SET document=excluded.document",
        (hw_id, b["content"]))
    ctx.state.setdefault("homework", {})[hw_id] = b
    return 200, success_response({
        "id": hw_id, "student_id": b["student_id"],
        "homework_type": b.get("homework_type", "essay"),
        "title": b["title"], "submitted_at": utcnow_iso(),
        "is_graded": False}, "作业提交成功")


def homework_grade(ctx, p, q, b):
    _require(b, "homework_id")
    # deterministic mock rubric, like the reference's fixed grading payload
    return 200, success_response({
        "homework_id": b["homework_id"], "total_score": "85",
        "grade": "B+", "rank": "良好", "percentile": "78%",
        "details": [
            {"category": "内容准确性", "score": 34, "total": 40},
            {"category": "结构逻辑性", "score": 25, "total": 30},
            {"category": "语言表达", "score": 16, "total": 20},
            {"category": "创新性", "score": 8, "total": 10},
        ],
        "suggestions": ["补充具体例证", "精简结论段落", "检查标点使用"],
        "graded_at": utcnow_iso()}, "作业批改完成")


def homework_detail(ctx, p, q, b):
    hw_id = p["homework_id"]
    return 200, success_response({
        "id": hw_id, "title": "示例作业", "homework_type": "essay",
        "is_graded": True,
        "grading_result": {"total_score": "85", "grade": "B+",
                           "details": [], "suggestions": []}},
        "获取作业详情成功")


def homework_list(ctx, p, q, b):
    page = int(q.get("page", 1))
    page_size = int(q.get("page_size", 10))
    items = [{"id": i, "title": f"作业 {i}", "is_graded": i % 2 == 0}
             for i in range(1, 6)]
    return 200, success_response({
        "total": len(items), "page": page, "page_size": page_size,
        "items": items[(page - 1) * page_size: page * page_size]},
        "获取作业列表成功")


# --- learning path (`learning_path.py:38-221`) -------------------------------


def _mock_path(path_id: int, goal: str, level: str, weekly_hours: int):
    phases = [
        {"phase_id": 1, "name": "基础阶段", "weeks": 4, "progress": 0},
        {"phase_id": 2, "name": "进阶阶段", "weeks": 6, "progress": 0},
        {"phase_id": 3, "name": "实战阶段", "weeks": 4, "progress": 0},
    ]
    return {"path_id": path_id, "goal": goal, "current_level": level,
            "weekly_hours": weekly_hours, "phases": phases,
            "created_at": utcnow_iso()}


def learning_path_generate(ctx, p, q, b):
    _require(b, "student_id", "goal")
    paths = ctx.state.setdefault("learning_paths", {})
    path_id = len(paths) + 1
    path = _mock_path(path_id, b["goal"], b.get("current_level", "beginner"),
                      int(b.get("weekly_hours", 5)))
    path["student_id"] = b["student_id"]
    paths[path_id] = path
    return 200, success_response(path, "学习路径生成成功")


def learning_path_list(ctx, p, q, b):
    paths = list(ctx.state.get("learning_paths", {}).values())
    return 200, success_response({"total": len(paths), "paths": paths},
                                 "获取学习路径列表成功")


def learning_path_detail(ctx, p, q, b):
    path = ctx.state.get("learning_paths", {}).get(int(p["path_id"]))
    if path is None:
        raise ApiError(404, f"learning path {p['path_id']} not found")
    return 200, success_response(path, "获取学习路径详情成功")


def learning_path_progress(ctx, p, q, b):
    path = ctx.state.get("learning_paths", {}).get(int(p["path_id"]))
    if path is None:
        raise ApiError(404, f"learning path {p['path_id']} not found")
    phase_id = int(q.get("phase_id", b.get("phase_id", 0)))
    progress = int(q.get("progress", b.get("progress", 0)))
    for ph in path["phases"]:
        if ph["phase_id"] == phase_id:
            ph["progress"] = max(0, min(100, progress))
            return 200, success_response(path, "学习进度更新成功")
    raise ApiError(404, f"phase {phase_id} not found")


# --- lesson plan (`lesson_plan.py:40-238`) -----------------------------------


def lesson_plan_generate(ctx, p, q, b):
    _require(b, "subject", "topic")
    plans = ctx.state.setdefault("lesson_plans", {})
    plan_id = len(plans) + 1
    plan = {"plan_id": plan_id, "subject": b["subject"], "topic": b["topic"],
            "grade": b.get("grade", ""), "duration_minutes":
                int(b.get("duration_minutes", 45)),
            "objectives": b.get("objectives") or
                [f"理解{b['topic']}的核心概念", f"掌握{b['topic']}的应用"],
            "sections": [
                {"name": "导入", "minutes": 5},
                {"name": "讲授", "minutes": 25},
                {"name": "练习", "minutes": 10},
                {"name": "总结", "minutes": 5},
            ],
            "created_at": utcnow_iso()}
    plans[plan_id] = plan
    return 200, success_response(plan, "教案生成成功")


def lesson_plan_list(ctx, p, q, b):
    plans = list(ctx.state.get("lesson_plans", {}).values())
    return 200, success_response({"total": len(plans), "plans": plans},
                                 "获取教案列表成功")


def lesson_plan_detail(ctx, p, q, b):
    plan = ctx.state.get("lesson_plans", {}).get(int(p["plan_id"]))
    if plan is None:
        raise ApiError(404, f"lesson plan {p['plan_id']} not found")
    return 200, success_response(plan, "获取教案详情成功")


def lesson_plan_update(ctx, p, q, b):
    plans = ctx.state.get("lesson_plans", {})
    plan = plans.get(int(p["plan_id"]))
    if plan is None:
        raise ApiError(404, f"lesson plan {p['plan_id']} not found")
    plan.update({k: v for k, v in b.items()
                 if k in ("subject", "topic", "grade", "duration_minutes",
                          "objectives")})
    return 200, success_response(plan, "教案更新成功")


def lesson_plan_delete(ctx, p, q, b):
    plans = ctx.state.get("lesson_plans", {})
    if plans.pop(int(p["plan_id"]), None) is None:
        raise ApiError(404, f"lesson plan {p['plan_id']} not found")
    return 200, success_response(None, "教案删除成功")


def lesson_plan_templates(ctx, p, q, b):
    return 200, success_response([
        {"template_id": 1, "name": "讲授式", "sections": 4},
        {"template_id": 2, "name": "探究式", "sections": 5},
        {"template_id": 3, "name": "翻转课堂", "sections": 3},
    ], "获取教案模板成功")


# --- ppt creation (`ppt_creation.py:20-231`) ---------------------------------


def ppt_create(ctx, p, q, b):
    _require(b, "title", "topic")
    projects = ctx.state.setdefault("ppt_projects", {})
    task_id = len(projects) + 1
    proj = {"task_id": task_id, "project_id": task_id, "title": b["title"],
            "topic": b["topic"], "num_slides": int(b.get("num_slides", 10)),
            "template_id": b.get("template_id"),
            "status": "completed", "progress": 100,
            "created_at": utcnow_iso()}
    projects[task_id] = proj
    return 200, success_response(proj, "PPT项目创建成功")


def ppt_status(ctx, p, q, b):
    proj = ctx.state.get("ppt_projects", {}).get(int(p["task_id"]))
    if proj is None:
        raise ApiError(404, f"ppt task {p['task_id']} not found")
    return 200, success_response(
        {"task_id": proj["task_id"], "status": proj["status"],
         "progress": proj["progress"]}, "获取生成状态成功")


def ppt_result(ctx, p, q, b):
    proj = ctx.state.get("ppt_projects", {}).get(int(p["task_id"]))
    if proj is None:
        raise ApiError(404, f"ppt task {p['task_id']} not found")
    slides = [{"index": i, "title": f"{proj['topic']} — 第{i}节",
               "bullets": [f"{proj['topic']}要点 {i}.{j}" for j in (1, 2, 3)]}
              for i in range(1, proj["num_slides"] + 1)]
    return 200, success_response(
        {"task_id": proj["task_id"], "title": proj["title"],
         "slides": slides}, "获取生成结果成功")


def ppt_templates(ctx, p, q, b):
    return 200, success_response([
        {"template_id": 1, "name": "学术简约", "style": "minimal"},
        {"template_id": 2, "name": "课堂活力", "style": "vivid"},
        {"template_id": 3, "name": "科技蓝", "style": "tech"},
    ], "获取PPT模板成功")


def ppt_projects(ctx, p, q, b):
    projects = list(ctx.state.get("ppt_projects", {}).values())
    return 200, success_response(
        {"total": len(projects), "projects": projects}, "获取PPT项目列表成功")


def ppt_project_detail(ctx, p, q, b):
    proj = ctx.state.get("ppt_projects", {}).get(int(p["project_id"]))
    if proj is None:
        raise ApiError(404, f"ppt project {p['project_id']} not found")
    return 200, success_response(proj, "获取PPT项目详情成功")


def ppt_project_delete(ctx, p, q, b):
    if ctx.state.get("ppt_projects", {}).pop(int(p["project_id"]), None) is None:
        raise ApiError(404, f"ppt project {p['project_id']} not found")
    return 200, success_response(None, "PPT项目删除成功")


# --- text organization (`text_organization.py:27-246`) -----------------------


def text_upload(ctx, p, q, b):
    _require(b, "file_name")
    doc = ctx.textorg.upload(b["file_name"], b.get("file_type", "txt"),
                             b.get("content", ""))
    return 200, success_response(doc, "文档上传成功")


def text_process(ctx, p, q, b):
    _require(b, "document_id")
    task = ctx.textorg.start_processing(
        int(b["document_id"]), b.get("operations", ["summarize", "organize"]))
    return 200, success_response(task, "文本处理已启动")


def text_status(ctx, p, q, b):
    return 200, success_response(ctx.textorg.status(int(p["task_id"])),
                                 "获取处理状态成功")


def text_results(ctx, p, q, b):
    return 200, success_response(ctx.textorg.results(int(p["task_id"])),
                                 "获取处理结果成功")


def text_documents(ctx, p, q, b):
    return 200, success_response(
        ctx.textorg.documents(int(q.get("page", 1)),
                              int(q.get("page_size", 10))), "获取文档列表成功")


def text_history(ctx, p, q, b):
    return 200, success_response(
        ctx.textorg.history(int(q.get("page", 1)),
                            int(q.get("page_size", 10))), "获取处理历史成功")


def text_delete_document(ctx, p, q, b):
    ctx.textorg.delete_document(int(p["document_id"]))
    return 200, success_response(None, "文档删除成功")


def text_stats(ctx, p, q, b):
    return 200, success_response(ctx.textorg.stats(), "获取统计信息成功")


# --- recommendation (new HTTP surface over `Baseline/direct_rec.py:108`) ----


def recommend(ctx, p, q, b):
    if ctx.recommender is None:
        raise ApiError(503, "hybrid recommender not configured")
    history, profile = b.get("history", []), b.get("profile", "")
    if not history and b.get("user_id") is not None:
        rows = ctx.db.query(
            "SELECT class_id FROM interaction_records WHERE student_id=? "
            "ORDER BY id", (str(b["user_id"]),))
        history = [r["class_id"] for r in rows]
        stu = ctx.db.query_one(
            "SELECT major, interest_long_profile FROM students "
            "WHERE student_id=?", (str(b["user_id"]),))
        if stu and not profile:
            profile = stu.get("interest_long_profile") or stu.get("major") or ""
    recs = ctx.recommender.recommend(history, profile, int(b.get("top_k", 10)))
    return 200, success_response(recs, "推荐成功")


def recommend_model(ctx, p, q, b):
    if ctx.model_recommend_fn is None:
        raise ApiError(503, "model recommender not configured")
    items = ctx.model_recommend_fn(b.get("history", []), int(b.get("top_k", 10)))
    return 200, success_response([{"item_id": int(i)} for i in items],
                                 "推荐成功")


def courses(ctx, p, q, b):
    if ctx.catalog is not None:
        data = [{"item_id": i, "name": ctx.catalog.item_names.get(i, ""),
                 "url": ctx.catalog.item_url.get(i, "")}
                for i in ctx.catalog.item_pool]
    else:
        data = ctx.db.query("SELECT class_id AS item_id, class_name AS name, "
                            "url FROM class_index ORDER BY class_id")
    return 200, success_response(data, "获取课程列表成功")


# --- route table -------------------------------------------------------------

# (method, path template) -> handler. `{name}` segments become path params.
ROUTES: List[Tuple[str, str, Handler]] = [
    ("GET", "/", root),
    ("GET", "/health", health),
    ("POST", "/api/v1/chat/ask", chat_ask),
    ("POST", "/api/v1/chat/", chat_ask),  # legacy-compatible (`chat.py:60`)
    ("GET", "/api/v1/chat/suggestions", chat_suggestions),
    ("POST", "/api/v1/files/upload/pdf", upload_pdf),
    ("POST", "/api/v1/files/upload/image", upload_image),
    ("POST", "/api/v1/homework/submit", homework_submit),
    ("POST", "/api/v1/homework/grade", homework_grade),
    ("GET", "/api/v1/homework/homework/{homework_id}", homework_detail),
    ("GET", "/api/v1/homework/list", homework_list),
    ("POST", "/api/v1/learning-path/generate", learning_path_generate),
    ("GET", "/api/v1/learning-path/paths", learning_path_list),
    ("GET", "/api/v1/learning-path/paths/{path_id}", learning_path_detail),
    ("PUT", "/api/v1/learning-path/paths/{path_id}/progress",
     learning_path_progress),
    ("POST", "/api/v1/lesson-plan/generate", lesson_plan_generate),
    ("GET", "/api/v1/lesson-plan/plans", lesson_plan_list),
    ("GET", "/api/v1/lesson-plan/plans/{plan_id}", lesson_plan_detail),
    ("PUT", "/api/v1/lesson-plan/plans/{plan_id}", lesson_plan_update),
    ("DELETE", "/api/v1/lesson-plan/plans/{plan_id}", lesson_plan_delete),
    ("GET", "/api/v1/lesson-plan/templates", lesson_plan_templates),
    ("POST", "/api/v1/ppt/create", ppt_create),
    ("GET", "/api/v1/ppt/status/{task_id}", ppt_status),
    ("GET", "/api/v1/ppt/result/{task_id}", ppt_result),
    ("GET", "/api/v1/ppt/templates", ppt_templates),
    ("GET", "/api/v1/ppt/projects", ppt_projects),
    ("GET", "/api/v1/ppt/projects/{project_id}", ppt_project_detail),
    ("DELETE", "/api/v1/ppt/projects/{project_id}", ppt_project_delete),
    ("POST", "/api/v1/text-organization/upload", text_upload),
    ("POST", "/api/v1/text-organization/process", text_process),
    ("GET", "/api/v1/text-organization/status/{task_id}", text_status),
    ("GET", "/api/v1/text-organization/results/{task_id}", text_results),
    ("GET", "/api/v1/text-organization/documents", text_documents),
    ("GET", "/api/v1/text-organization/history", text_history),
    ("DELETE", "/api/v1/text-organization/documents/{document_id}",
     text_delete_document),
    ("GET", "/api/v1/text-organization/stats", text_stats),
    ("POST", "/api/v1/recommend", recommend),
    ("POST", "/api/v1/recommend/model", recommend_model),
    ("GET", "/api/v1/courses", courses),
]


# groups the reference mounts under BOTH /api/v1 and a blanket legacy /api
# prefix (`backend/app/main.py:48-51` includes api_router twice). The
# file-upload router and the repo's live recommend/courses routes are
# /api/v1-only, matching `main.py:53-55`.
_LEGACY_GROUPS = ("chat", "text-organization", "ppt", "homework",
                  "learning-path", "lesson-plan",
                  "ppt-creation", "homework-grading",
                  "homework_grading", "learning_path")

# the reference's router prefixes are `/ppt-creation` and
# `/homework-grading` (`ppt_creation.py:17`, `homework_grading.py:16`),
# and `main.py:53-54` additionally double-mounts underscore spellings
# `/api/v1/learning_path` and `/api/v1/homework_grading`. This repo's
# route table uses the short segments; normalize all reference spellings
# onto them so real reference clients don't 404.
_SEGMENT_ALIASES = {
    "ppt-creation": "ppt",
    "homework-grading": "homework",
    "homework_grading": "homework",
    "learning_path": "learning-path",
}


def match_route(method: str, path: str
                ) -> Optional[Tuple[Handler, Dict[str, str]]]:
    """Match a concrete path against the template table. Static segments
    must equal; `{name}` segments capture. Legacy `/api/<group>/...` paths
    resolve to their `/api/v1` route for the groups the reference
    double-mounts, and reference segment spellings alias onto the table's."""
    parts = [s for s in path.split("/") if s != ""]
    if (len(parts) >= 2 and parts[0] == "api" and parts[1] != "v1"
            and parts[1] in _LEGACY_GROUPS):
        parts = ["api", "v1"] + parts[1:]
    if len(parts) >= 3 and parts[0] == "api" and parts[1] == "v1":
        parts[2] = _SEGMENT_ALIASES.get(parts[2], parts[2])
    for m, template, handler in ROUTES:
        if m != method:
            continue
        tparts = [s for s in template.split("/") if s != ""]
        if len(tparts) != len(parts):
            continue
        params: Dict[str, str] = {}
        for tp, cp in zip(tparts, parts):
            if tp.startswith("{") and tp.endswith("}"):
                params[tp[1:-1]] = cp
            elif tp != cp:
                break
        else:
            return handler, params
    return None
