"""Pydantic request/response schemas: the port's copy of
``genrec_tpu/backend/schemas.py``.

Reference: `backend/app/schemas/*.py` (chat, common ResponseModel/Health,
homework, ppt_creation, text_organization) on pydantic v2; the
lesson-plan / learning-path routers of the reference declare their request
models inline, mirrored here.

pydantic is imported when a model is first asked for
(``from genrec_tpu_torch.backend.schemas import RecommendRequest``), not
when this module is imported: nothing else in the port needs it, and a
host without it imports the package all the same.
"""

from typing import Any, Dict, List, Optional

NAMES = ("ResponseModel", "HealthResponse", "ChatHistoryItem", "AIQuestionRequest",
         "AIQuestionResponse", "HomeworkSubmissionRequest", "HomeworkGradingRequest",
         "PPTCreationRequest", "FileUploadRequest", "TextProcessingRequest",
         "LessonPlanRequest", "LearningPathRequest", "RecommendRequest")

_models: Dict[str, type] = {}


def _define() -> Dict[str, type]:
    from pydantic import BaseModel, Field

    # --- common (reference `schemas/common.py`) --------------------------

    class ResponseModel(BaseModel):
        success: bool = True
        message: str = "操作成功"
        data: Any = None

    class HealthResponse(BaseModel):
        status: str = "healthy"
        app: str = "genrec-tpu backend"
        version: str = "0.1.0"

    # --- chat (reference `schemas/chat.py`) --------------------------------

    class ChatHistoryItem(BaseModel):
        role: str
        content: str

    class AIQuestionRequest(BaseModel):
        question: str
        document_text: Optional[str] = None
        history: List[ChatHistoryItem] = Field(default_factory=list)

    class AIQuestionResponse(BaseModel):
        answer: str

    # --- homework grading (reference `schemas/homework.py`) ----------------

    class HomeworkSubmissionRequest(BaseModel):
        student_id: str
        homework_type: str = "essay"
        title: str
        content: str

    class HomeworkGradingRequest(BaseModel):
        homework_id: int
        rubric: Optional[str] = None

    # --- ppt creation (reference `schemas/ppt_creation.py`) ----------------

    class PPTCreationRequest(BaseModel):
        title: str
        topic: str
        outline: Optional[List[str]] = None
        template_id: Optional[int] = None
        num_slides: int = 10

    # --- text organization (reference `schemas/text_organization.py`) ------

    class FileUploadRequest(BaseModel):
        file_name: str
        file_type: str = "txt"
        content: str = ""

    class TextProcessingRequest(BaseModel):
        document_id: int
        operations: List[str] = Field(
            default_factory=lambda: ["summarize", "organize"])

    # --- lesson plan / learning path (declared inline in the reference routers)

    class LessonPlanRequest(BaseModel):
        subject: str
        grade: str = ""
        topic: str
        duration_minutes: int = 45
        objectives: Optional[List[str]] = None

    class LearningPathRequest(BaseModel):
        student_id: str
        goal: str
        current_level: str = "beginner"
        weekly_hours: int = 5

    # --- recommendation (new — the reference never exposes this over HTTP) -

    class RecommendRequest(BaseModel):
        user_id: Optional[int] = None
        history: List[int] = Field(default_factory=list)
        profile: str = ""
        top_k: int = 10

    found = locals()
    for name in NAMES:  # reachable as module attributes, so named as such (and picklable)
        found[name].__qualname__ = name
    return {name: found[name] for name in NAMES}


def __getattr__(name: str):
    if name not in NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if not _models:
        _models.update(_define())
    return _models[name]
