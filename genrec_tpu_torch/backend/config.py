"""App settings from environment / .env (reference: pydantic-settings
``Settings`` at `backend/app/core/config.py:9-64`).

Implemented with a plain dataclass + stdlib .env parsing so the backend
core has zero third-party dependencies. No credentials are ever
hard-coded (the reference embeds API keys at `Baseline/Rec.py:6-7` and
`backend/app/services/ai_service.py:21` — deliberately not reproduced).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional


def load_dotenv(path: str = ".env") -> dict:
    """Minimal KEY=VALUE .env parser (comments and blank lines skipped)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip().strip("'\"")
    return out


@dataclass
class Settings:
    app_name: str = "genrec-tpu backend"
    version: str = "0.1.0"
    host: str = "0.0.0.0"
    port: int = 8000
    database_path: str = "./app.db"
    cors_origins: List[str] = field(default_factory=lambda: [
        f"http://localhost:{p}" for p in range(3000, 3006)])
    llm_api_key: Optional[str] = None
    llm_base_url: Optional[str] = None
    llm_model: str = "env-configured"
    log_level: str = "INFO"
    # production frontend bundle; served under /static when the directory
    # exists (reference: `backend/app/main.py:88-91` StaticFiles mount).
    # RELATIVE paths are resolved against the REPO ROOT (not the process
    # CWD — a server launched from anywhere must find the same bundle).
    # The default lies inside the checkout, so the server reads nothing
    # beside it unless STATIC_DIR says so.
    static_dir: str = "frontend/dist"

    def resolved_static_dir(self) -> str:
        if os.path.isabs(self.static_dir):
            return self.static_dir
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        return os.path.normpath(os.path.join(repo_root, self.static_dir))

    @classmethod
    def from_env(cls, env_file: str = ".env") -> "Settings":
        env = {**load_dotenv(env_file), **os.environ}
        cors = env.get("CORS_ORIGINS")
        kw = dict(
            app_name=env.get("APP_NAME", cls.app_name),
            version=env.get("APP_VERSION", cls.version),
            host=env.get("HOST", cls.host),
            port=int(env.get("PORT", cls.port)),
            database_path=env.get("DATABASE_PATH", cls.database_path),
            llm_api_key=env.get("GENREC_LLM_API_KEY"),
            llm_base_url=env.get("GENREC_LLM_BASE_URL"),
            llm_model=env.get("GENREC_LLM_MODEL", cls.llm_model),
            log_level=env.get("LOG_LEVEL", cls.log_level),
            static_dir=env.get("STATIC_DIR", cls.static_dir),
        )
        if cors:
            kw["cors_origins"] = [o.strip() for o in cors.split(",") if o.strip()]
        return cls(**kw)
