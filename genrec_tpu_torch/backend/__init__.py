"""Education-app backend of the port (serving layer L6 of SURVEY.md §1): a
copy of ``genrec_tpu/backend``, which imports no JAX, with the port's
modules in place of the JAX package's. Like it, a from-scratch rebuild of the reference FastAPI backend
(`backend/app/main.py:29-127` and everything under `backend/app/`) with
two deliberate departures:

- **Framework-agnostic core.** Route handlers are plain functions over a
  stdlib-``sqlite3`` database; the HTTP layer is an adapter. Two
  adapters ship: a dependency-free ``http.server`` one (always
  available) and a FastAPI one (used when fastapi is installed). The
  reference hard-depends on FastAPI + async SQLAlchemy.
- **Recommendation is an actual route.** The reference's recommender
  (`Baseline/direct_rec.py:108`) is never wired to HTTP; here
  ``/api/v1/recommend`` serves the hybrid/model recommenders from
  :mod:`genrec_tpu_torch.serving`.
"""

from genrec_tpu_torch.backend.config import Settings
from genrec_tpu_torch.backend.db import Database
from genrec_tpu_torch.backend.server import create_fastapi_app, serve

__all__ = ["Settings", "Database", "create_fastapi_app", "serve"]
