"""Backend utils: response wrappers, logger factory, password hashing.

Reference: `backend/app/utils/response.py:8-59` (success/error response
wrappers over a `{success, message, data}` envelope),
`backend/app/utils/logger.py:10-31` (stdout logger factory),
`backend/app/utils/security.py:3-9` (bcrypt hash/verify).

Password hashing uses stdlib PBKDF2-HMAC-SHA256 (bcrypt is not a
dependency); the salted `pbkdf2$iters$salt$hash` format keeps verify
self-describing.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import sys
from typing import Any, Dict, Optional

# --- response envelope ---------------------------------------------------


def create_response(data: Any = None, message: str = "操作成功",
                    success: bool = True) -> Dict[str, Any]:
    return {"success": success, "message": message, "data": data}


def success_response(data: Any = None, message: str = "操作成功") -> Dict[str, Any]:
    return create_response(data, message, True)


def error_response(message: str = "操作失败", data: Any = None) -> Dict[str, Any]:
    return create_response(data, message, False)


class ApiError(Exception):
    """Handler-raised error carrying an HTTP status (the adapter maps it)."""

    def __init__(self, status_code: int, message: str, data: Any = None):
        super().__init__(message)
        self.status_code = status_code
        self.body = error_response(message, data)


# --- logging ---------------------------------------------------------------


def get_logger(name: Optional[str] = None,
               level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(name or "genrec_backend")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(h)
        logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        logger.propagate = False
    return logger


# --- password hashing --------------------------------------------------


_ITERS = 100_000


def hash_password(password: str) -> str:
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _ITERS)
    return f"pbkdf2${_ITERS}${salt.hex()}${dk.hex()}"


def verify_password(plain_password: str, hashed_password: str) -> bool:
    try:
        scheme, iters, salt_hex, dk_hex = hashed_password.split("$")
        if scheme != "pbkdf2":
            return False
        dk = hashlib.pbkdf2_hmac("sha256", plain_password.encode(),
                                 bytes.fromhex(salt_hex), int(iters))
        # constant-time compare (the reference's bcrypt verify is too)
        return hmac.compare_digest(dk, bytes.fromhex(dk_hex))
    except (ValueError, AttributeError):
        return False
