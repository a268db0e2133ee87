"""Small utilities: a copy of ``genrec_tpu/utils/misc.py``'s ``get_logger``
(`RQ-VAE/utils.py:6-37`)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def get_logger(name: str, log_path: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """Per-pipeline file+stdout logger (SASRec/train.py:92-96 equivalent)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if log_path:
        # same-named logger, new destination (e.g. two pipeline runs in one
        # process): drop stale file handlers or lines leak into old files
        for h in list(logger.handlers):
            tag = getattr(h, "_genrec_tag", "")
            if tag.startswith("file:") and tag != "file:" + log_path:
                logger.removeHandler(h)
                h.close()
    have = {getattr(h, "_genrec_tag", None) for h in logger.handlers}
    if "stream" not in have:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        sh._genrec_tag = "stream"
        logger.addHandler(sh)
    if log_path and ("file:" + log_path) not in have:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        fh._genrec_tag = "file:" + log_path
        logger.addHandler(fh)
    return logger
