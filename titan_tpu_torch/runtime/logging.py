"""Structured logging (the reference uses bare printf, SURVEY.md 5.5).

A copy of ``titan_tpu/runtime/logging.py`` under the port's logger name."""

from __future__ import annotations

import logging
import os

_LOGGER = None


def get_logger() -> logging.Logger:
    """Library logger; level from TITAN_TPU_LOG (default WARNING)."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("titan_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            logger.addHandler(handler)
        logger.setLevel(os.environ.get("TITAN_TPU_LOG", "WARNING").upper())
        _LOGGER = logger
    return _LOGGER
