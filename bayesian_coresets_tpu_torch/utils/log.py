"""Logging with per-algorithm-instance ids.

Mirrors the reference's logging surface (bayesiancoresets/util/log.py:5-42):
per-object logger adapters tagged ``ClassName-<6 hex>`` and a
``set_verbosity`` mapping strings to stdlib levels.
"""

from __future__ import annotations

import logging
import secrets

_FORMAT = "%(levelname)s - %(id)s.%(funcName)s(): %(message)s"

_root = logging.getLogger("bayesian_coresets_tpu_torch")
if not _root.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter(_FORMAT))
    _root.addHandler(_handler)
    _root.setLevel(logging.ERROR)

_LEVELS = {
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "critical": logging.CRITICAL,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}


def set_verbosity(verb: str) -> None:
    """Set library log level by name (reference util/log.py:6-7)."""
    if verb not in _LEVELS:
        raise ValueError(f"unknown verbosity {verb!r}; choose from {sorted(_LEVELS)}")
    _root.setLevel(_LEVELS[verb])


def get_logger(obj_or_name) -> logging.LoggerAdapter:
    """Return a logger tagged with a fresh ``ClassName-<hex>`` instance id."""
    name = obj_or_name if isinstance(obj_or_name, str) else type(obj_or_name).__name__
    alg_id = f"{name}-{secrets.token_hex(3)}"
    return logging.LoggerAdapter(_root, {"id": alg_id})
