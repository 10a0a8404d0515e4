"""Structured logging: counterpart of ``raft_tpu/core/logging.py``
(``set_level``, ``get_level``, ``set_pattern``, ``set_callback``,
``log_trace`` .. ``log_critical``), the analog of the reference's
spdlog-backed ``raft::logger`` (runtime level and pattern, a callback
sink). The backend is the stdlib ``logging`` module with an extra TRACE
level; the port logs under the logger ``raft_tpu_torch``.
"""
from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

__all__ = [
    "TRACE",
    "logger",
    "set_level",
    "get_level",
    "set_pattern",
    "set_callback",
    "log_trace",
    "log_debug",
    "log_info",
    "log_warn",
    "log_error",
    "log_critical",
]

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_DEFAULT_PATTERN = "[%(levelname)s] [%(asctime)s] %(name)s: %(message)s"

logger = logging.getLogger("raft_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(_DEFAULT_PATTERN))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)


class _CallbackHandler(logging.Handler):
    """Callback sink: forwards formatted records to a user function."""

    def __init__(self, fn: Callable[[int, str], None]):
        super().__init__()
        self._fn = fn

    def emit(self, record: logging.LogRecord) -> None:
        self._fn(record.levelno, self.format(record))


_callback_handler: Optional[_CallbackHandler] = None
_current_pattern = _DEFAULT_PATTERN


def set_level(level: int) -> None:
    """Runtime log level (analog of ``logger::set_level``)."""
    logger.setLevel(level)


def get_level() -> int:
    return logger.level


def set_pattern(pattern: str) -> None:
    """Set the log format (analog of ``logger::set_pattern``)."""
    global _current_pattern
    _current_pattern = pattern
    for h in logger.handlers:
        h.setFormatter(logging.Formatter(pattern))


def set_callback(fn: Optional[Callable[[int, str], None]]) -> None:
    """Install/remove a callback sink (analog of the spdlog callback sink).
    The sink formats with the current pattern, like every other handler."""
    global _callback_handler
    if _callback_handler is not None:
        logger.removeHandler(_callback_handler)
        _callback_handler = None
    if fn is not None:
        _callback_handler = _CallbackHandler(fn)
        _callback_handler.setFormatter(logging.Formatter(_current_pattern))
        logger.addHandler(_callback_handler)


def log_trace(msg, *a):
    logger.log(TRACE, msg, *a)


def log_debug(msg, *a):
    logger.debug(msg, *a)


def log_info(msg, *a):
    logger.info(msg, *a)


def log_warn(msg, *a):
    logger.warning(msg, *a)


def log_error(msg, *a):
    logger.error(msg, *a)


def log_critical(msg, *a):
    logger.critical(msg, *a)
