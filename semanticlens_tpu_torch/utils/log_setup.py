"""Console logging for ``semanticlens_tpu_torch``.

A copy of ``semanticlens_tpu.utils.log_setup`` with the port's logger name
(the port imports nothing of the JAX package).

Library-friendly observability: the package logger ships with a
``NullHandler`` so importing the library never prints, and applications
opt in via :func:`setup_colored_logging` (same entry-point name and
``SEMANTICLENS_LOG_LEVEL`` override as the reference's observability
contract, semanticlens/utils/log_setup.py — implementation is this
project's own).

Color handling follows the informal community conventions: ANSI styling
is applied only when the target stream is a TTY, ``NO_COLOR`` (any value)
disables it, and ``FORCE_COLOR`` re-enables it for piped output.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import IO

PACKAGE = "semanticlens_tpu_torch"

_DEFAULT_FMT = "%(asctime)s %(levelname)-8s %(name)s :: %(message)s"
_DEFAULT_DATEFMT = "%H:%M:%S"

# levelno thresholds -> ANSI SGR parameters for the level token.
# Checked in order; first entry with threshold <= levelno wins.
_LEVEL_STYLES: tuple[tuple[int, str], ...] = (
    (logging.CRITICAL, "1;97;41"),  # bold white on red
    (logging.ERROR, "31"),  # red
    (logging.WARNING, "33"),  # yellow
    (logging.INFO, "32"),  # green
    (0, "36"),  # cyan (debug and below)
)


def _style_for(levelno: int) -> str:
    for threshold, sgr in _LEVEL_STYLES:
        if levelno >= threshold:
            return sgr
    return ""


class ColorFormatter(logging.Formatter):
    """Formatter that wraps the *level token* of each record in ANSI color.

    Unlike whole-line coloring, this keeps multi-line payloads (tracebacks,
    dumped configs) readable while still making severity scannable.
    """

    def __init__(self, fmt: str = _DEFAULT_FMT, datefmt: str = _DEFAULT_DATEFMT, *, use_color: bool = True):
        super().__init__(fmt, datefmt)
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        if not self.use_color:
            return super().format(record)
        original = record.levelname
        try:
            record.levelname = f"\033[{_style_for(record.levelno)}m{original}\033[0m"
            return super().format(record)
        finally:
            record.levelname = original


def _color_wanted(stream: IO | None) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    return bool(stream is not None and hasattr(stream, "isatty") and stream.isatty())


def resolve_level(requested: str) -> int:
    """Resolve the effective level: ``SEMANTICLENS_LOG_LEVEL`` wins over the arg."""
    name = os.environ.get("SEMANTICLENS_LOG_LEVEL", requested).strip().upper()
    resolved = logging.getLevelName(name)
    return resolved if isinstance(resolved, int) else logging.INFO


def setup_colored_logging(log_level: str = "INFO", file_path: str | None = None) -> logging.Logger:
    """Opt the package logger into console (and optionally file) output.

    Replaces any handlers from a previous call, so it is safe to invoke
    repeatedly (e.g. from notebooks). Returns the configured logger.
    """
    level = resolve_level(log_level)
    logger = logging.getLogger(PACKAGE)
    logger.setLevel(level)
    logger.handlers.clear()

    console = logging.StreamHandler()
    console.setLevel(level)
    console.setFormatter(ColorFormatter(use_color=_color_wanted(getattr(console, "stream", sys.stderr))))
    logger.addHandler(console)

    if file_path is not None:
        sink = logging.FileHandler(file_path)
        sink.setLevel(level)
        sink.setFormatter(ColorFormatter(use_color=False))
        logger.addHandler(sink)

    return logger


# Importing the library must never emit "no handler" warnings.
logging.getLogger(PACKAGE).addHandler(logging.NullHandler())
