"""Leveled rotating logger (util/log analog).

Reference counterpart: util/log — per-module leveled logs written to a
directory of size-rotated files, with a runtime-mutable level (the reference
exposes /loglevel/set, cmd/cmd.go:282; here `set_level`). Built over the
stdlib logging package so third-party handlers compose; the module-level
`get_logger(module, dir)` mirrors log.InitLog's one-logger-per-daemon shape.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

_loggers: dict[str, logging.Logger] = {}

LEVELS = {"debug": logging.DEBUG, "info": logging.INFO, "warn": logging.WARNING,
          "error": logging.ERROR, "critical": logging.CRITICAL}


def get_logger(module: str, logdir: str | None = None, level: str = "info",
               max_bytes: int = 8 << 20, backups: int = 4) -> logging.Logger:
    lg = _loggers.get(module)
    if lg is not None:
        return lg
    lg = logging.getLogger(f"cfs.{module}")
    lg.setLevel(LEVELS.get(level, logging.INFO))
    lg.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        h: logging.Handler = logging.handlers.RotatingFileHandler(
            os.path.join(logdir, f"{module}.log"),
            maxBytes=max_bytes, backupCount=backups)
    else:
        h = logging.NullHandler()
    h.setFormatter(fmt)
    lg.addHandler(h)
    _loggers[module] = lg
    return lg


def set_level(module: str, level: str) -> bool:
    """Runtime level mutation (the /loglevel/set endpoint's backing call)."""
    lg = _loggers.get(module)
    if lg is None or level not in LEVELS:
        return False
    lg.setLevel(LEVELS[level])
    return True
