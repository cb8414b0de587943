"""Leveled logger.

Reference: paxi's ``log/`` package — a glog-style leveled logger
(``Debugf/Infof/Warningf/Errorf``) writing per-process files, configured
by ``-log_dir``, ``-log_level``, ``-log_stdout`` flags [med].  Thin
wrapper over stdlib logging with the same surface (the port's copy of
the JAX package's ``utils/log.py``, without its metrics dump).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_logger = logging.getLogger("paxi_tpu_torch")
_configured = False


def configure(level: Optional[str] = None, log_dir: Optional[str] = None,
              stdout: bool = True, tag: str = "") -> None:
    """Reference: log.Setup from flags (-log_level, -log_dir, -log_stdout).

    ``level=None`` (or "") falls back to the ``PAXI_LOG_LEVEL`` env var,
    then "info" — so driver scripts get leveled logging from the
    environment without each re-implementing flag plumbing."""
    global _configured
    if not level:
        level = os.environ.get("PAXI_LOG_LEVEL", "info")
    _logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    _logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname).1s " + (f"[{tag}] " if tag else "")
        + "%(message)s")
    if stdout:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        _logger.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        f = logging.FileHandler(
            os.path.join(log_dir, f"paxi_tpu_torch{('.' + tag) if tag else ''}.log"))
        f.setFormatter(fmt)
        _logger.addHandler(f)
    _configured = True


def _ensure() -> None:
    if not _configured:
        configure()


def debugf(fmt: str, *a) -> None:
    _ensure()
    _logger.debug(fmt, *a)


def infof(fmt: str, *a) -> None:
    _ensure()
    _logger.info(fmt, *a)


def warningf(fmt: str, *a) -> None:
    _ensure()
    _logger.warning(fmt, *a)


def errorf(fmt: str, *a) -> None:
    _ensure()
    _logger.error(fmt, *a)

