"""Logging facade (reference log/log.go:7-47).

A thin seam over :mod:`logging` so every component logs through one
injectable logger: entrypoints call :func:`setup` once (level from flags,
like the mains wiring zap at bin/node/server.go:26-33), libraries call
the level functions.  Nil-safe by construction — without setup, records
flow to a stderr handler at INFO.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("cronsun")


def setup(level: str = "info", stream=None) -> logging.Logger:
    """Install a stderr handler + level on the facade logger."""
    h = logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S"))
    _logger.handlers[:] = [h]
    _logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    _logger.propagate = False
    return _logger


def set_logger(logger: logging.Logger):
    """Replace the facade's backing logger (reference SetLogger)."""
    global _logger
    _logger = logger


def debugf(fmt: str, *args):
    _logger.debug(fmt, *args)


def infof(fmt: str, *args):
    _logger.info(fmt, *args)


def warnf(fmt: str, *args):
    _logger.warning(fmt, *args)


def errorf(fmt: str, *args):
    _logger.error(fmt, *args)


def fatalf(fmt: str, *args):
    """Log critical and exit(1) (reference Fatalf)."""
    _logger.critical(fmt, *args)
    raise SystemExit(1)
