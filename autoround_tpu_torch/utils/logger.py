"""The port's logger (counterpart of ``autoround_tpu/utils/logger.py``):
one standard-library logger, ``logging.getLogger("autoround_tpu_torch")``,
with a TRACE level below DEBUG and :func:`warning_once`.

The library never reads the environment: :func:`setup` installs the
JAX package's handler and format at a level it is given, and the entry
point (``cli.py``) calls it with ``envs.AR_LOG_LEVEL``.
"""

from __future__ import annotations

import logging

__all__ = ["TRACE", "logger", "warning_once", "trace", "setup"]

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

logger = logging.getLogger("autoround_tpu_torch")

_seen_warnings = set()


def warning_once(msg: str) -> None:
    if msg not in _seen_warnings:
        _seen_warnings.add(msg)
        logger.warning(msg)


def trace(msg: str, *args) -> None:
    logger.log(TRACE, msg, *args)


def setup(level: str = "INFO") -> None:
    """Give the logger a stderr handler (once) and the level named by
    ``level`` ("TRACE", "DEBUG", "INFO", ...; an unknown name means
    INFO)."""
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] autoround_tpu_torch: %(message)s",
            "%H:%M:%S"))
        logger.addHandler(handler)
    level = str(level).upper()
    logger.setLevel(TRACE if level == "TRACE"
                    else getattr(logging, level, logging.INFO))
