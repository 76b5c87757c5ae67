"""Structured logging (``erpl_monte_carlo_sim_tpu/utils/logging.py``): the
port's loggers live under ``erpl_monte_carlo_sim_tpu_torch``."""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "configure"]

_LOGGER_NAME = "erpl_monte_carlo_sim_tpu_torch"


def get_logger(name: str | None = None) -> logging.Logger:
    """Package logger; progress/info messages are visible by default.

    If neither this package's logger nor the root logger has been
    configured, a stderr handler at INFO is attached lazily, so that
    ``example.main`` and the analyzer's progress lines are not dropped
    (Python's last-resort handler only emits WARNING and above).
    Applications that configure logging themselves are left alone.
    """
    pkg = logging.getLogger(_LOGGER_NAME)
    if not pkg.handlers and not logging.getLogger().handlers:
        configure()
    full = _LOGGER_NAME if name is None else f"{_LOGGER_NAME}.{name}"
    return logging.getLogger(full)


def configure(level: int = logging.INFO) -> None:
    """One-line structured console logging setup."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        logger.setLevel(level)
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
