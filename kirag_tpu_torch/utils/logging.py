"""File + stream logging setup (port of :mod:`kirag_tpu.utils.logging`)."""

from __future__ import annotations

import logging
from typing import Optional


def setup_logger(log_file: Optional[str] = None, process_index: int = 0,
                 level: int = logging.INFO) -> logging.Logger:
    """Configure the root logger with a stream and an optional file handler.

    Only process 0 of a multi-process job attaches handlers; the others keep
    a quiet root logger.
    """
    logger = logging.getLogger()
    logger.setLevel(level)
    if process_index != 0:
        return logger
    formatter = logging.Formatter("%(asctime)s %(levelname)s: - %(message)s",
                                  datefmt="%Y-%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file))
    for handler in handlers:
        handler.setLevel(level)
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    if log_file is not None:
        logger.info(f"Saving log file to {log_file} ...")
    return logger
