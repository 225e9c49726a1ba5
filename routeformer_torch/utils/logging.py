"""Logging configuration from ROUTEFORMER_* environment variables
(counterpart of ``routeformer_tpu/utils/logging.py``): ``set_logger_config``
reads ``ROUTEFORMER_LOG_LEVEL``, ``ROUTEFORMER_LOG_FMT``,
``ROUTEFORMER_LOG_DATEFMT`` and ``ROUTEFORMER_LOG_FILE`` and configures the
``routeformer_torch`` logger; ``get_logger`` gives its children."""

import logging
import os
from typing import Optional

_DEFAULT_FMT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"
_DEFAULT_DATEFMT = "%Y-%m-%d %H:%M:%S"

logger = logging.getLogger("routeformer_torch")


def set_logger_config(level: Optional[str] = None, fmt: Optional[str] = None,
                      datefmt: Optional[str] = None,
                      log_file: Optional[str] = None) -> logging.Logger:
    """Configure the package logger. Arguments default to the environment
    variables above, then to WARNING and a timestamped format."""
    level = level or os.environ.get("ROUTEFORMER_LOG_LEVEL", "WARNING")
    fmt = fmt or os.environ.get("ROUTEFORMER_LOG_FMT", _DEFAULT_FMT)
    datefmt = datefmt or os.environ.get("ROUTEFORMER_LOG_DATEFMT", _DEFAULT_DATEFMT)
    log_file = log_file or os.environ.get("ROUTEFORMER_LOG_FILE")

    logger.setLevel(level.upper() if isinstance(level, str) else level)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    formatter = logging.Formatter(fmt=fmt, datefmt=datefmt)
    stream = logging.StreamHandler()
    stream.setFormatter(formatter)
    logger.addHandler(stream)
    if log_file:
        file_handler = logging.FileHandler(log_file)
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
    logger.propagate = False
    return logger


def get_logger(name: str) -> logging.Logger:
    """Child logger under the package logger."""
    return logger.getChild(name)
