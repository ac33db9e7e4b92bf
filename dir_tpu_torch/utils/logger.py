"""Coloured console and file logger (counterpart of
``dir_tpu/utils/logger.py``)."""

from __future__ import annotations

import functools
import logging
import os
import sys


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.WARNING: "\x1b[33m",
        logging.ERROR: "\x1b[31m",
        logging.CRITICAL: "\x1b[31;1m",
    }
    RESET = "\x1b[0m"

    def format(self, record):
        msg = super().format(record)
        color = self.COLORS.get(record.levelno)
        return f"{color}{msg}{self.RESET}" if color else msg


@functools.lru_cache()
def setup_logger(output: str | None = None,
                 name: str = "dir_tpu_torch") -> logging.Logger:
    """Create (once per name) a logger with colored stdout and an
    append-mode file handler."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger

    fmt = "[%(asctime)s %(name)s %(levelname)s] %(message)s"
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(_ColorFormatter(fmt, datefmt="%m/%d %H:%M:%S"))
    logger.addHandler(ch)

    if output:
        if output.endswith((".txt", ".log")):
            filename = output
        else:
            filename = os.path.join(output, "log.txt")
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.StreamHandler(open(filename, "a"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger
