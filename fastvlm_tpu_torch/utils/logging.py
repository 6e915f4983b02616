"""Logging and profiling utilities.

Counterpart of ``fastvlm_tpu/utils/logging.py``. ``build_logger`` is the
reference's (llava/utils.py): a named logger whose handler also writes a
daily-rotating file under ``FASTVLM_LOGDIR`` (default "."), optionally with
stdout / stderr redirected into it, used by every serving process.
``profile_trace`` captures a ``torch.profiler`` trace of a block (the JAX
package's wraps ``jax.profiler``): CPU activity always, CUDA kernels when a
card is present, written as a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import logging
import logging.handlers
import os
import sys
import time
from typing import Iterator, Optional

_handler: Optional[logging.Handler] = None

LOGDIR = os.environ.get("FASTVLM_LOGDIR", ".")


class StreamToLogger:
    """File-like that redirects writes into a logger, one record a line."""

    def __init__(self, logger: logging.Logger, level=logging.INFO):
        self.logger = logger
        self.level = level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(sys.__stdout__, attr)

    def write(self, buf):
        buf = self.linebuf + buf
        self.linebuf = ""
        for line in buf.splitlines(True):
            if line.endswith("\n"):
                self.logger.log(self.level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf:
            self.logger.log(self.level, self.linebuf.rstrip())
        self.linebuf = ""


def build_logger(logger_name: str, logger_filename: str,
                 redirect_std: bool = False) -> logging.Logger:
    """Named logger with a daily-rotating file shared across the process."""
    global _handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    if _handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        path = os.path.join(LOGDIR, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(
            path, when="D", utc=True, encoding="utf-8")
        _handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    logger.addHandler(_handler)

    if redirect_std:
        sys.stdout = StreamToLogger(logging.getLogger("stdout"), logging.INFO)
        sys.stderr = StreamToLogger(logging.getLogger("stderr"), logging.ERROR)
    return logger


@contextlib.contextmanager
def profile_trace(log_dir: str = "fastvlm_trace") -> Iterator[str]:
    """Profile the enclosed block with ``torch.profiler`` (CPU activity, and
    the CUDA kernels when a card is present) and write its Chrome trace to
    ``log_dir/trace-<time_ns>.json`` (open it in Perfetto or
    chrome://tracing). Yields the trace's path. Usage:

        with profile_trace("traces") as path:
            engine.generate(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
