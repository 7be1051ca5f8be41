"""Non-blocking queue-based logging, mirroring the reference's public artifact
(the port's own copy of ``rtvqa_tpu/obs/logging.py``; its loggers live
under ``rtvqa_tpu_torch``).

Reference: ``video_processing.py:21-41`` wires a ``QueueHandler`` → ``Queue`` →
``QueueListener`` → ``FileHandler('video_processing.log')`` at import time, and
``logging_setup.py:12-21`` (dead code in the reference) adds rotation. Here the
two are unified: one explicit ``setup_logging`` call installs a queue-fed
rotating file handler (5 MB × 5 backups, matching ``logging_setup.py:15``),
instead of side-effectful module-import setup.
"""

from __future__ import annotations

import atexit
import logging
import queue
from logging.handlers import QueueHandler, QueueListener, RotatingFileHandler
from typing import Optional

_listener: Optional[QueueListener] = None


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def setup_logging(
    log_file: str = "video_processing.log",
    level: int = logging.INFO,
    max_bytes: int = 5 * 1024 * 1024,
    backup_count: int = 5,
) -> None:
    """Install queue-based non-blocking logging to a rotating file.

    Idempotent; safe to call from the CLI and from tests.
    """
    global _listener
    if _listener is not None:
        return
    log_queue: queue.Queue = queue.Queue(-1)
    file_handler = RotatingFileHandler(log_file, maxBytes=max_bytes, backupCount=backup_count)
    file_handler.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    )
    root = logging.getLogger("rtvqa_tpu_torch")
    root.setLevel(level)
    root.addHandler(QueueHandler(log_queue))
    _listener = QueueListener(log_queue, file_handler)
    _listener.start()
    atexit.register(stop_logging)


def stop_logging() -> None:
    global _listener
    if _listener is not None:
        _listener.stop()
        _listener = None
