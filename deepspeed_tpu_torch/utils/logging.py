"""Logging utilities; counterpart of ``deepspeed_tpu/utils/logging.py``.

``log_dist`` gates on the process's ``torch.distributed`` rank (0 when no
process group is initialised).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "deepspeed_tpu_torch"


def _create_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    level = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    logger.propagate = False
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    logger.addHandler(handler)
    return logger


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0)."""
    ranks = ranks if ranks is not None else [0]
    idx = _process_index()
    if idx in ranks or -1 in ranks:
        logger.log(level, f"[rank {idx}] {message}")
