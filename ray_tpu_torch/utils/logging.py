"""Framework logging (counterpart of ``ray_tpu/utils/logging.py``): one
stderr handler on the ``ray_tpu_torch`` logger, its level from
``RAY_TPU_log_level`` (the reference's variable)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "ray_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        root = logging.getLogger("ray_tpu_torch")
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter(
                    "%(asctime)s %(levelname)s %(name)s [pid=%(process)d] %(message)s"
                )
            )
            root.addHandler(handler)
        root.setLevel(os.environ.get("RAY_TPU_log_level", "INFO"))
        root.propagate = False
        _CONFIGURED = True
    return logger
