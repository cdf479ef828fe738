"""Shared-memory directory resolution (counterpart of ``ray_tpu/utils/shm.py``).

One helper so every shm participant derives the SAME backing directory —
divergent copies would make cross-process readers spin on a path the
writer never creates (hosts without /dev/shm, e.g. macOS, fall back to
TMPDIR).
"""

from __future__ import annotations

import os


def shm_dir() -> str:
    return ("/dev/shm" if os.path.isdir("/dev/shm")
            else os.environ.get("TMPDIR", "/tmp"))
