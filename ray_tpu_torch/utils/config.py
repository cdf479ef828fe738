"""Global config flag registry (counterpart of ``ray_tpu/utils/config.py``).

Flags are declared once in ``_DEFS``, resolved lazily from the environment
under the reference's names (``RAY_TPU_<name>``), and overridable in
process for tests via ``override``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any

_DEFS: dict[str, tuple[type, Any, str]] = {}
_OVERRIDES: dict[str, Any] = {}
_LOCK = threading.Lock()


def define(name: str, typ: type, default: Any, doc: str = "") -> None:
    _DEFS[name] = (typ, default, doc)


def get(name: str) -> Any:
    if name not in _DEFS:
        raise KeyError(f"unknown config flag: {name}")
    with _LOCK:
        if name in _OVERRIDES:
            return _OVERRIDES[name]
    typ, default, _ = _DEFS[name]
    env = os.environ.get(f"RAY_TPU_{name}")
    if env is None:
        return default
    if typ is bool:
        return env.lower() in ("1", "true", "yes")
    if typ in (dict, list):
        return json.loads(env)
    return typ(env)


def set_override(name: str, value: Any) -> None:
    if name not in _DEFS:
        raise KeyError(f"unknown config flag: {name}")
    with _LOCK:
        _OVERRIDES[name] = value


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily override flags (test helper)."""
    for name in kwargs:
        if name not in _DEFS:
            raise KeyError(f"unknown config flag: {name}")
    with _LOCK:
        saved = dict(_OVERRIDES)
        _OVERRIDES.update(kwargs)
    try:
        yield
    finally:
        with _LOCK:
            _OVERRIDES.clear()
            _OVERRIDES.update(saved)


def all_flags() -> dict[str, Any]:
    return {name: get(name) for name in _DEFS}


# ---------------------------------------------------------------------------
# Flag definitions: the ones the port reads, under the reference's names.
# ---------------------------------------------------------------------------

define("worker_mode", str, "thread", "Task execution mode: 'thread' (tasks and actors are threads of the process that owns the card) or 'process' (tasks in crash-isolated worker processes, each pinned to the cards its task holds; actors stay threads).")
