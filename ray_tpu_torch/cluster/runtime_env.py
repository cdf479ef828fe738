"""Runtime environments: per-task/actor worker environments (a copy of
``ray_tpu/cluster/runtime_env.py``: the same wire form and ``env_hash``).

Reference analog: python/ray/_private/runtime_env/ — the env_vars,
working_dir, and py_modules plugins with URI-addressed packaging (zips
staged through the GCS) and per-runtime-env worker processes
(worker_pool.h keys idle workers by runtime env hash). Redesigned lean:

 * packaging: working_dir / py_modules directories zip client-side and
   travel as ordinary objects through the cluster object plane (no
   separate package store); the daemon extracts into a content-addressed
   cache and reuses it across workers;
 * isolation: the daemon keys its idle-worker pool by the runtime env
   hash, so a worker only ever runs tasks of one runtime env (the
   reference's dedicated-worker semantics);
 * pip/conda are rejected loudly rather than silently ignored — this
   framework targets hermetic hosts (no network installs on the cards'
   hosts either).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import threading
import zipfile
from typing import Any, Optional

_extract_lock = threading.Lock()
_hash_locks: dict[str, threading.Lock] = {}


def _lock_for(key: str) -> threading.Lock:
    with _extract_lock:
        return _hash_locks.setdefault(key, threading.Lock())

SUPPORTED_KEYS = {"env_vars", "working_dir", "py_modules"}
REJECTED_KEYS = {"pip", "conda", "container", "image_uri", "uv"}


def walk_dir(path: str):
    """os.walk with followlinks (a symlinked data/ subdir must ship, not
    silently vanish) plus cycle detection by (st_dev, st_ino) so a
    self-referential link can't recurse forever. Skips __pycache__."""
    seen: set = set()
    for root, dirs, files in os.walk(path, followlinks=True):
        try:
            st = os.stat(root)
        except OSError:
            continue
        key = (st.st_dev, st.st_ino)
        if key in seen:
            dirs[:] = []
            continue
        seen.add(key)
        dirs.sort()
        if "__pycache__" in dirs:
            dirs.remove("__pycache__")
        yield root, dirs, files


def _zip_dir(path: str) -> bytes:
    """Deterministic zip of a directory tree (stable hash across runs)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in walk_dir(path):
            for f in sorted(files):
                full = os.path.join(root, f)
                rel = os.path.relpath(full, path)
                info = zipfile.ZipInfo(rel)  # fixed date: deterministic
                info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
                with open(full, "rb") as fh:
                    z.writestr(info, fh.read())
    return buf.getvalue()


def validate_keys(runtime_env: dict) -> None:
    bad = set(runtime_env) & REJECTED_KEYS
    if bad:
        raise ValueError(
            f"runtime_env keys {sorted(bad)} are not supported on hermetic "
            "hosts; bake dependencies into the image instead"
        )
    unknown = set(runtime_env) - SUPPORTED_KEYS
    if unknown:
        raise ValueError(f"unknown runtime_env keys: {sorted(unknown)}")


def package_runtime_env(runtime_env: Optional[dict], put) -> Optional[dict]:
    """Client side: validate, zip directories, stage zips via `put(bytes)
    -> object_id`. Returns the wire form of the runtime env (or None)."""
    if not runtime_env:
        return None
    validate_keys(runtime_env)
    wire: dict[str, Any] = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        wire["env_vars"] = {str(k): str(v) for k, v in env_vars.items()}
    wd = runtime_env.get("working_dir")
    if wd:
        if not os.path.isdir(wd):
            raise ValueError(f"working_dir {wd!r} is not a directory")
        data = _zip_dir(wd)
        wire["working_dir"] = {
            "object_id": put(data),
            "hash": hashlib.sha256(data).hexdigest()[:16],
        }
    mods = runtime_env.get("py_modules")
    if mods:
        entries = []
        for m in mods:
            if not os.path.isdir(m):
                raise ValueError(f"py_modules entry {m!r} is not a directory")
            data = _zip_dir(m)
            entries.append({
                "object_id": put(data),
                "hash": hashlib.sha256(data).hexdigest()[:16],
                "name": os.path.basename(os.path.normpath(m)),
            })
        wire["py_modules"] = entries
    return wire or None


def env_hash(wire: Optional[dict]) -> str:
    """Stable identity of a wire-form runtime env (worker-pool key)."""
    if not wire:
        return ""
    canon = json.dumps(
        {
            "env_vars": wire.get("env_vars", {}),
            "working_dir": wire.get("working_dir", {}).get("hash"),
            # name matters: identical bytes under different module names
            # materialize differently (the import-name symlink)
            "py_modules": [
                (m["name"], m["hash"]) for m in wire.get("py_modules", ())
            ],
        },
        sort_keys=True,
    )
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def materialize(wire: dict, fetch, cache_root: str,
                base_env: Optional[dict] = None) -> tuple[dict, Optional[str]]:
    """Daemon side: extract staged zips into the content-addressed cache.

    `fetch(object_id) -> bytes`; `base_env` is the worker's environment
    BEFORE runtime-env overlays (so an operator-supplied PYTHONPATH is
    prepended-to, not clobbered). Returns (extra_env_vars, workdir|None).
    Concurrent spawns of the same env serialize on a per-hash lock; the
    extraction staging dir is unique per attempt.
    """
    extra = dict(wire.get("env_vars", {}))
    paths: list[str] = []
    workdir = None

    def extract(entry) -> str:
        dest = os.path.join(cache_root, entry["hash"])
        with _lock_for(entry["hash"]):
            if not os.path.isdir(dest):
                data = fetch(entry["object_id"])
                if data is None:
                    raise RuntimeError(
                        f"runtime_env package {entry['hash']} unavailable"
                    )
                os.makedirs(cache_root, exist_ok=True)
                tmp = tempfile.mkdtemp(dir=cache_root, prefix=entry["hash"] + "-")
                with zipfile.ZipFile(io.BytesIO(data)) as z:
                    for info in z.infolist():
                        z.extract(info, tmp)
                        mode = info.external_attr >> 16
                        if mode:  # restore modes (extractall drops the x bit)
                            os.chmod(os.path.join(tmp, info.filename), mode)
                try:
                    os.replace(tmp, dest)
                except OSError:  # lost a cross-process race: dest exists
                    import shutil

                    shutil.rmtree(tmp, ignore_errors=True)
        return dest

    wd = wire.get("working_dir")
    if wd:
        workdir = extract(wd)
        paths.append(workdir)
    for m in wire.get("py_modules", ()):
        # a py_module dir is importable by its own name: put its PARENT on
        # the path, with the module dir linked under that name
        root = extract(m)
        named = os.path.join(root, "_mod", m["name"])
        with _lock_for(m["hash"]):
            if not os.path.islink(named) and not os.path.isdir(named):
                os.makedirs(os.path.dirname(named), exist_ok=True)
                try:
                    os.symlink(root, named)
                except FileExistsError:
                    pass
        paths.append(os.path.dirname(named))
    if paths:
        env = base_env if base_env is not None else os.environ
        existing = extra.get("PYTHONPATH", env.get("PYTHONPATH", ""))
        extra["PYTHONPATH"] = os.pathsep.join(
            paths + ([existing] if existing else [])
        )
    return extra, workdir
