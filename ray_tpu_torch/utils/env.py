"""Process-environment helpers shared by every process-spawning site (a
copy of ``ray_tpu/utils/env.py``)."""

from __future__ import annotations

import os


def inject_framework_pythonpath(env: dict) -> dict:
    """Prepend the directory that holds ``ray_tpu_torch`` to env's
    PYTHONPATH (in place).

    Every spawned process (cluster workers above all) must import
    ray_tpu_torch whatever its cwd: a runtime_env working_dir or an
    arbitrary entrypoint directory drops the implicit cwd-based import.
    """
    import ray_tpu_torch

    fw_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    env["PYTHONPATH"] = (
        fw_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH") else fw_root
    )
    return env
