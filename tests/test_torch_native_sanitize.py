"""Sanitizer gate for the port's copy of the shared-memory store, as
``tests/test_native_sanitize.py`` gates the reference's: the store and a
multithreaded stress harness (``ray_tpu_torch/native/src/shm_stress.cc``)
built under ASan/UBSan and under TSan into ``ray_tpu_torch/native/_build/``
and run; a sanitizer report or a failed check exits non-zero."""

import shutil

import pytest

from ray_tpu_torch.native import shm

pytestmark = pytest.mark.torch_port


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
@pytest.mark.parametrize("kind", ["asan", "tsan"])
def test_shm_store_under_sanitizer(kind):
    proc = shm.run_stress(kind, timeout=60)
    assert proc.returncode == 0, (
        f"{kind} run failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    )
    assert "failures=0" in proc.stdout
