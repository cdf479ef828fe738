"""The reference's concurrency lints (``ray_tpu.analysis``) run over the port.

``lock_guards``, ``lock_order``, ``blocking`` and ``thread_hygiene`` scan
every module of ``ray_tpu_torch`` with the port's own allowlists (below,
empty: every finding was fixed in the code). A violation fails, and so does
an allowlist entry that no scan consumed (a stale audited exception). The
tiered cache's two worker threads (``kvtier-spill``, ``kvfetch-prefetch``)
and their locks must be in what the passes see, so the lints cover them.

Also the regression of the orchestrator's ``_PoolEngine.depth()``: a
posted request stays counted until the loop has added it to the engine.
"""

import threading

import pytest

from ray_tpu.analysis import blocking, lock_guards, lock_order, lockmodel, thread_hygiene
from ray_tpu.analysis.allowlist import Allowlist
from ray_tpu.analysis.walker import iter_files
from ray_tpu_torch.llm.disagg.orchestrator import _PoolEngine

pytestmark = [pytest.mark.torch_port, pytest.mark.static_analysis]

PACKAGES = ("ray_tpu_torch",)

# the port's audited exceptions, per pass: (key tuple) -> written invariant
PORT_ALLOWLISTS = {
    "lock_guards": {},
    "lock_order": {},
    "blocking": {},
    "thread_hygiene": {},
}
PASSES = {
    "lock_guards": lock_guards,
    "lock_order": lock_order,
    "blocking": blocking,
    "thread_hygiene": thread_hygiene,
}


@pytest.mark.parametrize("name", sorted(PASSES))
def test_port_is_clean_under_reference_lint(name):
    al = Allowlist(dict(PORT_ALLOWLISTS[name]), label=f"port {name} allowlist")
    violations = PASSES[name].collect_violations(packages=PACKAGES, allowlist=al)
    assert violations == [], "\n".join(violations)
    assert al.stale() == []


def test_stale_port_allowlist_entry_fails():
    """An entry no scan consumes is reported, so the gate above would fail."""
    al = Allowlist({("llm/engine.py", "LLMEngine._gone", "step"): "a reason of some length"},
                   label="port lock_guards allowlist")
    out = lock_guards.collect_violations(packages=PACKAGES, allowlist=al)
    assert any("stale" in v for v in out)


def _model(rel_suffix: str) -> lockmodel.FileModel:
    for sf in iter_files(PACKAGES):
        if sf.rel.endswith(rel_suffix):
            return lockmodel.build_file_model(sf.tree, sf.rel)
    raise AssertionError(f"{rel_suffix} not scanned")


def _thread_names(model) -> set:
    out = set()
    for th in model.threads:
        for kw in th.node.keywords:
            if kw.arg == "name" and isinstance(getattr(kw.value, "value", None), str):
                out.add(kw.value.value)
    return out


@pytest.mark.parametrize("rel,cls,thread,guarded", [
    ("llm/kvtier/tiers.py", "KVTierManager", "kvtier-spill", ("_host", "_pending", "_obj")),
    ("llm/kvfetch/manager.py", "KVFetchManager", "kvfetch-prefetch", ("_staged", "_reserved")),
])
def test_tier_workers_and_locks_are_linted(rel, cls, thread, guarded):
    m = _model(rel)
    assert thread in _thread_names(m)
    assert f"{cls}._lock" in m.locks
    guards = lock_guards.infer_guards(m)
    for attr in guarded:
        assert guards.get((cls, attr)) == f"{cls}._lock", attr
    # every thread the port starts is a daemon
    for th in m.threads:
        assert any(kw.arg == "daemon" and getattr(kw.value, "value", None) is True
                   for kw in th.node.keywords)


@pytest.mark.parametrize("rel,cls,thread,guarded", [
    ("core/scheduler.py", "LocalScheduler", "ray_tpu_torch-dispatch", {"_queue": "_cv"}),
    ("core/object_store.py", "ObjectStore", None,
     {"_entries": "_lock", "_on_ready": "_lock", "_used": "_lock"}),
    ("core/actor_runtime.py", "Actor", None, {"_mailbox": "_lock"}),
    ("core/placement.py", "PlacementGroup", "ray_tpu_torch-pg-drain", {"_state": "_lock"}),
    ("serve/controller.py", "ServeController", "serve-reconcile",
     {"_apps": "_lock", "_drains": "_lock"}),
    ("serve/router.py", "Router", None,
     {"_replicas": "_lock", "_inflight": "_lock", "_last_refresh": "_lock", "_suspect": "_lock"}),
    ("serve/proxy.py", "HTTPProxy", "serve-http-proxy", {}),
])
def test_runtime_and_serve_threads_and_locks_are_linted(rel, cls, thread, guarded):
    """The in-process runtime's and Serve's threads and locks are in what
    the passes see, so the clean gate above covers them."""
    m = _model(rel)
    if thread is not None:
        assert thread in _thread_names(m)
    guards = lock_guards.infer_guards(m)
    for attr, lock in guarded.items():
        assert guards.get((cls, attr)) == f"{cls}.{lock}", attr
    for th in m.threads:
        assert any(kw.arg == "daemon" and getattr(kw.value, "value", None) is True
                   for kw in th.node.keywords)


class _FakeEngine:
    def __init__(self):
        self.waiting, self.running = [], []


def test_pool_engine_depth_never_reads_below_posted():
    """Hold the posted ``fn()`` on an Event: while the loop runs it, the
    request is in neither the engine nor (before the fix) the posted count,
    so a pick saw the engine one request lighter than it was."""
    pe = _PoolEngine(_FakeEngine(), 0, "prefill")
    entered, release = threading.Event(), threading.Event()

    def add():
        entered.set()
        assert release.wait(timeout=30)
        pe.engine.waiting.append("r0")

    assert pe.post(add, adds=1)
    assert pe.depth() == 1
    t = threading.Thread(target=pe.drain, daemon=True)
    t.start()
    assert entered.wait(timeout=30)
    assert pe.depth() >= 1  # fn() is running: the add is still counted
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert pe.depth() == 1 and pe.pending_adds == 0
