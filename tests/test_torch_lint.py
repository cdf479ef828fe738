"""The reference's concurrency lints (``ray_tpu.analysis``) run over the port.

``lock_guards``, ``lock_order``, ``blocking`` and ``thread_hygiene`` scan
every module of ``ray_tpu_torch`` with the port's own allowlists (below,
empty: every finding was fixed in the code). A violation fails, and so does
an allowlist entry that no scan consumed (a stale audited exception). The
tiered cache's two worker threads (``kvtier-spill``, ``kvfetch-prefetch``)
and their locks must be in what the passes see, so the lints cover them.

Also the regression of the orchestrator's ``_PoolEngine.depth()``: a
posted request stays counted until the loop has added it to the engine.
And the port's chaos-hook lint: every ``fire`` hook site of the package is
listed in ``HOOK_SITES`` and sits behind the ``ACTIVE`` fast path (its
allowlist of unguarded sites is empty); the GCS standby's, the chaos
runner's and the telemetry store's threads and locks, and the compiled
DAG's (its input prefetch, its collective loops, the socket channel's
accept, close-poll, reader and ack threads), are in what the passes see.
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
    """The names the file's threads are started with; an f-string name as
    its constant head and ``*``."""
    import ast

    out = set()
    for th in model.threads:
        for kw in th.node.keywords:
            if kw.arg != "name":
                continue
            if isinstance(getattr(kw.value, "value", None), str):
                out.add(kw.value.value)
            elif isinstance(kw.value, ast.JoinedStr) and kw.value.values \
                    and isinstance(kw.value.values[0], ast.Constant):
                out.add(kw.value.values[0].value + "*")
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
    ("serve/routes.py", "AppResolver", None, {}),
    ("dag/compiled.py", "CompiledDAG", "dag-input-prefetch", {"_seq": "_lock", "_fetched": "_lock"}),
    ("dag/compiled.py", "CompiledDAG", "dag-collective-*", {"_seq": "_lock"}),
    ("dag/socket_channel.py", "_WriterServer", "dagchan-accept-*",
     {"buffer": "lock", "acked": "lock", "closed": "lock"}),
    ("dag/socket_channel.py", "_WriterServer", "dagchan-poll-*", {"closed": "lock"}),
    ("dag/socket_channel.py", "_WriterServer", "dagchan-reader-*", {"buffer": "lock"}),
    ("dag/socket_channel.py", "_WriterServer", "dagchan-ack-*", {"acked": "lock"}),
    ("autoscale/controller.py", "PoolAutoscaler", "ray_tpu_torch-pool-autoscaler", {}),
    ("autoscale/actuators.py", "EnginePoolActuator", None, {"_pools": "_lock"}),
])
def test_runtime_and_serve_threads_and_locks_are_linted(rel, cls, thread, guarded):
    """The in-process runtime's, Serve's, the compiled DAG's and the pool
    autoscaler's threads and locks (the ingresses' ``AppResolver._lock``
    too) are in what the passes see, so the clean gate above covers them."""
    m = _model(rel)
    if thread is not None:
        assert thread in _thread_names(m)
    if not guarded:
        assert any(name.startswith(f"{cls}.") for name in m.locks), m.locks
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


# ---------------------------------------------------------------------------
# chaos hook sites
# ---------------------------------------------------------------------------

# every ``fire`` hook site of the port (outside ``chaos/``): site -> file
HOOK_SITES = {
    "llm.engine.step": "llm/engine.py",
    "disagg.kv_transfer": ("llm/disagg/connector.py", "fabric/transport.py"),
    "llm.kvtier.spill": "llm/kvtier/tiers.py",
    "llm.kvfetch": "llm/kvtier/tiers.py",
    "serve.replica": "serve/replica.py",
    "process_pool.task": "core/process_pool.py",
    "rpc.call": "cluster/rpc.py",
    "rpc.frame": "cluster/rpc.py",
    "gcs.call": "cluster/rpc.py",
    "node.heartbeat": "cluster/node_daemon.py",
    "cluster.push": "cluster/client.py",
    "dag.channel.send": "dag/channels.py",
    "dag.channel.recv": "dag/channels.py",
    "autoscale.drain": "autoscale/actuators.py",
}
# hook sites audited as safe without the ``ACTIVE`` guard: none
UNGUARDED_HOOK_ALLOWLIST: dict = {}


def _hook_sites() -> list:
    """(file, line, site, guarded) for every ``<x>.fire("<site>", ...)`` of
    the port outside ``chaos/``; guarded: the enclosing function tests
    ``<x>.ACTIVE`` (``is None`` / ``is not None``) before that line."""
    import ast

    out = []
    for sf in iter_files(PACKAGES):
        rel = sf.rel.removeprefix("ray_tpu_torch/")
        if rel.startswith("chaos/"):
            continue
        funcs = [n for n in ast.walk(sf.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire" and isinstance(node.func.value, ast.Name)):
                continue
            site = node.args[0].value if node.args and isinstance(node.args[0], ast.Constant) \
                else None
            owner = min((f for f in funcs if f.lineno <= node.lineno <= f.end_lineno),
                        key=lambda f: f.end_lineno - f.lineno, default=None)
            guarded = owner is not None and any(
                isinstance(c, ast.Compare) and isinstance(c.left, ast.Attribute)
                and c.left.attr == "ACTIVE" and c.lineno <= node.lineno
                and isinstance(c.ops[0], (ast.Is, ast.IsNot))
                for c in ast.walk(owner))
            out.append((rel, node.lineno, site, guarded))
    return out


def test_chaos_hook_sites_are_listed_and_guarded():
    """Every hook site is one of ``HOOK_SITES`` in its file, every listed
    site exists, and each sits behind the ``ACTIVE`` fast path (the
    allowlist of unguarded sites is empty)."""
    sites = _hook_sites()
    found = {}
    for rel, line, site, guarded in sites:
        want = HOOK_SITES.get(site)
        files = (want,) if isinstance(want, str) else (want or ())
        assert rel in files, f"{rel}:{line}: hook site {site!r} not in HOOK_SITES"
        if not guarded:
            assert (rel, site) in UNGUARDED_HOOK_ALLOWLIST, \
                f"{rel}:{line}: hook site {site!r} runs without the ACTIVE guard"
        found.setdefault(site, set()).add(rel)
    for site, want in HOOK_SITES.items():
        files = {want} if isinstance(want, str) else set(want)
        assert found.get(site) == files, (site, found.get(site))


def test_ha_telemetry_and_runner_threads_and_locks_are_linted():
    """The standby's tail thread, the chaos runner's threads and the GCS's
    and the telemetry store's locks are in what the passes see."""
    for rel, threads in (("cluster/ha.py", {"gcs-ha-tail"}),
                         ("chaos/runner.py", {"chaos-runner", "chaos-gcs-restart",
                                              "chaos-partition-heal"})):
        m = _model(rel)
        assert threads <= _thread_names(m), (rel, _thread_names(m))
        for th in m.threads:
            assert any(kw.arg == "daemon" and getattr(kw.value, "value", None) is True
                       for kw in th.node.keywords)
    m = _model("obs/telemetry.py")
    assert "TelemetryStore._lock" in m.locks
    guards = lock_guards.infer_guards(m)
    for attr in ("_reporters", "_series"):
        assert guards.get(("TelemetryStore", attr)) == "TelemetryStore._lock", attr
    m = _model("cluster/gcs_service.py")
    assert "GcsService._ha_lock" in m.locks
    assert lock_guards.infer_guards(m).get(("GcsService", "_ha")) == "GcsService._ha_lock"
