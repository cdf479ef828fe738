"""Runtime environments on the port's cluster: env_vars / working_dir /
py_modules with env-dedicated worker pools (the 6 cases of
``tests/test_runtime_env.py`` on ``ray_tpu_torch``, to those tests'
expectations), and the same ``env_hash`` as the reference's for the same
wire form."""

import os
import sys

import pytest

from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core import api
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

register_pickle_by_value(sys.modules[__name__])


def assert_no_cluster_left(c):
    """No process of ``c`` (GCS, daemons, workers) and no store file of its
    daemons outlived its shutdown."""
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


@pytest.fixture(scope="module")
def attached_cluster():
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="re0")
        c.wait_for_nodes(1)
        api.init(address=c.address, ignore_reinit_error=True)
        yield c
    finally:
        api.shutdown()
        c.shutdown()
        assert_no_cluster_left(c)


def test_env_vars_and_worker_isolation(attached_cluster):
    @api.remote(runtime_env={"env_vars": {"MY_FLAG": "banana"}})
    def read_flag():
        import os

        return os.environ.get("MY_FLAG"), os.getpid()

    @api.remote
    def read_plain():
        import os

        return os.environ.get("MY_FLAG"), os.getpid()

    flag, env_pid = api.get(read_flag.remote())
    assert flag == "banana"
    plain, plain_pid = api.get(read_plain.remote())
    assert plain is None  # a plain worker never saw the env var
    assert env_pid != plain_pid  # dedicated worker per runtime env


def test_working_dir_ships_files(attached_cluster, tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "config.txt").write_text("the-answer=42")
    (proj / "helper.py").write_text("VALUE = 'from-helper'\n")

    @api.remote(runtime_env={"working_dir": str(proj)})
    def read_project():
        import os

        import helper  # importable: working_dir lands on PYTHONPATH

        with open("config.txt") as f:  # cwd = extracted working_dir
            cfg = f.read()
        return cfg, helper.VALUE, os.getcwd()

    cfg, helper_value, cwd = api.get(read_project.remote())
    assert cfg == "the-answer=42"
    assert helper_value == "from-helper"
    assert "proj" not in cwd  # runs from the extracted cache, not the source


def test_py_modules_importable(attached_cluster, tmp_path):
    mod = tmp_path / "mylib"
    mod.mkdir()
    (mod / "__init__.py").write_text("def double(x):\n    return 2 * x\n")

    @api.remote(runtime_env={"py_modules": [str(mod)]})
    def use_lib(x):
        import mylib

        return mylib.double(x)

    assert api.get(use_lib.remote(21)) == 42


def test_actor_runtime_env(attached_cluster):
    @api.remote(runtime_env={"env_vars": {"ACTOR_MODE": "special"}})
    class EnvActor:
        def mode(self):
            import os

            return os.environ.get("ACTOR_MODE")

    h = EnvActor.remote()
    assert api.get(h.mode.remote()) == "special"
    api.kill(h)


def test_pip_rejected(attached_cluster):
    @api.remote(runtime_env={"pip": ["requests"]})
    def f():
        return 1

    with pytest.raises(ValueError, match="not supported"):
        f.remote()


def test_runtime_env_requires_cluster():
    # no cluster attached in THIS in-process runtime path
    from ray_tpu_torch.core.api import _CLUSTER

    saved, _CLUSTER[0] = _CLUSTER[0], None
    try:
        @api.remote(runtime_env={"env_vars": {"X": "1"}})
        def f():
            return 1

        with pytest.raises(ValueError, match="cluster"):
            f.remote()
    finally:
        _CLUSTER[0] = saved


def test_env_hash_equals_reference(tmp_path):
    """One directory and one env spec give the reference's wire form and
    ``env_hash`` (the worker-pool key) on the port."""
    import hashlib

    from ray_tpu.cluster import runtime_env as jre
    from ray_tpu_torch.cluster import runtime_env as tre

    proj = tmp_path / "proj"
    (proj / "sub").mkdir(parents=True)
    (proj / "a.py").write_text("A = 1\n")
    (proj / "sub" / "data.txt").write_text("x" * 1000)
    (proj / "__pycache__").mkdir()
    (proj / "__pycache__" / "a.cpython-312.pyc").write_bytes(b"skipped")
    mod = tmp_path / "mylib"
    mod.mkdir()
    (mod / "__init__.py").write_text("def f():\n    return 2\n")
    spec = {"env_vars": {"K": 1, "L": "two"}, "working_dir": str(proj), "py_modules": [str(mod)]}

    def put(data):
        return hashlib.sha256(data).digest()[:16]

    want, got = jre.package_runtime_env(spec, put), tre.package_runtime_env(spec, put)
    assert got == want
    assert tre.env_hash(got) == jre.env_hash(want) != ""
    assert tre.env_hash(None) == jre.env_hash(None) == ""
