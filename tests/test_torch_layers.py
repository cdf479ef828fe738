"""ray_tpu_torch.nn.layers held against ray_tpu.nn.layers on the CPU.

Same numpy inputs through both; fp32 band 2e-5 (the tests/test_flash.py
forward band).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.nn import layers as jl
from ray_tpu_torch.nn import layers as tl

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 128)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = tl.rms_norm(_t(x), _t(scale), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_rms_norm_keeps_bf16_dtype():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    assert tl.rms_norm(x, torch.ones(16)).dtype == torch.bfloat16


@pytest.mark.parametrize("head_dim,max_seq,theta", [(16, 64, 500000.0), (128, 256, 10000.0)])
def test_rope_frequencies(head_dim, max_seq, theta):
    jc, js = jl.rope_frequencies(head_dim, max_seq, theta)
    tc, ts = tl.rope_frequencies(head_dim, max_seq, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_half_split(batched_positions):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 6, 4, 16
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if batched_positions:
        pos = rng.integers(0, 60, size=(B, S)).astype(np.int32)
    else:
        pos = np.arange(3, 3 + S, dtype=np.int32)
    jc, js = jl.rope_frequencies(D, 64, 500000.0)
    tc, ts = tl.rope_frequencies(D, 64, 500000.0)
    ref = np.asarray(jl.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos)))
    got = tl.apply_rope(_t(x), tc, ts, torch.from_numpy(pos).long()).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_swiglu():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) / 6 for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) / 7
    ref = np.asarray(jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))
    got = tl.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
