"""The port's training path held against ray_tpu's on the CPU.

LLAMA_TINY in fp32 (``dataclasses.replace(..., dtype=float32)`` on both
sides), the reference's own random params carried over with
``params_from_numpy``. Logits through ``forward`` (flash and xla
attention, with and without segment ids), ``loss_and_weight_fn`` and every
leaf's gradient against ``jax.value_and_grad``, and 5 AdamW steps of
``make_train_step`` against the reference's with
``optax.adamw(3e-4, weight_decay=1e-4)``.

Bands: logits 1e-4 and loss 1e-5 (two layers of matmuls run by different
CPU matmul libraries, which sum in different orders); gradients 5e-4 (the
reference's gradient band, tests/test_flash.py:88); final params after 5
steps 1e-4 absolute: Adam's first steps move each element by about
lr * sign(grad) whatever the gradient's size, so an element whose
gradient is near zero can land up to 2 * lr apart per step when the two
libraries' sums round it to opposite signs; 1e-4 holds here with margin
(the largest difference seen is 1.9e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.nn import layers as jlayers
from ray_tpu.train.step import TrainState as JTrainState
from ray_tpu.train.step import make_train_step as jmake_train_step
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.nn import layers as tlayers
from ray_tpu_torch.train import TrainState, adamw, make_train_step
from ray_tpu_torch.train.step import param_leaves

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

LOGITS = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=5e-4, atol=5e-4)


def _configs(impl="xla", **kw):
    j = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32, attention_impl=impl, **kw)
    t = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32, attention_impl=impl, **kw)
    return j, t


def _params(jc, tc, seed=0):
    jp = jllama.init_params(jc, jax.random.key(seed))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(seed=1, B=2, S=48, vocab=512, mask=False, segments=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        b["mask"] = (rng.random((B, S)) > 0.3).astype(np.float32)
    if segments:
        b["segment_ids"] = (np.arange(S)[None, :] >= np.array([[20], [31]])[:B]).astype(np.int32)
    return b


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("segments", [False, True])
def test_forward_logits_match(impl, segments):
    jc, tc = _configs(impl)
    jp, tp = _params(jc, tc)
    jb, tb = _both(_batch(segments=segments))
    seg_j, seg_t = jb.get("segment_ids"), tb.get("segment_ids")
    ref = jllama.forward(jp, jb["tokens"], jc, segment_ids=seg_j)
    with torch.no_grad():
        got = tllama.forward(tp, tb["tokens"], tc, segment_ids=seg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGITS)


def test_packed_positions_match():
    seg = _batch(segments=True)["segment_ids"]
    ref = jllama.packed_positions(jnp.asarray(seg), seg.shape[1])
    got = tllama.packed_positions(torch.from_numpy(seg), seg.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tllama.packed_positions(None, 5).numpy(), np.arange(5))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_every_grad_match_jax(impl):
    jc, tc = _configs(impl)
    jp, tp = _params(jc, tc)
    jb, tb = _both(_batch(mask=True, segments=True))
    (jloss, jw), jg = jax.value_and_grad(
        lambda p: jllama.loss_and_weight_fn(p, jb, jc), has_aux=True)(jp)
    state = TrainState.create(tp, adamw())
    loss, w = tllama.loss_and_weight_fn(state.params, tb, tc)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(w) == float(jw)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(param_leaves(tp)) == 12
    for path, ref in flat:
        leaf = tp
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **GRAD,
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_cross_entropy_matches_naive():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 9, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32) / 4
    tgt = rng.integers(0, 40, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.4).astype(np.float32)
    ref = jlayers.fused_cross_entropy_loss(*map(jnp.asarray, (h, w, tgt, mask)))
    th, tw = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    fused, total = tlayers.fused_cross_entropy_loss(th, tw, torch.from_numpy(tgt),
                                                    torch.from_numpy(mask))
    fused.backward()
    g_fused = (th.grad.clone(), tw.grad.clone())
    th.grad = tw.grad = None
    naive, total2 = tlayers.cross_entropy_loss(th @ tw, torch.from_numpy(tgt),
                                               torch.from_numpy(mask))
    naive.backward()
    np.testing.assert_allclose(float(fused), float(ref[0]), rtol=1e-6, atol=1e-6)
    assert float(total) == float(total2) == float(ref[1])
    np.testing.assert_allclose(float(fused), float(naive), rtol=1e-6, atol=1e-6)
    for a, b in zip(g_fused, (th.grad, tw.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_naive_ce_switch(monkeypatch):
    """RAY_TPU_NAIVE_CE takes the logits path; the loss and grads agree."""
    _, tc = _configs("flash")
    _, tp = _params(*_configs("flash"))
    _, tb = _both(_batch(mask=True))
    out = {}
    for naive in (False, True):
        if naive:
            monkeypatch.setenv("RAY_TPU_NAIVE_CE", "1")
        state = TrainState.create({k: (v.clone() if torch.is_tensor(v) else
                                       {n: t.clone() for n, t in v.items()})
                                   for k, v in tp.items()}, adamw())
        loss, _ = tllama.loss_and_weight_fn(state.params, tb, tc)
        loss.backward()
        out[naive] = (float(loss), [p.grad for p in param_leaves(state.params)])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_remat_does_not_change_grads(monkeypatch):
    """remat off, "full" and "dots" give the same loss and gradients, and
    "dots" saves the flash forward instead of running it again."""
    from ray_tpu_torch.ops import flash as tflash

    _, tb = _both(_batch(segments=True))
    calls = []
    orig = tflash.flash_attention_fwd_torch

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tflash, "flash_attention_fwd_torch", counted)

    results = {}
    for remat, policy in ((False, "dots"), (True, "full"), (True, "dots")):
        jc, tc = _configs("flash", remat=remat, remat_policy=policy)
        _, tp = _params(jc, tc)
        state = TrainState.create(tp, adamw())
        calls.clear()
        loss, _ = tllama.loss_and_weight_fn(state.params, tb, tc)
        loss.backward()
        results[(remat, policy)] = (float(loss), [p.grad for p in param_leaves(tp)], len(calls))
    base = results[(False, "dots")]
    for key, (loss, grads, n) in results.items():
        assert loss == base[0], key
        for a, b in zip(grads, base[1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert results[(False, "dots")][2] == 2  # one flash forward per layer
    assert results[(True, "dots")][2] == 2   # saved: not run again in backward
    assert results[(True, "full")][2] == 4   # full remat runs it again


def test_five_adamw_steps_match_reference():
    jc, tc = _configs("flash")
    jp, tp = _params(jc, tc)
    batch = _batch(seed=4, mask=True)
    jb, tb = _both(batch)
    opt = optax.adamw(3e-4, weight_decay=1e-4)
    jstate = JTrainState.create(jp, opt)
    jstep = jmake_train_step(lambda p, b: jllama.loss_and_weight_fn(p, b, jc), opt)
    state = TrainState.create(tp, adamw(3e-4, weight_decay=1e-4))
    step = make_train_step(lambda p, b: tllama.loss_and_weight_fn(p, b, tc), None)
    for i in range(5):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm, step {i}")
    assert state.step == 5
    ref = jax.tree.map(np.asarray, jstate.params)
    got = tllama.params_to_numpy(state.params)
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4, err_msg=jax.tree_util.keystr(path))


def test_grad_accum_with_mask_matches_one_batch():
    _, tc = _configs("flash")
    _, tp = _params(*_configs("flash"))
    _, tb = _both(_batch(seed=5, B=4, mask=True))
    runs = []
    for accum in (1, 2):
        params = {k: (v.clone() if torch.is_tensor(v) else {n: t.clone() for n, t in v.items()})
                  for k, v in tp.items()}
        state = TrainState.create(params, adamw())
        step = make_train_step(lambda p, b: tllama.loss_and_weight_fn(p, b, tc), grad_accum=accum)
        metrics = [step(state, tb)[1] for _ in range(2)]
        runs.append((metrics, param_leaves(state.params)))
    (m1, p1), (m2, p2) = runs
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(a["grad_norm"]), float(b["grad_norm"]), rtol=1e-5)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_params_round_trip_and_dtypes():
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    tree = jax.tree.map(np.asarray, jp)
    back = tllama.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert tp["layers"]["wq"].dtype == torch.float32
    bf16 = tllama.params_from_numpy(tree, dataclasses.replace(tc, param_dtype=torch.bfloat16),
                                    "cpu")
    assert bf16["embed"].dtype == torch.bfloat16
    # training weights follow param_dtype, serving casts to the compute dtype
    train = tllama.init_params(dataclasses.replace(tc, dtype=torch.bfloat16),
                               torch.Generator().manual_seed(0), device="cpu")
    assert train["layers"]["w_up"].dtype == torch.float32
    served = tllama.cast_params(train, torch.bfloat16)
    assert served["layers"]["w_up"].dtype == torch.bfloat16
    assert tllama.cast_params(tp, torch.float32)["embed"] is tp["embed"]


def test_config_counts_and_guards():
    for name in ("LLAMA_400M", "LLAMA_TINY", "LLAMA3_8B"):
        j, t = getattr(jllama, name), getattr(tllama, name)
        assert t.flops_per_token() == j.flops_per_token()
        assert t.num_params() == j.num_params()
        assert (t.remat, t.remat_policy, t.attention_impl) == (j.remat, j.remat_policy,
                                                               j.attention_impl)
    jc, tc = _configs()
    _, tp = _params(jc, tc)
    with pytest.raises(ValueError, match="max_seq"):
        tllama.forward(tp, torch.zeros(1, tc.max_seq + 1, dtype=torch.int32), tc)
    with pytest.raises(NotImplementedError):
        make_train_step(lambda p, b: 0.0, mesh=object())
    with pytest.raises(NotImplementedError):
        make_train_step(lambda p, b: 0.0, profile=True)
    opt = adamw()(param_leaves(tp))
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    with pytest.raises(ValueError, match="remat_policy"):
        bad = dataclasses.replace(tc, remat=True, remat_policy="nope")
        tllama.loss_fn(tp, _both(_batch())[1], bad)
