"""Distribution-preserving acceptance of drafted tokens (counterpart of
``ray_tpu/llm/spec/accept.py``).

The standard speculative-sampling rule for deterministic drafters: accept
drafted token x_j with probability p_j(x_j), the target probability of
the drafted token; on the first rejection resample from the residual
max(p_j - onehot(x_j), 0) renormalized; if every draft survives, sample
a bonus token from p_k. A verify pass emits accepted + 1 tokens, and the
marginal of every emitted token is the target sampling distribution.

Randomness: the uniforms and the resample draw from the sampler's
counter-based noise (``sampling.uniforms`` / ``sampling.gumbel``) under
two fixed stream tags of the row seed, 0 and 1, where the reference folds
0 and 1 into the row key.

Greedy (``mode="greedy"``, and greedy rows in any mode): accept iff the
target argmax equals the draft; the resample and the bonus are the
argmax, so greedy spec output equals plain greedy decode token for token.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.llm.sampling import gumbel, stream_seeds, target_probs, uniforms

ACCEPT_TAG, RESAMPLE_TAG = 0, 1


def accept_draft(
    logits: torch.Tensor,        # [B, K+1, V] fp32; position j conditions on fed tokens 0..j
    draft_tokens: torch.Tensor,  # [B, K] (pad arbitrary past draft_lens)
    draft_lens: torch.Tensor,    # [B] 0..K
    temperatures: torch.Tensor,  # [B]
    top_ks: torch.Tensor,        # [B]
    top_ps: torch.Tensor,        # [B]
    seeds: torch.Tensor,         # [B] int64 row seeds (unused in greedy mode)
    mode: str = "sample",        # "greedy" | "categorical" | "sample"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out_tokens [B, K+1] int64, out_logprobs [B, K+1], accepted [B]).

    Columns 0..accepted-1 are the accepted drafted tokens, column
    ``accepted`` the bonus / resample token; the caller keeps accepted + 1
    tokens per row. Logprobs are the raw logits' log-softmax at the
    emitted token, as in ``sample_tokens``."""
    B, K1, V = logits.shape
    K = K1 - 1
    if K < 1:
        raise ValueError("spec verify needs at least one drafted column")
    dev = logits.device
    draft = draft_tokens.long()
    jpos = torch.arange(K, device=dev)[None, :]
    cols = torch.arange(K1, device=dev)[None, :]
    in_draft = jpos < draft_lens.long()[:, None]
    logp_all = torch.log_softmax(logits, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)  # [B, K+1]

    def accepted_from(ok):
        return torch.cumprod(ok.long(), dim=1).sum(dim=1)

    if mode == "greedy":
        accepted = accepted_from((greedy_tok[:, :K] == draft) & in_draft)
        lp = torch.gather(logp_all, 2, greedy_tok[..., None])[..., 0]
        return greedy_tok, lp, accepted

    # per-position target distributions [B, K+1, V]; "categorical" batches
    # (no top-k/top-p among sampled rows) need no full-vocab sort
    if mode == "categorical":
        t = torch.where(temperatures <= 0.0, torch.ones_like(temperatures), temperatures)
        p = torch.softmax(logits / t[:, None, None], dim=-1)
    else:
        rep = lambda x: x.repeat_interleave(K1)  # noqa: E731
        p = target_probs(logits.reshape(B * K1, V), rep(temperatures), rep(top_ks),
                         rep(top_ps)).reshape(B, K1, V)

    p_draft = torch.gather(p[:, :K], 2, draft[..., None])[..., 0]  # [B, K]
    u = uniforms(stream_seeds(seeds, ACCEPT_TAG), K)
    # per-row greedy short-circuit: a greedy row accepts iff the draft IS
    # the argmax and emits the argmax at the bonus / rejection position
    is_greedy = temperatures <= 0.0
    ok = torch.where(is_greedy[:, None], greedy_tok[:, :K] == draft, u < p_draft) & in_draft
    accepted = accepted_from(ok)

    rows = torch.arange(B, device=dev)
    p_a = p[rows, accepted]  # [B, V]
    d_a = draft[rows, accepted.clamp(0, K - 1)]
    resid = (p_a - torch.nn.functional.one_hot(d_a, V).to(p_a.dtype)).clamp_min(0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    # an all-zero residual is unreachable (the draft would have been
    # accepted with probability 1); the fallback keeps it NaN-free
    resid = torch.where(rs > 0.0, resid / rs.clamp_min(1e-20), p_a)
    rejected = accepted < draft_lens.long()
    final_dist = torch.where(rejected[:, None], resid, p_a)
    g = gumbel(stream_seeds(seeds, RESAMPLE_TAG), V)
    final_tok = torch.argmax(torch.log(final_dist.clamp_min(1e-38)) + g, dim=-1)
    final_tok = torch.where(is_greedy, greedy_tok[rows, accepted], final_tok)

    draft_pad = torch.nn.functional.pad(draft, (0, 1))  # [B, K+1]
    out = torch.where(cols < accepted[:, None], draft_pad, torch.zeros_like(draft_pad))
    out = torch.where(cols == accepted[:, None], final_tok[:, None], out)
    lp = torch.gather(logp_all, 2, out[..., None])[..., 0]
    return out, lp, accepted
