"""Mixture-of-Experts FFN of the granite family on one device (counterpart
of ``repro/models/lm/moe.py``).

Each token's normed activations go to its ``top_k`` experts by the router
logits; the tokens of each expert are gathered into a bucket of
``capacity`` rows (stable in token order, overflow dropped), the SwiGLU
expert FFN runs over the ``[E, C, D]`` buckets as batched products, and
the outputs come back weighted by the softmax of the chosen logits. This
is the reference's ``moe_apply_local`` at a model axis of one device:
every expert is local and its ``psum`` is the identity. Expert
parallelism over a mesh raises ``NotImplementedError`` naming ROADMAP
queue 1 item 4.

Selection keeps the reference's tie rule: ``jax.lax.top_k`` puts the
lower expert index first among equal logits, which ``torch.topk`` does
not promise, so the experts are taken from a stable descending sort. The
bucket slots are the reference's ``_bucket``'s, int for int. The combine
sums each token's ``top_k`` contributions in f32 as a ``[n, k, D]`` view
(the reference's scatter-add over ``tok_of = repeat(arange(n), k)``): no
atomics, so the card adds in one fixed order. No Pallas kernel: the
expert products stay ``torch.matmul``, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.lm.transformer import _normal, norm_apply, norm_init
from repro_torch.roadmap import MULTI_DEVICE, not_ported


def padded_experts(cfg: LMConfig, model_axis_size: int = 1) -> int:
    """The expert count padded to a multiple of the model axis; one device
    pads nothing."""
    if model_axis_size != 1:
        raise not_ported(f"expert parallelism over a model axis of "
                         f"{model_axis_size}", MULTI_DEVICE)
    return cfg.moe.num_experts


def moe_init(generator: torch.Generator, cfg: LMConfig, *,
             stack: Tuple[int, ...] = (), device=None) -> Dict:
    """The reference's tree and scales: ``router [D, E]`` and ``w1`` /
    ``w3 [E, D, F]`` at ``1/sqrt(D)``, ``w2 [E, F, D]`` at ``1/sqrt(F)``,
    and the pre-norm."""
    d, f = cfg.d_model, cfg.moe.expert_d_ff
    e = padded_experts(cfg)
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": _normal(generator, (*stack, d, e), s, device),
        "w1": _normal(generator, (*stack, e, d, f), s, device),
        "w3": _normal(generator, (*stack, e, d, f), s, device),
        "w2": _normal(generator, (*stack, e, f, d), so, device),
        "norm": norm_init(cfg, stack=stack, device=device),
    }


def _top_k(logits: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest logits and their indices, largest first and the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bucket(owner: torch.Tensor, n_buckets: int,
            capacity: int) -> torch.Tensor:
    """``owner [N]`` in ``[0, n_buckets]`` (``n_buckets`` = drop) -> each
    entry's slot ``bucket * capacity + position`` in token order, or
    ``n_buckets * capacity`` where the bucket is full or the entry
    dropped."""
    m = owner.shape[0]
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    start = torch.searchsorted(
        sorted_owner, torch.arange(n_buckets + 1, device=owner.device,
                                   dtype=owner.dtype))
    pos = torch.arange(m, device=owner.device) - start[sorted_owner]
    ok = (pos < capacity) & (sorted_owner < n_buckets)
    slot_sorted = torch.where(ok, sorted_owner * capacity + pos,
                              n_buckets * capacity)
    return torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)


def moe_apply(params: Dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """``x [B, S, D]`` -> ``x + moe(x)`` in ``x``'s type."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = padded_experts(cfg), moe.top_k
    cd = x.dtype
    h = norm_apply(params.get("norm", {}), x, cfg)
    logits = (h @ params["router"].to(cd)).float()
    gate_vals, sel = _top_k(logits, k)                      # [B, S, k]
    gate = torch.softmax(gate_vals, dim=-1)

    n = b * s
    flat = h.reshape(n, d)
    tok_of = torch.arange(n, device=x.device).repeat_interleave(k)
    # each expert's bucket rows, computed in Python as the reference does
    capacity = max(1, int(n * k / moe.num_experts * moe.capacity_factor))
    slot = _bucket(sel.reshape(n * k), e, capacity)         # [n*k]
    valid = slot < e * capacity

    # gather the tokens into [E, C, D]. The reference reads a zero row
    # into each empty slot and out for each dropped assignment; here each
    # reads a row of its own, zeroed, since one shared row makes the
    # gathers' backward add thousands of gradients into it one by one
    m = e * capacity
    buf_tok = torch.full((m + 1,), -1, dtype=torch.int64, device=x.device)
    buf_tok[slot] = tok_of                  # the drops land on entry m
    buf_tok = buf_tok[:m]
    filled = buf_tok >= 0
    buf = flat[torch.where(filled, buf_tok,
                           torch.arange(m, device=x.device) % n)] \
        * filled[:, None].to(cd)
    buf = buf.reshape(e, capacity, d)

    u = F.silu(torch.matmul(buf, params["w1"].to(cd))) \
        * torch.matmul(buf, params["w3"].to(cd))
    y_buf = torch.matmul(u, params["w2"].to(cd)).reshape(m, d)

    # back to the tokens, weighted by their gates: tok_of is token-major,
    # so the reference's scatter-add is the sum over k of [n, k, D]
    own = torch.where(valid, slot, torch.arange(n * k, device=x.device) % m)
    contrib = y_buf[own] * (gate.reshape(n * k)
                            * valid).to(y_buf.dtype)[:, None]
    y = contrib.float().reshape(n, k, d).sum(1)
    return x + y.reshape(b, s, d).to(cd)


def aux_load_balance_loss(logits: torch.Tensor, sel: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary: ``num_experts`` x the sum over
    experts of (share of tokens whose first choice it is) x (mean router
    probability). The reference defines it and calls it nowhere."""
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(sel[..., 0], logits.shape[-1]).to(
        probs.dtype).mean(dim=(0, 1))
    return num_experts * torch.sum(frac * probs.mean(dim=(0, 1)))
