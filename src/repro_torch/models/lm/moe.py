"""Mixture-of-Experts FFN of the granite family (counterpart of
``repro/models/lm/moe.py``), on one device or with its experts over the
``"model"`` axis of a mesh.

Each token's normed activations go to its ``top_k`` experts by the router
logits; the tokens of each expert are gathered into a bucket of
``capacity`` rows (stable in token order, overflow dropped), the SwiGLU
expert FFN runs over the ``[E, C, D]`` buckets as batched products, and
the outputs come back weighted by the softmax of the chosen logits.

On a mesh (:func:`moe_apply_local`) the experts are padded to a multiple
of the model axis (:func:`padded_experts`; the padding experts are masked
out of routing) and each rank holds ``e_loc`` whole experts, as the
paper's localized slot embedding places whole slots. The batch is split
over the data axes only, so every rank of a model group routes the same
tokens, each to its own experts, and one sum over ``"model"`` combines
the parts (``strategies.all_reduce``; the tokens and gates enter each
rank's experts through ``strategies.copy_to_group``, whose adjoint sums
their gradients over the group). ``capacity`` comes from the rank's
block's token count and the unpadded expert count, as in the reference:
a mesh drops other assignments than one device. :func:`moe_apply` is the
same body on one device, every expert local.

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
from repro_torch.core.embedding.strategies import all_reduce, copy_to_group
from repro_torch.launch import mesh as meshlib
from repro_torch.models.lm.transformer import _normal, norm_apply, norm_init


def padded_experts(cfg: LMConfig, model_axis_size: int = 1) -> int:
    """The expert count padded to a multiple of the model axis; one device
    pads nothing."""
    e = cfg.moe.num_experts
    return (e + model_axis_size - 1) // model_axis_size * model_axis_size


def moe_init(generator: torch.Generator, cfg: LMConfig,
             model_axis_size: int = 1, *, stack: Tuple[int, ...] = (),
             device=None) -> Dict:
    """The reference's tree and scales at the padded expert count ``E``:
    ``router [D, E]`` and ``w1`` / ``w3 [E, D, F]`` at ``1/sqrt(D)``, ``w2
    [E, F, D]`` at ``1/sqrt(F)``, and the pre-norm."""
    d, f = cfg.d_model, cfg.moe.expert_d_ff
    e = padded_experts(cfg, model_axis_size)
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
    """``x [B, S, D]`` -> ``x + moe(x)`` in ``x``'s type, every expert on
    this device."""
    return _moe(params, x, cfg, e_pad=cfg.moe.num_experts, e0=0, group=None)


def moe_apply_local(params: Dict, x: torch.Tensor, cfg: LMConfig, *, mesh,
                    model_axis: str = "model",
                    model_axis_size: int) -> torch.Tensor:
    """One rank's MoE on a mesh: ``x [B_loc, S, D]``, this rank's data
    block (the same on every rank of its model group), and this rank's
    experts, ``w1`` / ``w3 [E_loc, D, F]`` and ``w2 [E_loc, F, D]`` (the
    router whole); returns ``x + moe(x)``, summed over ``model_axis``."""
    e_loc = params["w1"].shape[0]
    return _moe(params, x, cfg,
                e_pad=padded_experts(cfg, model_axis_size),
                e0=mesh.get_local_rank(model_axis) * e_loc,
                group=meshlib.axis_group(mesh, (model_axis,)))


def _moe(params: Dict, x: torch.Tensor, cfg: LMConfig, *, e_pad: int,
         e0: int, group) -> torch.Tensor:
    """The body of :func:`moe_apply_local`: routes over all ``e_pad``
    experts, runs the local ones (``e0`` the first), and sums the parts
    over ``group`` (None: one device, every expert local)."""
    moe = cfg.moe
    b, s, d = x.shape
    e_loc, k = params["w1"].shape[0], moe.top_k
    cd = x.dtype
    h = norm_apply(params.get("norm", {}), x, cfg)
    logits = (h @ params["router"].to(cd)).float()
    if e_pad > moe.num_experts:                  # mask padding experts
        logits = logits.masked_fill(
            torch.arange(e_pad, device=x.device) >= moe.num_experts, -1e30)
    gate_vals, sel = _top_k(logits, k)                      # [B, S, k]
    gate = torch.softmax(gate_vals, dim=-1)

    n = b * s
    flat = h.reshape(n, d)
    if group is not None:
        flat, gate = copy_to_group(flat, group), copy_to_group(gate, group)
    tok_of = torch.arange(n, device=x.device).repeat_interleave(k)
    # each expert's bucket rows, computed in Python as the reference does
    capacity = max(1, int(n * k / moe.num_experts * moe.capacity_factor))
    rel = sel.reshape(n * k) - e0
    owner = torch.where((rel >= 0) & (rel < e_loc), rel, e_loc)
    slot = _bucket(owner, e_loc, capacity)                  # [n*k]
    valid = slot < e_loc * capacity

    # gather the tokens into [E_loc, C, D]. The reference reads a zero row
    # into each empty slot and out for each dropped or remote assignment;
    # here each reads a row of its own, zeroed, since one shared row makes
    # the gathers' backward add thousands of gradients into it one by one
    m = e_loc * capacity
    buf_tok = torch.full((m + 1,), -1, dtype=torch.int64, device=x.device)
    buf_tok[slot] = tok_of                  # the drops land on entry m
    buf_tok = buf_tok[:m]
    filled = buf_tok >= 0
    buf = flat[torch.where(filled, buf_tok,
                           torch.arange(m, device=x.device) % n)] \
        * filled[:, None].to(cd)
    buf = buf.reshape(e_loc, capacity, d)

    u = F.silu(torch.matmul(buf, params["w1"].to(cd))) \
        * torch.matmul(buf, params["w3"].to(cd))
    y_buf = torch.matmul(u, params["w2"].to(cd)).reshape(m, d)

    # back to the tokens, weighted by their gates: tok_of is token-major,
    # so the reference's scatter-add is the sum over k of [n, k, D]
    own = torch.where(valid, slot, torch.arange(n * k, device=x.device) % m)
    contrib = y_buf[own] * (gate.reshape(n * k)
                            * valid).to(y_buf.dtype)[:, None]
    y = contrib.float().reshape(n, k, d).sum(1)
    if group is not None:
        y = all_reduce(y, group)
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
