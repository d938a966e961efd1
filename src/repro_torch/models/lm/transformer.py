"""Transformer blocks of the dense LMs (counterpart of
``repro/models/lm/transformer.py``).

Functional, as the reference: ``*_init(generator, cfg) -> params dict`` and
pure apply functions over it. ``stack=(n,)`` draws ``n`` layers' params at
once as ``[n, ...]`` tensors (the reference ``vmap``s ``init`` over ``n``
keys: the same i.i.d. draws, another generator). Rounding points are the reference's: weights
are f32 masters cast to the activations' type at each product, norms and
RoPE compute in f32 and cast back.

Prefill and training attention is the flash kernel K7 through
``ops.flash_attention``, with K8 as its backward (the reference's chunked
jnp path and its Pallas kernels compute the same function; on the card the
port runs the kernels), cross-attention to an encoder's output included,
with the encoder's own key length. On a mesh whose rule picks the
``"seq"`` partition, causal self-attention is :func:`seqpar_attention`:
each rank of a model group attends its shard of the queries to the whole
K/V through K7 / K8 with a causal query offset, and the shards are
gathered along the sequence. Decode attends one token
against the KV cache in plain torch, as the reference does in jnp outside
any kernel. Products with weights stay ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.core.embedding.strategies import all_gather, copy_to_group
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshlib


def _normal(generator: torch.Generator, shape, scale: float,
            device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(cfg: LMConfig, d: Optional[int] = None, *,
              stack: Tuple[int, ...] = (), device=None) -> Dict:
    d = d or cfg.d_model
    if cfg.norm == "nonparam_ln":
        return {}
    return {"scale": torch.ones((*stack, d), dtype=torch.float32,
                                device=device)}


def norm_apply(params: Dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * params["scale"]
    elif cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * params["scale"]
    elif cfg.norm == "nonparam_ln":     # OLMo: no learnable affine
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
    else:
        raise ValueError(cfg.norm)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """``x [B, S, H, Dh]``, ``positions [B, S]`` -> rotated x."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(*args, **kwargs):
    """The reference's chunked jnp attention: the port's prefill attention
    is K7 (``ops.flash_attention``) or its plain version instead."""
    raise NotImplementedError(
        "chunked_attention has no port: prefill attention is the flash "
        "kernel K7 (kernels/ops.flash_attention) or its plain version")


def _attend(use_kernels: bool):
    """K7 / K8 (``ops.flash_attention``) or their plain version."""
    return ops.flash_attention if use_kernels else ops.flash_attention_plain


def seqpar_shard(q_shard: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 index: int, shard: int,
                 use_kernels: bool = True) -> torch.Tensor:
    """One rank's part of :func:`seqpar_attention`: its ``shard`` queries
    ``q_shard [B, shard, Hq, Dh]``, rows ``[index * shard, (index + 1) *
    shard)`` of the sequence, attended causally to the whole ``k/v [B, S,
    Hkv, Dh]`` (K7 / K8 with the query offset ``index * shard``, or their
    plain version) -> ``[B, shard, Hq, Dh]``. A plain function of its
    inputs, so a single device can replay every rank's part in turn."""
    return _attend(use_kernels)(q_shard, k, v, True, None, index * shard)


class _GatherShards(torch.autograd.Function):
    """The shards' outputs ``[B, shard, H, D]`` of a model group gathered
    along the sequence, in rank order; backward: this rank's own rows of
    the cotangent. Every rank of the group back-propagates the same loss
    from the gathered value, so each already holds its whole cotangent
    (``strategies.all_gather``'s own adjoint, the recsys reduce-scatter,
    would sum ``model`` copies of it)."""

    @staticmethod
    def forward(ctx, o, group, index):
        ctx.index, ctx.shard = index, o.shape[1]
        return all_gather(o.detach().transpose(0, 1), group).transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.index, ctx.shard
        return g[:, i * n:(i + 1) * n], None, None


def seqpar_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mesh, *, use_kernels: bool = True) -> torch.Tensor:
    """Sequence-parallel causal attention over ``mesh``'s ``"model"`` axis
    (``repro/models/lm/transformer.py::seqpar_attention``): ``q [B, S, Hq,
    Dh]``, ``k/v [B, S, Hkv, Dh]``, held alike by the ranks of a model
    group -> ``[B, S, Hq, Dh]``, alike on them too. Rank ``i`` of ``m``
    attends query rows ``[i * S / m, (i + 1) * S / m)`` to the whole K/V
    (:func:`seqpar_shard`), and the shards are gathered along the
    sequence. With ``m == 1`` or ``S`` not a multiple of ``m``, the whole
    causal attention, as the reference falls back.

    The gradients follow the mesh's rule: q, k and v enter the shard's
    work through ``strategies.copy_to_group``, so the query rows' zeros
    outside the shard and each shard's ``dk`` / ``dv`` are summed over the
    group on the way back, and every rank ends with the whole gradients of
    a one-device run; the gather back-propagates as taking the rank's own
    rows. The reference's folded chunks round ``p`` to the values' type
    before the PV product; K7 does too in bf16, its plain version keeps
    f32 (f32 models: the same function)."""
    m = meshlib.axis_size(mesh, ("model",))
    s = q.shape[1]
    if m == 1 or s % m:
        return _attend(use_kernels)(q, k, v, True, None)
    shard, i = s // m, mesh.get_local_rank("model")
    group = meshlib.axis_group(mesh, ("model",))
    q, k, v = (copy_to_group(t, group) for t in (q, k, v))
    o = seqpar_shard(q[:, i * shard:(i + 1) * shard], k, v, i, shard,
                     use_kernels)
    return _GatherShards.apply(o, group, i)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Single-token attention: ``q [B, 1, Hq, Dh]`` against the whole cache
    ``[B, Smax, Hkv, Dh]``; entries past ``pos [B]`` are masked. In f32.
    (Local attention decodes against a rolling cache instead:
    :func:`_rolling_decode`.)"""
    b, _, hq, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) \
        * (1.0 / math.sqrt(dh))
    idx = torch.arange(smax, device=q.device)[None]        # [1, smax]
    valid = idx <= pos[:, None]
    s = torch.where(valid[:, None, None], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def _rolling_decode(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: torch.Tensor,
                    smax: int) -> torch.Tensor:
    """Decode against a rolling (windowed) cache of ``smax`` entries, the
    token at position ``p`` stored at entry ``p % smax``: entry ``i`` holds
    position ``pos - pos % smax + i`` if ``i <= pos % smax``, else that
    less ``smax``. Entries of negative position (the window not yet
    filled) are masked; all are valid once it has. In f32."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    idx = torch.arange(smax, device=q.device)[None]           # [1, smax]
    cur = pos[:, None] % smax
    entry_pos = torch.where(idx <= cur, pos[:, None] - cur + idx,
                            pos[:, None] - cur + idx - smax)
    valid = entry_pos >= 0
    qg = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) \
        / math.sqrt(dh)
    s = torch.where(valid[:, None, None], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def attn_init(generator: torch.Generator, cfg: LMConfig, *,
              stack: Tuple[int, ...] = (), device=None) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(hq * hd)
    return {
        "wq": _normal(generator, (*stack, d, hq * hd), s, device),
        "wk": _normal(generator, (*stack, d, hkv * hd), s, device),
        "wv": _normal(generator, (*stack, d, hkv * hd), s, device),
        "wo": _normal(generator, (*stack, hq * hd, d), so, device),
        "norm": norm_init(cfg, stack=stack, device=device),
    }


def attn_apply(params: Dict, x: torch.Tensor, cfg: LMConfig, *,
               positions: torch.Tensor, causal: bool = True,
               window: Optional[int] = None,
               cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               cache_pos: Optional[torch.Tensor] = None,
               kv_from: Optional[torch.Tensor] = None,
               keep_cache: bool = False,
               use_kernels: bool = True,
               seq_par_mesh=None,
               ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Pre-norm attention with residual
    (``repro/models/lm/transformer.py::attn_apply``).

    * prefill and training: ``cache=None`` -> full-sequence attention
      through K7, with K8 as its backward (``use_kernels``), or the plain
      version; ``window`` keeps keys ``j > i - window`` (local attention).
      With ``seq_par_mesh`` (the reference's, given where the model's
      rule picks the ``"seq"`` partition), causal self-attention without
      a window is :func:`seqpar_attention` over its ``"model"`` axis.
    * cross-attention: ``kv_from [B, Senc, D]`` (an encoder's output)
      supplies K and V, normalised by the same ``norm`` parameters as the
      queries' input (the reference's ``:304``); no RoPE on either side
      (``:309``); the caller passes ``causal=False``, and K7 / K8 run with
      the key length ``Senc``.
    * decode: ``cache=(k_cache, v_cache)`` ``[B, Smax, Hkv, Dh]``, ``x [B,
      1, D]``; the new K/V are written at ``cache_pos`` (at ``cache_pos %
      Smax``, a rolling cache, with a ``window``) **in place** (the
      reference returns an updated copy; the port saves the copy of every
      layer's cache each step) and the token attends against the cache.
      With ``keep_cache`` the cache passed in is left as it is: the token
      attends against a copy with its K/V written in, and a ``cache_pos``
      past ``Smax`` writes nothing (as JAX's out-of-bounds scatter drops
      the write). That is the reference's encoder-decoder decode, which
      calls its cross layer with the cross cache and no ``kv_from`` and
      discards the cache it gets back.

    ``kv_from`` with a ``cache`` (the reference's branch at ``:329``, which
    none of its callers reaches) raises ``ValueError``.
    """
    if kv_from is not None and cache is not None:
        raise ValueError("cross-attention (kv_from) takes no cache")
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    cd = x.dtype
    h = norm_apply(params.get("norm", {}), x, cfg)
    kv_src = h if kv_from is None else norm_apply(params.get("norm", {}),
                                                  kv_from, cfg)
    q = (h @ params["wq"].to(cd)).reshape(b, -1, hq, hd)
    k = (kv_src @ params["wk"].to(cd)).reshape(b, -1, hkv, hd)
    v = (kv_src @ params["wv"].to(cd)).reshape(b, -1, hkv, hd)
    if kv_from is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        smax = k_cache.shape[1]
        bidx = torch.arange(b, device=x.device)
        slot = cache_pos.long()
        if window is not None:
            slot = slot % smax
        kt, vt = k[:, 0], v[:, 0]
        if keep_cache:
            k_cache, v_cache = k_cache.clone(), v_cache.clone()
            # a write past the end keeps the entry it lands on (no sync)
            inside = (slot < smax)[:, None, None]
            slot = slot.clamp(max=smax - 1)
            kt = torch.where(inside, kt, k_cache[bidx, slot])
            vt = torch.where(inside, vt, v_cache[bidx, slot])
        k_cache[bidx, slot] = kt
        v_cache[bidx, slot] = vt
        new_cache = cache if keep_cache else (k_cache, v_cache)
        if window is not None:
            o = _rolling_decode(q, k_cache, v_cache, cache_pos, smax)
        else:
            o = decode_attention(q, k_cache, v_cache, cache_pos)
    elif seq_par_mesh is not None and window is None and causal and \
            kv_from is None:
        o = seqpar_attention(q, k, v, seq_par_mesh, use_kernels=use_kernels)
    else:
        o = _attend(use_kernels)(q, k, v, causal, window)
    out = o.reshape(b, -1, hq * hd) @ params["wo"].to(cd)
    return x + out, new_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_init(generator: torch.Generator, cfg: LMConfig,
             d_ff: Optional[int] = None, *, stack: Tuple[int, ...] = (),
             device=None) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "w1": _normal(generator, (*stack, d, f), s, device),
        "w2": _normal(generator, (*stack, f, d), so, device),
        "norm": norm_init(cfg, stack=stack, device=device),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = _normal(generator, (*stack, d, f), s, device)
    return p


def ffn_apply(params: Dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    cd = x.dtype
    h = norm_apply(params.get("norm", {}), x, cfg)
    u = h @ params["w1"].to(cd)
    # jax.nn.gelu's default is the tanh approximation
    if cfg.activation == "swiglu":
        u = F.silu(u) * (h @ params["w3"].to(cd))
    elif cfg.activation == "geglu":
        u = F.gelu(u, approximate="tanh") * (h @ params["w3"].to(cd))
    elif cfg.activation == "gelu":
        u = F.gelu(u, approximate="tanh")
    elif cfg.activation == "relu":
        u = F.relu(u)
    elif cfg.activation == "relu_sq":
        u = torch.square(F.relu(u))
    else:
        raise ValueError(cfg.activation)
    return x + u @ params["w2"].to(cd)
