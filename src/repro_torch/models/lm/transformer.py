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
port runs the kernels). Decode attends one token
against the KV cache in plain torch, as the reference does in jnp outside
any kernel. Products with weights stay ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.kernels import ops
from repro_torch.roadmap import (  # noqa: F401 (the backbone's items too)
    ENCDEC, SEQPAR, not_ported,
)


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


def seqpar_attention(*args, **kwargs):
    raise not_ported("sequence-parallel attention (seqpar_attention)",
                     SEQPAR)


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
               use_kernels: bool = True,
               ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Pre-norm attention with residual.

    * prefill and training: ``cache=None`` -> full-sequence attention
      through K7, with K8 as its backward (``use_kernels``), or the plain
      version; ``window`` keeps keys ``j > i - window`` (local attention).
    * decode: ``cache=(k_cache, v_cache)`` ``[B, Smax, Hkv, Dh]``, ``x [B,
      1, D]``; the new K/V are written at ``cache_pos`` (at ``cache_pos %
      Smax``, a rolling cache, with a ``window``) **in place** (the
      reference returns an updated copy; the port saves the copy of every
      layer's cache each step) and the token attends against the cache.
    """
    if kv_from is not None:
        raise not_ported("cross-attention (kv_from)", ENCDEC)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    cd = x.dtype
    h = norm_apply(params.get("norm", {}), x, cfg)
    q = (h @ params["wq"].to(cd)).reshape(b, -1, hq, hd)
    k = (h @ params["wk"].to(cd)).reshape(b, -1, hkv, hd)
    v = (h @ params["wv"].to(cd)).reshape(b, -1, hkv, hd)
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
        k_cache[bidx, slot] = k[:, 0]
        v_cache[bidx, slot] = v[:, 0]
        new_cache = (k_cache, v_cache)
        if window is not None:
            o = _rolling_decode(q, k_cache, v_cache, cache_pos, smax)
        else:
            o = decode_attention(q, k_cache, v_cache, cache_pos)
    else:
        attend = ops.flash_attention if use_kernels \
            else ops.flash_attention_plain
        o = attend(q, k, v, causal, window)
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
