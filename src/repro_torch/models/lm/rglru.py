"""RG-LRU recurrent block of RecurrentGemma / Griffin (arXiv:2402.19427),
counterpart of ``repro/models/lm/rglru.py``.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_a x_t)                      (recurrence gate)
    i_t = sigmoid(W_x x_t)                      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)      (elementwise decay, c=8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block layout (Griffin): x -> {linear -> GeLU} * {linear -> causal conv1d(4)
-> RG-LRU} -> linear out, with pre-norm and residual. Rounding points are
the reference's: products in the activations' type, the gates, decay and
recurrence in f32.

The recurrence is elementwise-linear. The reference runs it over the
sequence with ``lax.associative_scan``; here it is a log-depth
(Hillis-Steele) inclusive scan of the ``(a, b)`` pairs in plain torch ops,
``ceil(log2 S)`` rounds (12 at S 4096), which autograd differentiates.
It is no Pallas kernel in the reference, so plain torch is its port.
Decode keeps an O(1) state: ``h [B, D]`` and the last three pre-conv
inputs ``conv [B, 3, D]``, both f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.lm.transformer import _normal, norm_apply, norm_init

_C = 8.0
_CONV_K = 4


def rglru_init(generator: torch.Generator, cfg: LMConfig, *,
               stack: Tuple[int, ...] = (), device=None) -> Dict:
    """The reference's keys and distributions: the five ``[D, D]``
    products at ``1/sqrt(D)``, the ``[4, D]`` conv at ``1/2``, and
    ``lam = softplus^-1(-log u)`` with ``u ~ U[0.9, 0.999]`` (so that
    ``a^(1/c)`` starts in that range)."""
    d = cfg.d_model
    s = 1.0 / math.sqrt(d)
    u = torch.rand((*stack, d), generator=generator, dtype=torch.float32,
                   device=device) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))
    return {
        "w_gelu": _normal(generator, (*stack, d, d), s, device),
        "w_rnn": _normal(generator, (*stack, d, d), s, device),
        "conv": _normal(generator, (*stack, _CONV_K, d),
                        1.0 / math.sqrt(_CONV_K), device),
        "wa": _normal(generator, (*stack, d, d), s, device),
        "wx": _normal(generator, (*stack, d, d), s, device),
        "lam": lam,
        "w_out": _normal(generator, (*stack, d, d), s, device),
        "norm": norm_init(cfg, stack=stack, device=device),
    }


def rglru_zero_state(cfg: LMConfig, b: int, *, stack: Tuple[int, ...] = (),
                     device=None) -> Dict:
    """The decode state of ``b`` sequences: ``h [*stack, B, D]`` and
    ``conv [*stack, B, 3, D]``, f32 zeros."""
    d = cfg.d_model
    return {
        "h": torch.zeros((*stack, b, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((*stack, b, _CONV_K - 1, d), dtype=torch.float32,
                            device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d: ``x [B, S, D]``, ``w [K, D]``; ``carry [B,
    K-1, D]`` holds the inputs before ``x`` (zeros if None)."""
    k = w.shape[0]
    if carry is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` over dim 1, by a
    Hillis-Steele scan: round ``r`` combines each pair with the one
    ``2^r`` steps before it, ``(a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2)``,
    the reference's ``combine``."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev = F.pad(a[:, :s - step], (0, 0, step, 0), value=1.0)
        b_prev = F.pad(b[:, :s - step], (0, 0, step, 0))
        b = a * b_prev + b
        a = a * a_prev
        step *= 2
    return b


def rglru_apply(params: Dict, x: torch.Tensor, cfg: LMConfig, *,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """``x [B, S, D]`` -> ``(x + block(x), state)``. Without ``state``
    (prefill, training) the whole sequence runs and the returned state is
    the one decode continues from; with it, S must be 1 (decode)."""
    s = x.shape[1]
    cd = x.dtype
    xin = norm_apply(params.get("norm", {}), x, cfg)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(xin @ params["w_gelu"].to(cd), approximate="tanh")
    u_raw = xin @ params["w_rnn"].to(cd)         # pre-conv: the carry
    conv_carry = None if state is None else state["conv"]
    u = _causal_conv(u_raw, params["conv"].to(cd), conv_carry)
    uf = u.float()
    r = torch.sigmoid((xin @ params["wa"].to(cd)).float())
    i = torch.sigmoid((xin @ params["wx"].to(cd)).float())
    log_a = -_C * F.softplus(params["lam"]) * r           # [B, S, D]
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)

    if state is None:
        h = linear_scan(a, bx)
        new_h = h[:, -1]
        ur = u_raw.float()
        conv = ur[:, -(_CONV_K - 1):] if s >= _CONV_K - 1 else \
            F.pad(ur, (0, 0, _CONV_K - 1 - s, 0))
    else:
        new_h = a[:, 0] * state["h"] + bx[:, 0]
        h = new_h[:, None]
        buf = torch.cat([state["conv"].to(cd), u_raw], dim=1)
        conv = buf[:, -(_CONV_K - 1):].float()
    out = (h.to(cd) * gate) @ params["w_out"].to(cd)
    return x + out, {"h": new_h, "conv": conv}
