"""xLSTM blocks (arXiv:2405.04517) of ``xlstm-125m``, counterpart of
``repro/models/lm/xlstm.py``: the mLSTM (matrix memory) and the sLSTM
(scalar memory, block-diagonal recurrence), both with exponential gates
and a max stabiliser carried in the state.

State a layer (f32, as in the reference):
  mLSTM: ``C [B, H, Dh, Dh]``, ``n [B, H, Dh]``, ``m [B, H]``
  sLSTM: ``c``, ``n``, ``h [B, H, Dh]``, ``m [B, H]``

The reference runs each recurrence with ``lax.scan``; here it is a Python
loop over the time steps on tensors, the projections computed for the
whole sequence before it. The reference has no Pallas kernel here, so
plain torch is its port. Each step builds the mLSTM's ``i v k^T`` as the
outer product of ``i * v`` and ``k``, so autograd keeps one ``[B, H, Dh,
Dh]`` tensor a step (the memory ``C`` the next step reads), not the
outer product as well. Decode runs the same loop over one step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.lm.transformer import _normal, norm_apply, norm_init


def _heads(cfg: LMConfig) -> Tuple[int, int]:
    h = cfg.num_heads
    return h, cfg.d_model // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, cfg: LMConfig, *,
               stack: Tuple[int, ...] = (), device=None) -> Dict:
    """The reference's keys and scales: ``[D, D]`` q / k / v / output /
    output-gate products and ``[D, H]`` input and forget gates at
    ``1/sqrt(D)``, the forget bias at 3 (an open gate), the pre-norm and
    the post-recurrence scale ``gn`` at one."""
    d = cfg.d_model
    h, _ = _heads(cfg)
    s = 1.0 / math.sqrt(d)

    def full(n, value):
        return torch.full((*stack, n), value, dtype=torch.float32,
                          device=device)

    return {
        "wq": _normal(generator, (*stack, d, d), s, device),
        "wk": _normal(generator, (*stack, d, d), s, device),
        "wv": _normal(generator, (*stack, d, d), s, device),
        "wi": _normal(generator, (*stack, d, h), s, device),
        "wf": _normal(generator, (*stack, d, h), s, device),
        "bf": full(h, 3.0),
        "bi": full(h, 0.0),
        "wo": _normal(generator, (*stack, d, d), s, device),
        "wog": _normal(generator, (*stack, d, d), s, device),
        "norm": norm_init(cfg, stack=stack, device=device),
        "gn": full(d, 1.0),
    }


def mlstm_zero_state(cfg: LMConfig, b: int, *, stack: Tuple[int, ...] = (),
                     device=None) -> Dict:
    h, dh = _heads(cfg)
    z = lambda *shape: torch.zeros((*stack, b, *shape),  # noqa: E731
                                   dtype=torch.float32, device=device)
    return {"C": z(h, dh, dh), "n": z(h, dh), "m": z(h)}


def _mlstm_step(state: Dict, q, k, v, i_p, f_p) -> Tuple[Dict, torch.Tensor]:
    """One step: ``q / k / v [B, H, Dh]``, gate pre-activations ``[B, H]``,
    all f32 -> (new state, ``h [B, H, Dh]``)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(f_p + m, i_p)
    f_ = torch.exp(f_p + m - m_new)
    i_ = torch.exp(i_p - m_new)
    C = f_[..., None, None] * C \
        + (i_[..., None] * v)[..., :, None] * k[..., None, :]
    n = f_[..., None] * n + i_[..., None] * k
    num = torch.matmul(C, q[..., None])[..., 0]
    den = torch.clamp_min(torch.abs((n * q).sum(-1)), 1.0)
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def mlstm_apply(params: Dict, x: torch.Tensor, cfg: LMConfig, *,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """``x [B, S, D]`` -> ``(x + block(x), state)``; ``state`` (None: zeros)
    is the one the sequence continues from, and the returned one is where
    it ends (decode continues from it)."""
    b, s, d = x.shape
    h, dh = _heads(cfg)
    cd = x.dtype
    xin = norm_apply(params.get("norm", {}), x, cfg)
    # the reference divides by a numpy scalar, which promotes q to f32
    q = (xin @ params["wq"].to(cd)).reshape(b, s, h, dh).float() \
        / math.sqrt(dh)
    k = (xin @ params["wk"].to(cd)).reshape(b, s, h, dh)
    v = (xin @ params["wv"].to(cd)).reshape(b, s, h, dh)
    i_p = (xin @ params["wi"].to(cd) + params["bi"]).float()
    f_p = F.logsigmoid((xin @ params["wf"].to(cd) + params["bf"]).float())
    if state is None:
        state = mlstm_zero_state(cfg, b, device=x.device)
    qs, ks, vs = (t.float().unbind(1) for t in (q, k, v))
    is_, fs = i_p.unbind(1), f_p.unbind(1)
    hs = []
    for t in range(s):
        state, h_out = _mlstm_step(state, qs[t], ks[t], vs[t], is_[t], fs[t])
        hs.append(h_out)
    hs = torch.stack(hs, 1).reshape(b, s, d) * params["gn"]
    og = torch.sigmoid(xin @ params["wog"].to(cd))
    out = (hs.to(cd) * og) @ params["wo"].to(cd)
    return x + out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


def slstm_init(generator: torch.Generator, cfg: LMConfig, *,
               stack: Tuple[int, ...] = (), device=None) -> Dict:
    """The reference's keys and scales: ``[D, D]`` gate and ``down``
    products at ``1/sqrt(D)``, block-diagonal recurrent ``[H, Dh, Dh]``
    weights at ``1/sqrt(Dh)``, the forget bias at 3, the pre-norm."""
    d = cfg.d_model
    h, dh = _heads(cfg)
    s, sr = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dh)
    p = {f"w{g}": _normal(generator, (*stack, d, d), s, device)
         for g in _GATES}
    p.update({f"r{g}": _normal(generator, (*stack, h, dh, dh), sr, device)
              for g in _GATES})
    p["bf"] = torch.full((*stack, d), 3.0, dtype=torch.float32,
                         device=device)
    p["bi"] = torch.zeros((*stack, d), dtype=torch.float32, device=device)
    p["down"] = _normal(generator, (*stack, d, d), s, device)
    p["norm"] = norm_init(cfg, stack=stack, device=device)
    return p


def slstm_zero_state(cfg: LMConfig, b: int, *, stack: Tuple[int, ...] = (),
                     device=None) -> Dict:
    h, dh = _heads(cfg)
    z = lambda *shape: torch.zeros((*stack, b, *shape),  # noqa: E731
                                   dtype=torch.float32, device=device)
    return {"c": z(h, dh), "n": z(h, dh), "h": z(h, dh), "m": z(h)}


def slstm_apply(params: Dict, x: torch.Tensor, cfg: LMConfig, *,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """``x [B, S, D]`` -> ``(x + block(x), state)``, as
    :func:`mlstm_apply`. The four recurrent products of a step run as one
    ``[B, H, Dh] x [H, Dh, 4 Dh]`` product."""
    b, s, d = x.shape
    h, dh = _heads(cfg)
    cd = x.dtype
    xin = norm_apply(params.get("norm", {}), x, cfg)
    zx = xin @ params["wz"].to(cd)
    ix = xin @ params["wi"].to(cd) + params["bi"]
    fx = xin @ params["wf"].to(cd) + params["bf"]
    ox = xin @ params["wo"].to(cd)
    # [B, S, 4, H, Dh] -> per step [B, H, 4 Dh] in the order of _GATES
    pre = torch.stack([t.float() for t in (zx, ix, fx, ox)], 2) \
        .reshape(b, s, 4, h, dh).transpose(2, 3).reshape(b, s, h, 4 * dh)
    r = torch.cat([params[f"r{g}"].float() for g in _GATES], -1)
    if state is None:
        state = slstm_zero_state(cfg, b, device=x.device)
    hs = []
    for pre_t in pre.unbind(1):
        rec = torch.matmul(state["h"].transpose(0, 1), r).transpose(0, 1)
        zt, it, ft, ot = (pre_t + rec).split(dh, -1)
        z = torch.tanh(zt)
        f_p = F.logsigmoid(ft)
        o = torch.sigmoid(ot)
        # per-head max stabiliser over the gate pre-activations
        m_new = torch.maximum(f_p.amax(-1) + state["m"], it.amax(-1))
        f_ = torch.exp(f_p + (state["m"] - m_new)[..., None])
        i_ = torch.exp(it - m_new[..., None])
        c = f_ * state["c"] + i_ * z
        n = f_ * state["n"] + i_
        h_out = o * c / torch.clamp_min(n, 1.0)
        state = {"c": c, "n": n, "h": h_out, "m": m_new}
        hs.append(h_out)
    hs = torch.stack(hs, 1).reshape(b, s, d)
    out = hs.to(cd) @ params["down"].to(cd)
    return x + out, state
