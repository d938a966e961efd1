"""Plain PyTorch versions of the kernels.

Twins of ``repro/kernels/ref.py`` (the JAX package's test oracles). Each
is the CPU implementation behind its kernel's wrapper and the reference
``chip_smoke.py`` holds the CUDA kernel against on the card. Sums run in
f32, or in f64 for f64 inputs (the gradient checks). ``grad_row_error``
is the rule that holds K8's bf16 gradients to their plain version.
"""
from __future__ import annotations

import math

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def embedding_lookup_ref(table: torch.Tensor, rows: torch.Tensor,
                         combiner: str = "sum") -> torch.Tensor:
    """``table [V, D]``, ``rows [B, H]`` int (-1 = pad) -> ``[B, D]`` f32.

    Sum (or mean) of the selected rows; duplicate ids count multiply.
    """
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    vecs = table[safe]
    vecs = torch.where(valid[..., None], vecs,
                       torch.zeros((), dtype=vecs.dtype,
                                   device=vecs.device)).to(
        acc_dtype(table.dtype))
    pooled = vecs.sum(dim=1)
    if combiner == "mean":
        denom = valid.sum(dim=1, keepdim=True).clamp_min(1)
        pooled = pooled / denom.to(pooled.dtype)
    return pooled


def embedding_grad_ref(table_shape, rows: torch.Tensor,
                       dpooled: torch.Tensor) -> torch.Tensor:
    """Adjoint of the sum-pooled lookup: ``rows [B, H]`` (-1 = pad),
    ``dpooled [B, D]`` -> ``dtable [V, D]`` f32, the scatter-add of
    ``dpooled[b]`` into every valid ``rows[b, h]`` (duplicates count
    multiply; ids outside ``[0, V)`` are dropped)."""
    v, d = table_shape
    valid = (rows >= 0) & (rows < v)
    flat = torch.where(valid, rows, torch.full_like(rows, v)).reshape(-1)
    dt = acc_dtype(dpooled.dtype)
    contrib = dpooled.to(dt)[:, None, :].expand(*rows.shape, d)
    contrib = torch.where(valid[..., None], contrib,
                          torch.zeros((), dtype=dt, device=contrib.device))
    out = torch.zeros((v + 1, d), dtype=dt, device=dpooled.device)
    out.index_add_(0, flat.long(), contrib.reshape(-1, d))
    return out[:v]


def cache_gather_ref(payload: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]``, ``slots [N]`` int (-1 = hole) -> ``[N, D]`` f32."""
    valid = slots >= 0
    safe = torch.where(valid, slots, torch.zeros_like(slots)).long()
    rows = payload[safe].float()
    return torch.where(valid[:, None], rows, torch.zeros((), device=rows.device))


def dequant_gather_ref(payload: torch.Tensor, scales: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]`` (int8/f16/f32), ``scales [C]`` f32 per-row
    scale, ``slots [N]`` (-1 = hole) -> ``[N, D]`` f32
    ``payload[s].float() * scales[s]``."""
    valid = slots >= 0
    safe = torch.where(valid, slots, torch.zeros_like(slots)).long()
    rows = payload[safe].float() * scales[safe].float()[:, None]
    return torch.where(valid[:, None], rows, torch.zeros((), device=rows.device))


def _tril(f: int, self_interaction: bool, device):
    return torch.tril_indices(f, f, 0 if self_interaction else -1,
                              device=device)


def dot_interaction_ref(x: torch.Tensor, *,
                        self_interaction: bool = False) -> torch.Tensor:
    """DLRM pairwise dots: ``x [B, F, D]`` -> the strict lower triangle of
    each ``x x^T`` in ``np.tril_indices`` order, ``[B, F(F-1)/2]`` (with
    the diagonal, ``F(F+1)/2``, when ``self_interaction``)."""
    xf = x.to(acc_dtype(x.dtype))
    gram = torch.matmul(xf, xf.transpose(1, 2))
    i, j = _tril(x.shape[1], self_interaction, x.device)
    return gram[:, i, j]


def dot_interaction_bwd_ref(x: torch.Tensor, dtri: torch.Tensor, *,
                            self_interaction: bool = False) -> torch.Tensor:
    """Adjoint of :func:`dot_interaction_ref`: ``dx = (G + G^T) x`` with
    ``G [B, F, F]`` holding ``dtri`` on its (strict) lower triangle; the
    symmetrization doubles the diagonal. Returns ``dx`` in ``x``'s type."""
    b, f, _ = x.shape
    dt = acc_dtype(x.dtype)
    i, j = _tril(f, self_interaction, x.device)
    g = torch.zeros((b, f, f), dtype=dt, device=x.device)
    g[:, i, j] = dtri.to(dt)
    return torch.matmul(g + g.transpose(1, 2), x.to(dt)).to(x.dtype)


#: the score the flash kernels give a masked (query, key) pair
MASKED = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None):
    """Softmax attention in the flash kernels' flat layout: ``q [BH, S,
    D]``, ``k/v [BKV, S, D]`` -> (``o [BH, S, D]`` in ``q``'s type, ``lse
    [BH, S]`` f32). Query head ``n`` reads KV head ``n // g``, ``g = BH /
    BKV``. Key ``j`` is visible from query ``i`` when ``j <= i`` (causal)
    and ``j > i - window`` (a window); a masked score is -1e30 and its
    ``p`` 0. All in f32 (f64 for f64 inputs); ``lse = m + log(max(l,
    1e-30))``, as the forward kernel writes it."""
    bh, s, d = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    dt = acc_dtype(q.dtype)
    qf = q.to(dt).reshape(bkv, g, s, d)
    sc = torch.matmul(qf, k.to(dt)[:, None].transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    sc = torch.where(mask, sc, torch.full((), MASKED, dtype=dt,
                                           device=q.device))
    m = sc.amax(dim=-1)
    p = torch.where(mask, torch.exp(sc - m[..., None]),
                    torch.zeros((), dtype=dt, device=q.device))
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.matmul(p, v.to(dt)[:, None]) / l[..., None]
    lse = m + torch.log(l)
    return o.reshape(bh, s, d).to(q.dtype), lse.reshape(bh, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window=None):
    """The gradient of :func:`flash_attention_ref`, written out (not
    autograd of it): ``q, o, do [BH, S, D]``, ``k/v [BKV, S, D]``, ``lse
    [BH, S]`` -> (``dq`` in ``q``'s type, ``dk``, ``dv`` in ``k``'s).
    ``D = rowsum(do o)``, ``p = exp(s scale - lse)`` (0 where masked, the
    forward's mask), ``dv = p^T do``, ``ds = p (do v^T - D) scale``, ``dq =
    ds k``, ``dk = ds^T q``; ``dk``/``dv`` summed over each group of ``g =
    BH / BKV`` query heads. All in f32 (f64 for f64 inputs)."""
    bh, s, d = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    dt = acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    qf, of, dof = (t.to(dt).reshape(bkv, g, s, d) for t in (q, o, do))
    kf, vf = k.to(dt)[:, None], v.to(dt)[:, None]
    dcap = (dof * of).sum(dim=-1, keepdim=True)
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(sc - lse.to(dt).reshape(bkv, g, s, 1)),
                    torch.zeros((), dtype=dt, device=q.device))
    del sc
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - dcap) * scale
    del p
    dq = torch.matmul(ds, kf).reshape(bh, s, d)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: K8's bf16 gradients against :func:`flash_attention_bwd_ref`: the largest
#: absolute error against ``peak`` of the largest |value| (two bf16 ulps),
#: the whole tensor's relative L2 error, and each row's error against
#: ``rel`` of that row's norm plus ``floor`` of the largest row norm (the
#: floor is for rows that are 0 in exact arithmetic, such as ``dq`` of
#: query 0)
BF16_GRAD_RULE = dict(peak=1e-2, whole=1e-2, rel=2e-2, floor=1e-4)


def grad_row_error(got: torch.Tensor, want: torch.Tensor, *,
                   rel: float = BF16_GRAD_RULE["rel"],
                   floor: float = BF16_GRAD_RULE["floor"]) -> tuple:
    """How far ``got`` lies from ``want``: ``(peak, whole, worst)``, the
    largest ``|got - want|`` over the largest ``|want|``, the relative L2
    error ``|got - want| / |want|`` of the whole tensor, and, row by row
    (a row is one vector along the last dim, one head at one position),
    the largest ``|got_r - want_r| / (rel |want_r| + floor max_r
    |want_r|)``, at most 1 where every row is within its limit. Causal
    gradients shrink along the sequence, so a limit taken from the
    largest value alone would pass a fault in the later rows."""
    x = got.detach().double().reshape(-1, got.shape[-1])
    w = want.detach().double().reshape(-1, want.shape[-1])
    peak = ((x - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
    err, norm = (x - w).norm(dim=1), w.norm(dim=1)
    whole = (err.norm() / norm.norm().clamp_min(1e-300)).item()
    limit = rel * norm + floor * norm.max()
    worst = (err / limit.clamp_min(1e-300)).max().item()
    return peak, whole, worst
