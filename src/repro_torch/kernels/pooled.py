"""The launch of the grouped pooled read that K1 and K6 share
(``csrc/pooled_read.cuh``).

One launch reads up to :data:`MAX_TABLES` tables that share the row width
``D`` and the payload type, each with its own payload, slots ``[B, H_t]``
(``H_t`` may differ) and, for K6, scales, and writes ``out[b, t, :]`` in
place. The descriptors go to the C entry point as arrays of pointers in
host memory and reach the kernel in its parameters, so a launch copies
nothing to the card and waits for nothing: it can be captured in a CUDA
graph. More tables take several launches, each writing its slice of
``out`` (:func:`table_launches`). One table takes :func:`launch_one`: its
C entry gets the table's pointers as scalars, so the host builds no
pointer arrays, and its checks run inline, building a message only when
one fails. :func:`launch_owned` is the owner-mapped form: one cache-mesh
entry's read of its block of a striped L1 at GLOBAL slots (the mesh half
of K5 / K6).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

#: tables one launch takes (``pooled::kMaxTables``: the descriptors stay
#: about 2 KB of the 4 KB of kernel parameters)
MAX_TABLES = 64


def table_launches(n: int, limit: int = MAX_TABLES) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` table ranges of the launches that read ``n``
    tables, ``limit`` at most each."""
    return [(t, min(n, t + limit)) for t in range(0, n, limit)]


def _check(payloads, scales, slots, dtypes) -> Tuple[int, int]:
    """The wrapper's checks on CUDA operands, message built only on a
    failure; returns ``(B, D)``."""
    n = len(payloads)
    if not n or len(slots) != n or (scales is not None and len(scales) != n):
        raise ValueError(f"{n} payloads, {len(slots)} slot blocks and "
                         f"{'no' if scales is None else len(scales)} scales")
    first = payloads[0]
    if not (first.is_cuda and first.dtype in dtypes and first.dim() == 2):
        _build.require_cuda("payload 0", first, dtypes, 2)
    b, d = slots[0].shape[0], first.shape[1]
    dtype, dev, di = first.dtype, first.device, first.get_device()
    for t, (p, s) in enumerate(zip(payloads, slots)):
        sc = None if scales is None else scales[t]
        ps, ss = p.shape, s.shape
        if (p.dtype is dtype and len(ps) == 2 and ps[1] == d
                and p.is_contiguous() and p.get_device() == di
                and s.dtype is torch.int32 and len(ss) == 2 and ss[0] == b
                and s.is_contiguous() and s.get_device() == di
                and (sc is None or (sc.dtype is torch.float32
                                    and sc.ndim == 1 and sc.shape[0] == ps[0]
                                    and sc.is_contiguous()
                                    and sc.get_device() == di))):
            continue
        _build.require_cuda(f"payload {t}", p, (dtype,), 2)
        _build.require_cuda(f"slots {t}", s, (torch.int32,), 2)
        _build.require(p.device == s.device == dev,
                       f"table {t}: payload on {p.device}, slots on "
                       f"{s.device}, table 0 on {dev}")
        _build.require(p.shape[1] == d, f"table {t}: D {p.shape[1]} != {d}")
        _build.require(s.shape[0] == b, f"table {t}: B {s.shape[0]} != {b}")
        _build.require_cuda(f"scales {t}", sc, (torch.float32,), 1)
        _build.require(sc.device == dev and sc.shape[0] == p.shape[0],
                       f"table {t}: {sc.shape[0]} scales on {sc.device} for "
                       f"{p.shape[0]} rows on {dev}")
    return b, d


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def launch(kernel: str, entry: str, payloads: Sequence[torch.Tensor],
           scales: Optional[Sequence[torch.Tensor]],
           slots: Sequence[torch.Tensor], dtypes) -> torch.Tensor:
    """Read ``payloads`` (CUDA) at ``slots`` through the C entry ``entry``
    (K6's when ``scales`` is given) -> ``[B, T, D]`` f32, in one launch per
    :data:`MAX_TABLES` tables, each counted as one of ``kernel``."""
    b, d = _check(payloads, scales, slots, dtypes)
    n = len(payloads)
    out = torch.empty((b, n, d), dtype=torch.float32,
                      device=payloads[0].device)
    if out.numel() == 0:
        return out
    code = _build.DTYPE_CODES[payloads[0].dtype]
    for t0, t1 in table_launches(n):
        pp, ss = _ptrs(payloads[t0:t1]), _ptrs(slots[t0:t1])
        hh = (ctypes.c_int * (t1 - t0))(*[s.shape[1] for s in slots[t0:t1]])
        cc = None if scales is None else _ptrs(scales[t0:t1])
        head = [ctypes.addressof(pp)] + (
            [] if cc is None else [ctypes.addressof(cc)])
        _build.launch(kernel, entry, out.device, *head, ctypes.addressof(ss),
                      ctypes.addressof(hh), t1 - t0, code, b, d,
                      out.data_ptr() + t0 * d * out.element_size(), n * d)
    return out


def launch_one(kernel: str, entry: str, payload: torch.Tensor,
               scales: Optional[torch.Tensor], slots: torch.Tensor,
               dtypes) -> torch.Tensor:
    """Read one table ``payload [C, D]`` (CUDA) at ``slots [B, H]`` int32
    through the one-table C entry ``entry`` (K6's when ``scales [C]`` f32
    is given) -> ``[B, D]`` f32, one launch counted as one of ``kernel``.
    The checks are :func:`_check`'s, inline; where one fails, ``_check``
    raises with its message."""
    ps, ss, di = payload.shape, slots.shape, payload.get_device()
    if not (payload.is_cuda and payload.dtype in dtypes and len(ps) == 2
            and payload.is_contiguous() and slots.dtype is torch.int32
            and len(ss) == 2 and slots.is_contiguous()
            and slots.get_device() == di
            and (scales is None or (scales.dtype is torch.float32
                                    and scales.ndim == 1
                                    and scales.shape[0] == ps[0]
                                    and scales.is_contiguous()
                                    and scales.get_device() == di))):
        _check((payload,), None if scales is None else (scales,), (slots,),
               dtypes)
    b, d = ss[0], ps[1]
    out = torch.empty((b, d), dtype=torch.float32, device=payload.device)
    if out.numel() == 0:
        return out
    head = (payload.data_ptr(),) if scales is None else (
        payload.data_ptr(), scales.data_ptr())
    _build.launch(kernel, entry, out.device, *head, slots.data_ptr(), ss[1],
                  _build.DTYPE_CODES[payload.dtype], b, d, out.data_ptr())
    return out


def _check_f32(name: str, t: torch.Tensor, shape: tuple, di: int) -> None:
    if not (t.is_cuda and t.dtype is torch.float32 and t.is_contiguous()
            and t.get_device() == di and t.shape == shape):
        raise ValueError(f"{name}: want {list(shape)} f32, contiguous, on "
                         f"cuda:{di}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def launch_owned(kernel: str, entries: Tuple[str, str],
                 blocks: Sequence[torch.Tensor],
                 scales: Optional[Sequence[torch.Tensor]],
                 slots: Sequence[torch.Tensor], dtypes, stripes: int,
                 first: int, rows: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> None:
    """One cache-mesh entry's owner-mapped read: ``blocks [k, Cl_t, D]``
    (CUDA, one type; the entry's stripes ``first .. first + k - 1`` of
    ``stripes``), ``scales [k, Cl_t]`` f32 or None, GLOBAL ``slots [B,
    H_t]`` int32, ``rows [B, W, D]`` f32 (W the H_t summed, table ``t`` from
    column ``H_0 + .. + H_{t-1}``). Without ``out`` the entry writes the
    rows of its stripes into ``rows``; with ``out [B, T, D]`` f32 it writes
    each output row, its slots' rows summed in order of h, its own from its
    block and the others' from ``rows`` (which may be ``out`` where every
    H_t is 1). ``entries`` names the one-table and the grouped C entry: one
    launch for one table, one per :data:`MAX_TABLES` tables otherwise, each
    counted as one of ``kernel``."""
    n = len(blocks)
    if not n or len(slots) != n or (scales is not None and len(scales) != n):
        raise ValueError(f"{n} blocks, {len(slots)} slot blocks and "
                         f"{'no' if scales is None else len(scales)} scales")
    first_blk = blocks[0]
    if not (first_blk.is_cuda and first_blk.dtype in dtypes
            and first_blk.dim() == 3):
        _build.require_cuda("block 0", first_blk, dtypes, 3)
    owned, _, d = first_blk.shape
    b, dtype, di = slots[0].shape[0], first_blk.dtype, first_blk.get_device()
    if not 0 <= first <= stripes - owned:
        raise ValueError(f"stripes {first} .. {first + owned - 1} of "
                         f"{stripes}")
    hots = []
    for t, (p, s) in enumerate(zip(blocks, slots)):
        sc = None if scales is None else scales[t]
        ps, ss = p.shape, s.shape
        if not (p.dtype is dtype and len(ps) == 3 and ps[0] == owned
                and ps[2] == d and p.is_contiguous()
                and p.get_device() == di and s.dtype is torch.int32
                and len(ss) == 2 and ss[0] == b and s.is_contiguous()
                and s.get_device() == di
                and (sc is None or (sc.dtype is torch.float32
                                    and sc.shape == ps[:2]
                                    and sc.is_contiguous()
                                    and sc.get_device() == di))):
            raise ValueError(
                f"table {t}: block {tuple(ps)} {p.dtype} on {p.device}, "
                f"slots {tuple(ss)} {s.dtype} on {s.device}, scales "
                f"{None if sc is None else (tuple(sc.shape), sc.dtype)}: "
                f"want [{owned}, Cl, {d}] {dtype}, [{b}, H] int32 and "
                f"[{owned}, Cl] f32, contiguous, on {first_blk.device}")
        hots.append(ss[1])
    _check_f32("rows", rows, (b, sum(hots), d), di)
    if out is not None:
        _check_f32("out", out, (b, n, d), di)
    pool = int(out is not None)
    if (out if pool else rows).numel() == 0:
        return
    code = _build.DTYPE_CODES[dtype]
    tail = (rows.data_ptr(), rows.stride(0), stripes, first, owned, pool)
    out_ptr = out.data_ptr() if pool else None
    if n == 1:
        p, s = blocks[0], slots[0]
        head = (p.data_ptr(),) if scales is None else (
            p.data_ptr(), scales[0].data_ptr())
        _build.launch(kernel, entries[0], first_blk.device, *head,
                      s.data_ptr(), hots[0], p.shape[1], code, b, d, out_ptr,
                      *tail)
        return
    cols = [0]
    for h in hots[:-1]:
        cols.append(cols[-1] + h)
    for t0, t1 in table_launches(n):
        m = t1 - t0
        pp, ss = _ptrs(blocks[t0:t1]), _ptrs(slots[t0:t1])
        hh = (ctypes.c_int * m)(*hots[t0:t1])
        rr = (ctypes.c_int * m)(*[p.shape[1] for p in blocks[t0:t1]])
        kk = (ctypes.c_int * m)(*cols[t0:t1])
        cc = None if scales is None else _ptrs(scales[t0:t1])
        head = [ctypes.addressof(pp)] + (
            [] if cc is None else [ctypes.addressof(cc)])
        _build.launch(kernel, entries[1], first_blk.device, *head,
                      ctypes.addressof(ss), ctypes.addressof(hh),
                      ctypes.addressof(rr), ctypes.addressof(kk), m, code, b,
                      d, None if out_ptr is None
                      else out_ptr + t0 * d * out.element_size(),
                      n * d, *tail)
