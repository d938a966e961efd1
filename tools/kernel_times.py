#!/usr/bin/env python3
"""Device times of the port's hand-written kernels at the shapes
``chip_smoke.py``'s main paths give them, for the port found under
``--src``, so that two checkouts can be timed in turns on one card:

  python3 tools/kernel_times.py [--src PATH] [--label NAME] [CASE ...]

``--src`` defaults to this checkout's ``src/``; with no CASE every case of
:data:`CASES` runs. Each case takes its inputs from ``chip_smoke.py``'s own
functions and its run settings (``chip_smoke.RUN``), so that its shapes and
ids follow the smoke's. Each time is the mean of calls replayed from a CUDA
graph (``chip_smoke.graph_ms``), beside the wrapper's time (CUDA events
around back-to-back calls, ``chip_smoke.time_ms``); the cases of
:data:`PARTS` also give each of their kernels' device time (``parts_ms``,
``torch.profiler``, with each kernel's launches a call under ``events``;
the :data:`PROFILED` cases have no graph time, their device time is that
sum). The ``library ...`` cases time a kernel's library yardstick on the
same inputs. Prints the card's name and power limit, then
one JSON line. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lm_k3(cs, dev, table: int, arch=None, library: bool = False):
    """K3 at token table ``table`` of ``arch`` (default ``RUN.lm_arch``;
    ``RUN.xlstm_arch`` at ``RUN.xlstm_seq`` tokens, as phase 16 trains it)
    on ``chip_smoke.lm_k3_inputs``; with ``library``, ``zeros`` +
    ``index_add_`` of the valid rows on the same inputs."""
    from repro_torch.configs.registry import get_lm_config
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.models.lm.backbone import LMModel
    cfg = get_lm_config(arch or cs.RUN.lm_arch)
    seq = cs.RUN.xlstm_seq if arch == cs.RUN.xlstm_arch else cs.RUN.lm_seq
    tokens = cs.lm_tokens(cs.RUN, cfg, dev, cs.RUN.lm_train_batch, seq)
    shape, rows, dp = cs.lm_k3_inputs(LMModel(cfg, device=dev),
                                      tokens)[table]
    if library:
        return _k3_library(shape, rows, dp), 5
    return lambda: k1.lookup_bwd(shape, rows, dp), 5


def _k3_library(shape, rows, dp):
    """K3's library yardstick, as ``chip_smoke.py`` times it: ``zeros`` +
    ``index_add_`` of the valid ids' ``dpooled`` rows."""
    import torch
    keep = rows.view(-1) >= 0
    flat, src = rows.view(-1)[keep].long(), dp[keep]
    return lambda: torch.zeros(shape, device=dp.device).index_add_(0, flat,
                                                                   src)


def _dlrm_k3(cs, dev):
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    groups = cs.training_rows(cs.RUN, dev)
    v, rows = groups[max(groups, key=lambda k: groups[k][0])]
    dp = torch.randn((rows.shape[0], 128),
                     generator=torch.Generator().manual_seed(1)).to(dev)
    return lambda: k1.lookup_bwd((v, 128), rows, dp), 4


def _striped_inputs(cs, dev, payload_dtype: str, sets: int):
    """2-way striped L1 payloads of the 26 served tables as their flat
    views, and ``sets`` batches of slots remapped onto them, as
    ``HPS._device_stage`` remaps them on the host."""
    from repro_torch.kernels import ops
    pays, slots = cs.served_inputs(cs.RUN, dev, payload_dtype, sets)
    half = cs.RUN.cache_capacity // 2
    stripes = [(p.view(2, half, -1), None if sc is None else sc.view(2, half))
               for p, sc in pays]
    flat = [ops.striped_view(st) for st in stripes]
    slots = [[ops.flatten_striped_slots(st[0], s)
              for st, s in zip(stripes, batch)] for batch in slots]
    return flat, slots


def _striped(cs, dev, payload_dtype: str, query: bool = False):
    """The served pooled read of all 26 tables (or, with ``query``, the
    cache query's row read of one) on the flat view of 2-way striped L1
    payloads."""
    from repro_torch.core.hps.hps import _pooled_stack
    from repro_torch.kernels import ops
    sets = 1 if query else cs.SLOT_SETS
    flat, slots = _striped_inputs(cs, dev, payload_dtype, sets)
    if query:
        (p, sc), sl = flat[0], slots[0][0].view(-1)
        return lambda: ops.cache_gather(p, sl, scales=sc), 20
    combiners = ("sum",) * len(flat)
    return cs.rotating(lambda sl: _pooled_stack(flat, sl, combiners),
                       slots), sets


def _striped_library(cs, dev, payload_dtype: str, query: bool = False):
    """The library yardstick of :func:`_striped` on the same inputs: each
    table's ``index_select`` (dequantized for int8) + ``sum`` and one
    ``torch.stack``, as ``chip_smoke.served_record`` times it; the query's
    one ``index_select``."""
    import torch
    sets = 1 if query else cs.SLOT_SETS
    flat, slots = _striped_inputs(cs, dev, payload_dtype, sets)
    if query:
        (p, _), sl = flat[0], slots[0][0].view(-1)
        return lambda: p.index_select(0, sl), 20
    b, d = cs.RUN.batch, flat[0][0].shape[1]

    def lib(sl):
        return torch.stack([
            (p.index_select(0, s.view(-1)).float() if sc is None else
             p.index_select(0, s.view(-1)).float()
             * sc.index_select(0, s.view(-1))[:, None]).view(b, -1, d).sum(1)
            for (p, sc), s in zip(flat, sl)], 1)
    return cs.rotating(lib, slots), sets


def _pooled_stack(cs, dev, payload_dtype: str, d: int = 128,
                  tables: int = 26):
    from repro_torch.core.hps.hps import _pooled_stack
    # at D 8-64 more batches than the 20 of D 128, so replays leave L2 too
    sets = 64 if 1 < d < 128 else cs.SLOT_SETS
    pays, slots = cs.served_inputs(cs.RUN, dev, payload_dtype, sets, d=d,
                                   tables=tables)
    combiners = ("sum",) * len(pays)
    return cs.rotating(lambda sl: _pooled_stack(pays, sl, combiners),
                       slots), sets


def _mesh_half(cs, dev, payload_dtype: str):
    """The mesh half's row read as ``chip_smoke.mesh_half`` runs it: slots
    ``[RUN.batch]`` (every 7th a hole) over ``RUN.mesh_stripes`` stripes of
    one served table's payload laid out on ``[dev, dev]``, through
    ``ops.sharded_cache_gather``."""
    from repro_torch.kernels import ops
    pays, sets = cs.served_inputs(cs.RUN, dev, payload_dtype)
    (p, sc), slots = pays[0], sets[0][0].view(-1).clone()
    slots[::7] = -1
    n = cs.RUN.mesh_stripes
    stripes = p.view(n, p.shape[0] // n, -1)
    scales = None if sc is None else sc.view(n, -1)
    mesh = [dev, dev]
    blocks, bsc = ops.place_stripes(stripes, scales, mesh)
    return (lambda: ops.sharded_cache_gather(blocks, slots, scales=bsc,
                                             mesh=mesh)), 20


def _mesh_stack(cs, dev, payload_dtype: str, stripes: int = 2):
    """The served pooled read of the 26 tables off an L1 of ``stripes``
    stripes laid out on the cache mesh ``[dev, dev]``
    (``core.hps.hps._pooled_stack(..., mesh=)``, a new batch of GLOBAL
    slots each call), as a DLRM HPS with ``cache_mesh`` serves it."""
    from repro_torch.core.hps.hps import _pooled_stack
    from repro_torch.kernels import ops
    pays, slots = cs.served_inputs(cs.RUN, dev, payload_dtype, cs.SLOT_SETS)
    mesh = [dev, dev]
    placed = [ops.place_stripes(
        p.view(stripes, p.shape[0] // stripes, -1),
        None if sc is None else sc.view(stripes, -1), mesh)
        for p, sc in pays]
    combiners = ("sum",) * len(placed)
    return cs.rotating(lambda sl: _pooled_stack(placed, sl, combiners,
                                                mesh=mesh), slots), \
        cs.SLOT_SETS


def _sdpa_bwd(cs, dev, b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
              causal: bool, q_pos0: int = 0, window=None):
    """``scaled_dot_product_attention``'s backward alone at a K8 shape:
    q/do ``[b, hq, sq, d]`` over k/v ``[b, hkv, sk, d]``, bf16; one forward
    kept, each call one ``autograd.grad`` through it. A query offset takes
    the explicit causal mask (``chip_smoke.causal_mask``, as phase 3 (f)
    builds it: ``is_causal`` aligns the diagonal top-left), a window the
    windowed mask (``chip_smoke.window_mask``, as phase 3 (b) builds it).
    Timed by the profiler only (:data:`PROFILED`)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g).to(
        dev, torch.bfloat16) for h, s in ((hq, sq), (hkv, sk), (hkv, sk),
                                          (hq, sq)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    mask = {"is_causal": causal}
    if q_pos0:
        mask = {"attn_mask": cs.causal_mask(sq, sk, q_pos0, dev)}
    elif window:
        mask = {"attn_mask": cs.window_mask(sq, window, dev)}
    o = F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **mask)
    return (lambda: torch.autograd.grad(o, (q, k, v), do,
                                        retain_graph=True)), 5


def _sdpa_bwd_at(cs, dev, case: str):
    """:func:`_sdpa_bwd` at the shape of K8's ``case``: (a) minitron-4b's
    and (c) granite-moe-3b-a800m's training shapes (batch 1, causal), (b)
    recurrentgemma-9b's (batch 1, window 2048), the four of
    ``chip_smoke.encdec_attn_shapes`` at the training batch (seamless's
    encoder, decoder and cross-attention, pixtral's), and minitron-4b's
    last sequence-parallel shard at ``RUN.lm_batch``."""
    run, s = cs.RUN, cs.RUN.attn_seq
    if case == "(b)":
        hq, hkv, d, w = cs.rg_attn_shape()
        return _sdpa_bwd(cs, dev, 1, hq, hkv, s, s, d, True, window=w)
    if case in ("(a)", "(c)"):
        hq, hkv, d = (cs.lm_attn_shape if case == "(a)"
                      else cs.granite_attn_shape)(run)
        return _sdpa_bwd(cs, dev, 1, hq, hkv, s, s, d, True)
    if case == "seq shard":
        hq, hkv, d = cs.lm_attn_shape(run)
        n, p = cs.shard_shape(run)
        return _sdpa_bwd(cs, dev, run.lm_batch, hq, hkv, n, s, d, True, p)
    which = ENCDEC.index(case.split()[-1])
    b = run.lm_train_batch
    _, bh, bkv, sq, sk, d, causal = cs.encdec_attn_shapes(run, b)[which]
    return _sdpa_bwd(cs, dev, b, bh // b, bkv // b, sq, sk, d, causal)


#: the shapes of ``chip_smoke.encdec_attn_shapes``, in its order
ENCDEC = ("encoder", "decoder", "cross", "pixtral")
#: the K8 cases that have ``sdpa``'s backward alone as their yardstick
LIBRARY_BWD = ("(a)", "(b)", "(c)", *(f"(d) {name}" for name in ENCDEC),
               "seq shard")


def _wdl(cs, dev, which: int, backward: bool, arch: str = "wdl",
         library: bool = False):
    """K1 or K3 at full-vocabulary wdl-criteo's ``dist`` group (0) or its
    wide twins (1), or (``arch="neumf"``) at neumf-criteo's largest
    ``deep`` (0) or ``ctx`` (1) group, or (``arch="etc"``) at phase 6d's
    flattened ETC cache, on the first training batch's ids; with
    ``library``, K3's yardstick on the same inputs."""
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    fn = {"wdl": cs.wdl_training_rows, "neumf": cs.neumf_training_rows,
          "etc": cs.etc_training_rows}[arch]
    v, rows, d = list(fn(cs.RUN, dev).values())[which]
    g = torch.Generator(device=dev).manual_seed(which)
    if backward:
        dp = torch.randn((rows.shape[0], d), generator=g, device=dev)
        if library:
            return _k3_library((v, d), rows, dp), 4
        return lambda: k1.lookup_bwd((v, d), rows, dp), 4
    mega = torch.randn((v, d), generator=g, device=dev)
    return lambda: k1.lookup_fwd(mega, rows), 10


def _lm_k1(cs, dev, table: int):
    from repro_torch.kernels import embedding_lookup as k1
    _, tab, rows = cs.lm_k1_inputs(cs.RUN, dev)[table]
    return lambda: k1.lookup_fwd(tab, rows), 10


def _dlrm_k1(cs, dev):
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    groups = cs.training_rows(cs.RUN, dev)
    v, rows = groups[max(groups, key=lambda k: groups[k][0])]
    mega = torch.randn((v, 128), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    return lambda: k1.lookup_fwd(mega, rows), 10


def _k2(cs, dev, b: int):
    import torch
    from repro_torch.kernels import dot_interaction as k2
    x, _ = cs.interaction_bwd_inputs(torch.Generator().manual_seed(2), dev, b)
    return lambda: k2.interaction_fwd(x), 20


def _k5(cs, dev, payload_dtype: str, d: int = 128):
    from repro_torch.kernels import hps_gather as k56
    pays, sets = cs.served_inputs(cs.RUN, dev, payload_dtype, d=d)
    (p, sc), slots = pays[0], sets[0][0].view(-1)
    if sc is None:
        return lambda: k56.gather_rows(p, slots), 20
    return lambda: k56.dequant_gather_rows(p, sc, slots), 20


def _k7(cs, dev, b: int):
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d = cs.lm_attn_shape(cs.RUN)
    q, k, v = cs.randn_heads(torch.Generator().manual_seed(7), dev,
                             (b * hq, b * hkv, b * hkv), cs.RUN.attn_seq, d,
                             torch.bfloat16)
    return lambda: k78.flash_fwd(q, k, v, causal=True), 5


def _k4(cs, dev):
    import torch
    from repro_torch.kernels import dot_interaction as k2
    x, dtri = cs.interaction_bwd_inputs(torch.Generator().manual_seed(4), dev,
                                        cs.RUN.train_batch)
    return lambda: k2.interaction_bwd(x, dtri), 20


def _k8(cs, dev):
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d = cs.lm_attn_shape(cs.RUN)
    ins = cs.flash_bwd_inputs(torch.Generator().manual_seed(8), dev, hq, hkv,
                              cs.RUN.attn_seq, d, torch.bfloat16)
    return lambda: k78.flash_bwd(*ins, causal=True), 5


def _k7_rg(cs, dev):
    """K7 at recurrentgemma-9b's prefill: ``RUN.lm_batch`` x (Hq 16, Hkv 1,
    D 256), S ``RUN.attn_seq``, window 2048, as ``chip_smoke.py`` times it
    under ``shapes``."""
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d, w = cs.rg_attn_shape()
    b = cs.RUN.lm_batch
    q, k, v = cs.randn_heads(torch.Generator().manual_seed(7), dev,
                             (b * hq, b * hkv, b * hkv), cs.RUN.attn_seq, d,
                             torch.bfloat16)
    return lambda: k78.flash_fwd(q, k, v, causal=True, window=w), 5


def _k7_granite(cs, dev):
    """K7 at granite-moe-3b-a800m's prefill: ``RUN.lm_batch`` x (Hq 24,
    Hkv 8, D 64), S ``RUN.attn_seq``, causal, as ``chip_smoke.py`` times it
    under ``shapes`` (its case (d))."""
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d = cs.granite_attn_shape(cs.RUN)
    b = cs.RUN.lm_batch
    q, k, v = cs.randn_heads(torch.Generator().manual_seed(7), dev,
                             (b * hq, b * hkv, b * hkv), cs.RUN.attn_seq, d,
                             torch.bfloat16)
    return lambda: k78.flash_fwd(q, k, v, causal=True), 5


def _k8_granite(cs, dev):
    """K8 at granite-moe-3b-a800m's training shape (batch 1), causal."""
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d = cs.granite_attn_shape(cs.RUN)
    ins = cs.flash_bwd_inputs(torch.Generator().manual_seed(8), dev, hq, hkv,
                              cs.RUN.attn_seq, d, torch.bfloat16)
    return lambda: k78.flash_bwd(*ins, causal=True), 5


def _k8_rg(cs, dev, waves=None):
    """K8 at recurrentgemma-9b's training shape (batch 1), window 2048;
    with ``waves``, the dk/dv grid split for that many blocks an SM in
    place of ``flash_attention.DKV_WAVES`` (a checkout without the split
    ignores it)."""
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d, w = cs.rg_attn_shape()
    ins = cs.flash_bwd_inputs(torch.Generator().manual_seed(8), dev, hq, hkv,
                              cs.RUN.attn_seq, d, torch.bfloat16, w)

    def call():
        if waves is None:
            return k78.flash_bwd(*ins, causal=True, window=w)
        kept, k78.DKV_WAVES = getattr(k78, "DKV_WAVES", None), waves
        try:
            return k78.flash_bwd(*ins, causal=True, window=w)
        finally:
            k78.DKV_WAVES = kept
    return call, 5


def _encdec(cs, dev, which: int, backward: bool):
    """K7 (prefill batch) or K8 (training batch) at shape ``which`` of
    ``chip_smoke.encdec_attn_shapes``: seamless-m4t-large-v2's encoder (0),
    decoder self-attention (1) and cross-attention (2, 4096 queries over the
    encoder's 512 keys), pixtral-12b's (3). A checkout whose kernels take
    one length for queries and keys raises at the cross shape."""
    import torch
    from repro_torch.kernels import flash_attention as k78
    b = cs.RUN.lm_train_batch if backward else cs.RUN.lm_batch
    _, bh, bkv, sq, sk, d, causal = cs.encdec_attn_shapes(cs.RUN, b)[which]
    if backward:
        ins = cs.flash_bwd_inputs(torch.Generator().manual_seed(8), dev, bh,
                                  bkv, sq, d, torch.bfloat16, causal=causal,
                                  sk=sk)
        return lambda: k78.flash_bwd(*ins, causal=causal), 5
    g = torch.Generator().manual_seed(7)
    q, = cs.randn_heads(g, dev, (bh,), sq, d, torch.bfloat16)
    k, v = cs.randn_heads(g, dev, (bkv, bkv), sk, d, torch.bfloat16)
    return lambda: k78.flash_fwd(q, k, v, causal=causal), 5


def _seq_shard(cs, dev, backward: bool):
    """K7 (or K8) at minitron-4b's last shard of a model axis of
    ``RUN.seq_shards`` (``chip_smoke.shard_shape``): q ``[RUN.lm_batch x
    Hq, S / 16, D]`` at ``q_pos0 = S - S / 16`` over the whole k/v
    ``[RUN.lm_batch x Hkv, S, D]``, bf16, as ``chip_smoke.py`` times it
    under ``shapes`` (its case (f)). A checkout whose kernels take no query
    offset raises."""
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d = cs.lm_attn_shape(cs.RUN)
    b, s = cs.RUN.lm_batch, cs.RUN.attn_seq
    n, p = cs.shard_shape(cs.RUN)
    if backward:
        ins = cs.flash_bwd_inputs(torch.Generator().manual_seed(8), dev,
                                  b * hq, b * hkv, n, d, torch.bfloat16,
                                  sk=s, q_pos0=p)
        return lambda: k78.flash_bwd(*ins, causal=True, q_pos0=p), 5
    g = torch.Generator().manual_seed(7)
    q, = cs.randn_heads(g, dev, (b * hq,), n, d, torch.bfloat16)
    k, v = cs.randn_heads(g, dev, (b * hkv, b * hkv), s, d, torch.bfloat16)
    return lambda: k78.flash_fwd(q, k, v, causal=True, q_pos0=p), 5


def parts_ms(fn, events: dict, calls: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches (K8: the ``D =
    rowsum(do o)`` kernel, dq, dk/dv and, where the dk/dv grid is split,
    the split reduce; K3: the sort, or ``torch.sort``'s and the fill's
    kernels, then the chunk and merge passes), from ``torch.profiler`` over
    ``calls`` calls after a warm-up, and into ``events`` each kernel's
    launches a call; empty if the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time / 1e3 / calls
            events[e.name] = events.get(e.name, 0) + 1
    for name in events:
        events[name] /= calls
    return out


#: case -> builder ``(chip_smoke, device) -> (call, CUDA graph reps)``: the
#: launch floor (``chip_smoke.launch_floor_call``, a one-element ``add_``),
#: the served pooled read of all 26 tables through
#: ``core.hps.hps._pooled_stack`` (f32 and int8, ``served_inputs``, a new
#: batch of slots each call), the cache query's row read of one served
#: table (K5 on the f32 payload, K6 on the int8 one), K1 at the LM token
#: tables (``lm_k1_inputs``) and at the largest DLRM embedding group, K2 at
#: the served and the DLRM training shape, K3 at the LM token tables
#: (``lm_k3_check``'s inputs) and at the largest DLRM embedding group
#: (``kernel_phase``'s), K4 at the DLRM training shape
#: (``interaction_bwd_inputs``), K7 at the LM prefill shape (a) and the LM
#: training shape, and K8 at the LM training shape (a), K7 and K8 at
#: recurrentgemma-9b's windowed D 256 prefill and training shapes (b)
#: (each K8 case also split by launch, :data:`PARTS`; the ``waves`` cases
#: split the dk/dv grid for 1 or 4 blocks an SM instead of 2), K7 and K8
#: at granite-moe-3b-a800m's D 64 prefill and training shapes (c), K7 and
#: K8 at seamless-m4t-large-v2's encoder, decoder and cross-attention
#: shapes and pixtral-12b's (d: ``chip_smoke.encdec_attn_shapes``), K7 and
#: K8 at minitron-4b's last sequence-parallel shard of a model axis of 16
#: (``seq shard``: ``q_pos0`` 3840); then
#: the shapes of
#: DCN, WDL and DeepFM: K1 and K3 at full-vocabulary wdl-criteo's ``dist``
#: group (D 16) and its wide twins (D 1) (``wdl_training_rows``), and the
#: served pooled read and the cache query at D 16 and D 1; then NeuMF's:
#: K1 and K3 at its largest ``deep`` (D 64) and ``ctx`` (D 8) groups
#: (``neumf_training_rows``), the served read of its three HPSes (13 x D
#: 64, 9 x D 16, 4 x D 8) and the cache query at D 64 and D 8; then the
#: served read and the cache query on a 2-way striped L1's flat view
#: (``striped``, the online phase's ``cache_shards=2``); then K1 and K3
#: over phase 6d's flattened ETC cache (``etc_training_rows``); K3 at
#: xlstm-125m's token table (``lookup_bwd xlstm``); K3's library yardstick
#: (``zeros`` + ``index_add_``) at its narrow and short rows; the mesh half
#: of K5 / K6 (``mesh_half``: one table's row read over 8 stripes on
#: ``[dev, dev]``) and the 26 served tables' pooled read off a 2-stripe L1
#: on that cache mesh (``pooled_stack ... mesh``); ``sdpa``'s backward
#: alone at K8's (a), (b), (c), (d) and ``seq shard`` shapes (``library
#: flash_bwd ...``, :data:`LIBRARY_BWD`).
#: Every case also gives the port's launch counts of one call
#: (``launches``)
CASES = {
    "launch floor": lambda cs, dev: (cs.launch_floor_call(dev), 100),
    "pooled_stack f32": lambda cs, dev: _pooled_stack(cs, dev, "f32"),
    "pooled_stack int8": lambda cs, dev: _pooled_stack(cs, dev, "int8"),
    "gather_rows query": lambda cs, dev: _k5(cs, dev, "f32"),
    "dequant_gather_rows query": lambda cs, dev: _k5(cs, dev, "int8"),
    "lookup_fwd lm_hot": lambda cs, dev: _lm_k1(cs, dev, 0),
    "lookup_fwd lm_cold": lambda cs, dev: _lm_k1(cs, dev, 1),
    "lookup_fwd dlrm": _dlrm_k1,
    "interaction_fwd served": lambda cs, dev: _k2(cs, dev, cs.RUN.batch),
    "interaction_fwd dlrm": lambda cs, dev: _k2(cs, dev, cs.RUN.train_batch),
    "lookup_bwd lm_hot": lambda cs, dev: _lm_k3(cs, dev, 0),
    "lookup_bwd lm_cold": lambda cs, dev: _lm_k3(cs, dev, 1),
    "lookup_bwd dlrm": _dlrm_k3,
    "interaction_bwd dlrm": _k4,
    "flash_fwd (a)": lambda cs, dev: _k7(cs, dev, cs.RUN.lm_batch),
    "flash_fwd train": lambda cs, dev: _k7(cs, dev, cs.RUN.lm_train_batch),
    "flash_bwd (a)": _k8,
    "flash_fwd (b)": _k7_rg,
    "flash_bwd (b)": _k8_rg,
    **{f"flash_bwd (b) waves {n}":
       (lambda n: lambda cs, dev: _k8_rg(cs, dev, n))(n) for n in (1, 4)},
    "flash_fwd (c)": _k7_granite,
    "flash_bwd (c)": _k8_granite,
    **{f"flash_{'bwd' if bwd else 'fwd'} (d) {name}":
       (lambda i, bwd: lambda cs, dev: _encdec(cs, dev, i, bwd))(i, bwd)
       for i, name in enumerate(ENCDEC) for bwd in (False, True)},
    "flash_fwd seq shard": lambda cs, dev: _seq_shard(cs, dev, False),
    "flash_bwd seq shard": lambda cs, dev: _seq_shard(cs, dev, True),
    "lookup_fwd wdl dist": lambda cs, dev: _wdl(cs, dev, 0, False),
    "lookup_fwd wdl wide": lambda cs, dev: _wdl(cs, dev, 1, False),
    "lookup_bwd wdl dist": lambda cs, dev: _wdl(cs, dev, 0, True),
    "lookup_bwd wdl wide": lambda cs, dev: _wdl(cs, dev, 1, True),
    "pooled_stack f32 d16": lambda cs, dev: _pooled_stack(cs, dev, "f32", 16),
    "pooled_stack int8 d16": lambda cs, dev: _pooled_stack(cs, dev, "int8",
                                                           16),
    "pooled_stack f32 d1": lambda cs, dev: _pooled_stack(cs, dev, "f32", 1),
    "pooled_stack int8 d1": lambda cs, dev: _pooled_stack(cs, dev, "int8", 1),
    "gather_rows query d16": lambda cs, dev: _k5(cs, dev, "f32", 16),
    "dequant_gather_rows query d16": lambda cs, dev: _k5(cs, dev, "int8", 16),
    "gather_rows query d1": lambda cs, dev: _k5(cs, dev, "f32", 1),
    "dequant_gather_rows query d1": lambda cs, dev: _k5(cs, dev, "int8", 1),
    "lookup_fwd neumf deep": lambda cs, dev: _wdl(cs, dev, 0, False, "neumf"),
    "lookup_fwd neumf ctx": lambda cs, dev: _wdl(cs, dev, 1, False, "neumf"),
    "lookup_bwd neumf deep": lambda cs, dev: _wdl(cs, dev, 0, True, "neumf"),
    "lookup_bwd neumf ctx": lambda cs, dev: _wdl(cs, dev, 1, True, "neumf"),
    **{f"pooled_stack {pd} {t}x{d}":
       (lambda pd, t, d: lambda cs, dev: _pooled_stack(cs, dev, pd, d, t))(
           pd, t, d)
       for t, d in ((13, 64), (9, 16), (4, 8)) for pd in ("f32", "int8")},
    "gather_rows query d64": lambda cs, dev: _k5(cs, dev, "f32", 64),
    "dequant_gather_rows query d64": lambda cs, dev: _k5(cs, dev, "int8", 64),
    "gather_rows query d8": lambda cs, dev: _k5(cs, dev, "f32", 8),
    "dequant_gather_rows query d8": lambda cs, dev: _k5(cs, dev, "int8", 8),
    "pooled_stack f32 striped": lambda cs, dev: _striped(cs, dev, "f32"),
    "pooled_stack int8 striped": lambda cs, dev: _striped(cs, dev, "int8"),
    "gather_rows query striped":
        lambda cs, dev: _striped(cs, dev, "f32", query=True),
    "dequant_gather_rows query striped":
        lambda cs, dev: _striped(cs, dev, "int8", query=True),
    "library pooled_stack f32 striped":
        lambda cs, dev: _striped_library(cs, dev, "f32"),
    "library pooled_stack int8 striped":
        lambda cs, dev: _striped_library(cs, dev, "int8"),
    "library gather_rows query striped":
        lambda cs, dev: _striped_library(cs, dev, "f32", query=True),
    "lookup_fwd etc": lambda cs, dev: _wdl(cs, dev, 0, False, "etc"),
    "lookup_bwd etc": lambda cs, dev: _wdl(cs, dev, 0, True, "etc"),
    "lookup_bwd xlstm": lambda cs, dev: _lm_k3(cs, dev, 0,
                                               cs.RUN.xlstm_arch),
    "library lookup_bwd neumf ctx":
        lambda cs, dev: _wdl(cs, dev, 1, True, "neumf", library=True),
    "library lookup_bwd wdl wide":
        lambda cs, dev: _wdl(cs, dev, 1, True, library=True),
    "library lookup_bwd xlstm":
        lambda cs, dev: _lm_k3(cs, dev, 0, cs.RUN.xlstm_arch, library=True),
    "mesh_half f32": lambda cs, dev: _mesh_half(cs, dev, "f32"),
    "mesh_half int8": lambda cs, dev: _mesh_half(cs, dev, "int8"),
    "pooled_stack f32 mesh": lambda cs, dev: _mesh_stack(cs, dev, "f32"),
    "pooled_stack int8 mesh": lambda cs, dev: _mesh_stack(cs, dev, "int8"),
    **{f"library flash_bwd {case}":
       (lambda case: lambda cs, dev: _sdpa_bwd_at(cs, dev, case))(case)
       for case in LIBRARY_BWD},
}


#: the cases whose device time is also given kernel by kernel
#: (:func:`parts_ms`): K8's launches; K3's sort, zero-fill and passes;
#: the mesh half's remap ops, launches, stack and sum
PARTS = ("flash_bwd (a)", "flash_bwd (b)", "flash_bwd (c)",
         "flash_bwd (d) encoder", "flash_bwd (d) cross",
         "flash_bwd seq shard",
         "lookup_bwd neumf ctx", "lookup_bwd wdl wide", "lookup_bwd xlstm",
         "lookup_bwd dlrm", "flash_fwd (d) encoder", "flash_fwd (d) cross",
         "mesh_half f32", "mesh_half int8", "pooled_stack f32 mesh",
         "pooled_stack int8 mesh")

#: the cases no CUDA graph captures (an autograd backward): their device
#: time is the sum of :func:`parts_ms`, the profiler's
PROFILED = tuple(f"library flash_bwd {case}" for case in LIBRARY_BWD)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("cases", nargs="*", metavar="CASE",
                    help=f"cases to time, of {list(CASES)} (default: all)")
    args = ap.parse_args()
    unknown = set(args.cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {list(CASES)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    from repro_torch.kernels._build import LAUNCHES
    ms, wrapper, parts, events, launches = {}, {}, {}, {}, {}
    for name in args.cases or CASES:
        fn, reps = CASES[name](cs, dev)
        torch.cuda.synchronize()
        LAUNCHES.reset()
        fn()
        torch.cuda.synchronize()
        launches[name] = LAUNCHES.snapshot()
        if name in PARTS or name in PROFILED:
            events[name] = {}
            parts[name] = parts_ms(fn, events[name])
        ms[name] = (sum(parts[name].values()) if name in PROFILED
                    else cs.graph_ms(fn, reps))
        wrapper[name] = cs.time_ms(fn, 100)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "src": args.src,
                      "device_ms": ms, "wrapper_ms": wrapper,
                      "parts_ms": parts, "events": events,
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
