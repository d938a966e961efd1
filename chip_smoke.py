#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for sm_90a.
3. Kernels: launch K1 (pooled lookup), K2 (dot interaction), K5 (row
   gather) and K6 (dequantizing gather, int8 and f16) at the served
   shapes, K1 and K2 again at the training shapes, and K3 (the lookup's
   adjoint) and K4 (the interaction's) at the training shapes, and hold
   each against its plain PyTorch version
   on the card; time kernel, plain version and one library call with CUDA
   events. K7 (flash-attention forward) likewise at minitron-4b's prefill
   shape, recurrentgemma's local-attention shape and an odd f32 length,
   and K8 (its backward) at minitron-4b's training shape, recurrentgemma's
   local attention at S 2500 and an odd f32 length, with
   ``scaled_dot_product_attention``'s backward (forward + backward minus
   forward) as K8's yardstick.
4. Train: declare full-width ``dlrm-criteo`` (26 tables at D=128, 13 dense
   features, bottom MLP 512-256-128, top MLP 1024-1024-512-256-1, bf16
   compute) through the port's graph API and ``fit()`` it at batch
   ``RUN.train_batch`` on the synthetic reader: warm-up steps, then timed
   steps; the loss must fall, K3 and K4 must launch on every step, and
   the first steps with the plain versions must give the same losses.
   The one cut: each table's vocabulary is capped at ``RUN.vocab_cap``.
5. Deploy: ``Model.deploy()`` writes the trained model's serving bundle.
6. Serve: rebuild the server from ``ps.json`` on ``cuda`` and push
   batch-1024 Zipf requests through ``submit`` on the stream engine, once
   with an f32 and once with an int8 L1 payload; check the predictions
   against the plain path (pooled rows straight from the PDB, dense net
   with the plain ops) and, for both payloads, against the trained
   model's ``predict``; and that the kernels' launch counters rose.
7. LM serve: full-width ``minitron-4b`` (hybrid token embedding, random
   weights from a seed) prefills a 2 x 4096 Zipf(1.2) batch through K1 and
   K7, held against the plain path (K1 first alone, bit-exact, on both
   token tables at the prefill's and a decode step's rows); then a
   64-token prompt is replayed through ``decode_step`` into a 4096-entry
   KV cache, held against the prefill of the same tokens, and 32 greedy
   tokens are decoded. The cut:
   ``prefill_32k``'s batch 32 x 32768 becomes 2 x 4096.
8. LM train, checked: a depth-2 copy of ``minitron-4b`` at full width
   takes one gradient on the kernels (K1, K3, K7, K8) and on the plain
   path; the loss and every parameter's gradient must agree.
9. LM train: full-width ``minitron-4b`` (hybrid token table, seed-0
   weights, bf16 compute) takes SGD steps on one 1 x 4096 Zipf(1.2) batch
   through K1 and K7 forward and K8 and K3 backward (K3 first alone at the
   LM's shapes), one warm-up and timed steps; the loss must fall at every
   step. The cut: ``train_4k``'s batch 256 x 4096 becomes 1 x 4096.
10. One JSON line of per-kernel numbers, then the device line last.

Needs ``torch.cuda.is_available()`` and the package under ``src/``; with
either missing it prints no result and exits 2.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
#: probability tolerance of the served bf16 DLRM against the plain path
#: (the bound the reference holds its own server to); int8 payloads add
#: quantization error, bounded as the reference's launcher bounds it
SERVE_TOL = {"f32": 2e-2, "int8": 1e-1}
#: trained model's predictions against the plain versions' (first steps'
#: losses) and against the served ones: the bf16 bound of the reference
TRAIN_TOL = 2e-2
#: the run: vocabulary cap per table (the one cut), L1 rows per table,
#: request batch, warm-up and measured requests, seed; training batch,
#: warm-up and timed steps, steps on the plain versions, learning rate
RUN = types.SimpleNamespace(vocab_cap=1 << 20, cache_capacity=131072,
                            batch=1024, warmup=4, requests=16, seed=0,
                            train_batch=4096, warm_steps=2, timed_steps=8,
                            plain_steps=3, lr=1e-3,
                            attn_seq=4096, attn_odd_seq=1000,
                            lm_arch="minitron-4b", lm_batch=2, lm_seq=4096,
                            lm_timed=5, prompt=64, decode_steps=32,
                            attn_bwd_local_seq=2500, lm_train_batch=1,
                            lm_train_warm=1, lm_train_timed=5,
                            lm_train_lr=3e-4,
                            lm_check_layers=2)
#: K7 against its plain version: bf16 ``o`` (one bf16 ulp of |o| < 4,
#: where the kernel's bf16 ``p`` and the plain f32 ``p`` round apart) and
#: the f32 ``lse``; f32 inputs: the f32 sum-order bound
ATTN_TOL = {"bf16": (2e-2, 1e-3), "f32": (1e-4, 1e-4)}
#: minitron prefill logits on the kernels against the plain path, relative
#: to the largest |logit|: K7 rounds p to bf16 and the plain version does
#: not, so bf16 activations differ by an ulp here and there and drift
#: through 32 layers
LM_LOGIT_TOL = 5e-2
#: K8 against its plain version: bf16 by ``ref.BF16_GRAD_RULE``, within
#: 1e-2 of the largest |gradient|, the whole tensor within 1e-2 relative
#: L2 and each row within 2e-2 of its own norm plus 1e-4 of the largest
#: row norm (the kernel rounds p and ds to bf16 before its products, the
#: plain version keeps f32: each row's relative error stays a few bf16
#: rounding steps), f32 within 1e-4 (the f32 sum-order bound)
ATTN_BWD_TOL_F32 = 1e-4
#: the depth-2 full-width model on the kernels against the plain path:
#: relative loss, and per parameter the relative L2 error and the cosine of
#: the gradients (bf16 compute: K7 and K8 round p and ds to bf16, the plain
#: versions do not; a narrow 2-layer emulation on the CPU gave 8e-5 of the
#: loss, 8.1e-3 and 0.99996 at worst)
LM_GRAD_TOL = types.SimpleNamespace(loss_rel=1e-3, rel=5e-2, cos=0.999)
#: decode against prefill: the reference's bound for the same check
#: (tests/test_models_smoke.py::test_decode_matches_prefill)
DECODE_TOL = types.SimpleNamespace(rtol=0.1, atol=0.15, corr=0.99)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph
    and replayed, so the host's launch cost (Python, ctypes, allocation)
    is out of the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, iters=10) / reps


def zipf_ids(rng, vocab: int, size, a: float = 1.1):
    """Frequency-sorted bounded-Zipf draw on [0, vocab) (the reference's
    synthetic-data distribution)."""
    import numpy as np
    u = rng.random(size)
    x = (u * ((vocab + 1.0) ** (1 - a) - 1.0) + 1.0) ** (1 / (1 - a))
    return np.clip(np.floor(x).astype(np.int64) - 1, 0, vocab - 1)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def capped_config(args):
    """Full-width ``dlrm-criteo`` with each vocabulary capped (the cut)."""
    import dataclasses
    from repro_torch.configs.registry import dlrm_criteo
    return dataclasses.replace(dlrm_criteo, tables=tuple(
        dataclasses.replace(t, vocab_size=min(t.vocab_size, args.vocab_cap))
        for t in dlrm_criteo.tables))


def training_rows(args, dev):
    """K3's inputs as the training run gives them: the embedding groups
    the planner makes, ``{key: (group rows, that group's row ids of the
    first training batch, [B * T_g, 1])}``."""
    from repro_torch.configs.base import SINGLE_DEVICE
    from repro_torch.core.embedding.collection import EmbeddingCollection
    from repro_torch.core.embedding.planner import resolve_strategies
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.train.trainer import put_batch
    cfg = capped_config(args)
    coll = EmbeddingCollection(
        resolve_strategies(cfg.tables, SINGLE_DEVICE, args.train_batch),
        device=dev)
    batch = put_batch(SyntheticCTR(cfg, args.train_batch,
                                   seed=args.seed).batch(0), dev)
    return {k: (coll.groups[k].total_rows, r.reshape(-1, r.shape[-1]))
            for k, r in coll.group_rows(batch["cat"]).items()}


def kernel_phase(args, dev):
    import numpy as np
    import torch
    from repro_torch.kernels import dot_interaction as k2
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels import hps_gather as k56
    from repro_torch.core.hps.payload_store import quantize_rows

    g = torch.Generator(device="cpu").manual_seed(args.seed)
    B, D, C, F = args.batch, 128, args.cache_capacity, 27
    P = F * (F - 1) // 2
    rows_f32 = (torch.randn((C, D), generator=g) * 0.3)
    table = rows_f32.to(dev)
    slots = torch.randint(0, C, (B,), generator=g,
                          dtype=torch.int32).to(dev)
    q_np, sc_np = quantize_rows(rows_f32.numpy(), "int8")
    q8, sc8 = torch.from_numpy(q_np).to(dev), torch.from_numpy(sc_np).to(dev)
    h16 = rows_f32.to(torch.float16).to(dev)
    sc16 = (torch.rand((C,), generator=g) + 0.5).to(dev)
    x = torch.cat([torch.randn((B, 1, D), generator=g),
                   torch.randn((B, F - 1, D), generator=g) * 0.3], 1)
    x = x.to(torch.bfloat16).float().to(dev).contiguous()
    li, lj = torch.tril_indices(F, F, -1, device=dev)
    out, device = {}, {}

    def record(name, source, replaces, got, want, exact, tol, fn, plain,
               lib, nbytes, flops, reps=20, flops_per_s=F32_FLOPS, iters=50):
        err = (got - want).abs().max().item()
        if exact:
            check(torch.equal(got, want), f"{name}: not bit-exact "
                  f"(max abs err {err})")
        elif tol is not None:
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"{name}: max abs err {err} above {tol}")
        bms, by = bound_ms(nbytes, flops, flops_per_s)
        out[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": time_ms(fn, iters), "plain_ms": time_ms(plain, iters),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lib, iters) if lib is not None else None}
        device[name] = graph_ms(fn, reps)
        return out[name]

    # K1 at the served shape: f32 L1 payload [C, D], one id per table row
    rows = slots.view(B, 1)
    record("lookup_fwd", "src/repro_torch/csrc/embedding_lookup.cu",
           "src/repro/kernels/embedding_lookup.py:67",
           k1.lookup_fwd(table, rows), k1.lookup_fwd_plain(table, rows),
           True, 0.0, lambda: k1.lookup_fwd(table, rows),
           lambda: k1.lookup_fwd_plain(table, rows),
           lambda: table.index_select(0, slots).view(B, 1, D).sum(1),
           B * D * 4 + B * 4 + B * D * 4, B * D)
    # K1 off the served shape: bf16 table, H=3 with pads and duplicates
    multi = torch.randint(-1, 64, (B, 3), generator=g,
                          dtype=torch.int32).to(dev)
    tb = table.to(torch.bfloat16)
    got, want = k1.lookup_fwd(tb, multi), k1.lookup_fwd_plain(tb, multi)
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          "lookup_fwd bf16 H=3: above 1e-6")

    # K5: the L1 row read of DeviceEmbeddingCache.query
    holes = slots.clone()
    holes[::7] = -1
    record("gather_rows", "src/repro_torch/csrc/hps_gather.cu",
           "src/repro/kernels/hps_gather.py:54",
           k56.gather_rows(table, holes), k56.gather_rows_plain(table, holes),
           True, 0.0, lambda: k56.gather_rows(table, slots),
           lambda: k56.gather_rows_plain(table, slots),
           lambda: table.index_select(0, slots),
           B * D * 4 + B * 4 + B * D * 4, 0)

    # K6: the int8 L1 pooled read (and the f16 payload variant)
    got16 = k56.dequant_gather_rows(h16, sc16, holes)
    want16 = k56.dequant_gather_rows_plain(h16, sc16, holes)
    check(torch.equal(got16, want16), "dequant_gather_rows f16: not exact")
    record("dequant_gather_rows", "src/repro_torch/csrc/hps_gather.cu",
           "src/repro/kernels/hps_gather.py:98",
           k56.dequant_gather_rows(q8, sc8, holes),
           k56.dequant_gather_rows_plain(q8, sc8, holes), True, 0.0,
           lambda: k56.dequant_gather_rows(q8, sc8, slots),
           lambda: k56.dequant_gather_rows_plain(q8, sc8, slots),
           lambda: q8.index_select(0, slots).float()
           * sc8.index_select(0, slots)[:, None],
           B * D * 1 + B * 4 + B * 4 + B * D * 4, B * D)

    # K2: DLRM's interaction at F = 26 tables + 1, D = 128
    record("interaction_fwd", "src/repro_torch/csrc/dot_interaction.cu",
           "src/repro/kernels/dot_interaction.py:55",
           k2.interaction_fwd(x), k2.interaction_fwd_plain(x), False, 1e-5,
           lambda: k2.interaction_fwd(x),
           lambda: k2.interaction_fwd_plain(x),
           lambda: torch.bmm(x, x.transpose(1, 2))[:, li, lj],
           B * F * D * 4 + B * P * 4, 2 * B * P * D)
    xs = torch.randn((5, 4, 16), generator=g).to(dev)
    check(torch.allclose(k2.interaction_fwd(xs, self_interaction=True),
                         k2.interaction_fwd_plain(xs, self_interaction=True),
                         rtol=1e-5, atol=1e-5),
          "interaction_fwd self_interaction: above 1e-5")
    # K3: the lookup's adjoint at the training shapes and ids (the first
    # training batch's Zipf ids, one launch per embedding group and step);
    # timed at the largest group
    tb = args.train_batch
    groups = training_rows(args, dev)
    largest = max(groups, key=lambda k: groups[k][0])
    gc = torch.Generator(device=dev).manual_seed(args.seed)
    for key, (v, rows3) in sorted(groups.items(), key=lambda kv: kv[1][0]):
        # K1 at the same training shape: the group's f32 mega-table
        mega = torch.randn((v, D), generator=gc, device=dev)
        check(torch.equal(k1.lookup_fwd(mega, rows3),
                          k1.lookup_fwd_plain(mega, rows3)),
              f"lookup_fwd {key}: not bit-exact at rows [{rows3.shape[0]}, "
              f"1] into [{v}, {D}]")
        del mega
        dp3 = torch.randn((rows3.shape[0], D), generator=g).to(dev)
        got, want = k1.lookup_bwd((v, D), rows3, dp3), \
            k1.lookup_bwd_plain((v, D), rows3, dp3)
        check(torch.equal(got, k1.lookup_bwd((v, D), rows3, dp3)),
              f"lookup_bwd {key}: two launches differ")
        check(torch.equal(got, k1.lookup_bwd_chunked_plain((v, D), rows3,
                                                           dp3)),
              f"lookup_bwd {key}: not bit-exact to its chunked plain version")
        # a Zipf head id sums thousands of rows: the f32 sum-order bound
        # is relative to the sum of the absolute contributions
        scale = k1.lookup_bwd_plain((v, D), rows3, dp3.abs())
        check(bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()),
              f"lookup_bwd {key}: above 1e-5 of the summed magnitudes")
        del scale
        distinct = int(torch.unique(rows3[rows3 >= 0]).numel())
        print(f"lookup_bwd group {key}: rows [{tb}*{rows3.shape[0] // tb}, "
              f"1] into [{v}, {D}], {distinct} distinct ids")
        if key != largest:
            continue
        keep = rows3.view(-1) >= 0
        flat, src = rows3.view(-1)[keep].long(), dp3[keep]
        n3 = rows3.shape[0]
        record("lookup_bwd", "src/repro_torch/csrc/embedding_lookup.cu",
               "src/repro/kernels/embedding_lookup.py:87", got, want, False,
               None, lambda: k1.lookup_bwd((v, D), rows3, dp3),
               lambda: k1.lookup_bwd_plain((v, D), rows3, dp3),
               lambda: torch.zeros((v, D), device=dev).index_add_(
                   0, flat, src),
               int(keep.sum()) * D * 4 + n3 * 4 + v * D * 4,
               int(keep.sum()) * D, reps=4)
        del got, want

    # K4: the interaction's adjoint at the training shape (f32 x, as the
    # dense net feeds K2); bf16 and self_interaction checked off it
    P = F * (F - 1) // 2
    xt = torch.randn((tb, F, D), generator=g).mul_(0.3).to(dev)
    dtri = torch.randn((tb, P), generator=g).to(dev)
    bi, bj = torch.tril_indices(F, F, -1, device=dev)
    check(torch.allclose(k2.interaction_fwd(xt), k2.interaction_fwd_plain(xt),
                         rtol=1e-5, atol=1e-5),
          f"interaction_fwd at the training shape [{tb}, {F}, {D}]: above "
          "1e-5")

    def lib_k4():
        gm = torch.zeros((tb, F, F), device=dev)
        gm[:, bi, bj] = dtri
        return torch.bmm(gm + gm.transpose(1, 2), xt)

    record("interaction_bwd", "src/repro_torch/csrc/dot_interaction.cu",
           "src/repro/kernels/dot_interaction.py:73",
           k2.interaction_bwd(xt, dtri), k2.interaction_bwd_plain(xt, dtri),
           False, 1e-5, lambda: k2.interaction_bwd(xt, dtri),
           lambda: k2.interaction_bwd_plain(xt, dtri), lib_k4,
           2 * tb * F * D * 4 + tb * P * 4, 2 * tb * F * F * D)
    xs4 = torch.randn((7, 5, 16), generator=g).to(dev)
    ds4 = torch.randn((7, 15), generator=g).to(dev)
    check(torch.allclose(k2.interaction_bwd(xs4, ds4, self_interaction=True),
                         k2.interaction_bwd_plain(xs4, ds4,
                                                  self_interaction=True),
                         rtol=1e-5, atol=1e-5),
          "interaction_bwd self_interaction: above 1e-5")
    xb4, db4 = xs4.to(torch.bfloat16), ds4[:, :10].contiguous()
    gb = k2.interaction_bwd(xb4, db4)
    check(gb.dtype == torch.bfloat16 and torch.allclose(
        gb.float(), k2.interaction_bwd_plain(xb4, db4).float(),
        rtol=1e-2, atol=1e-2), "interaction_bwd bf16: above 1e-2")
    attention_kernel(args, record, g, dev)
    attention_bwd_kernel(args, record, g, dev)
    for rec in out.values():
        print(f"kernel {rec['name']}: {rec['ms']:.4f} ms (bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              f"ms), max abs err {rec['max_abs_err']:.3g}; device time "
              f"{device[rec['name']]:.4f} ms (CUDA graph replay)")
    return out


def lm_attn_shape(args) -> tuple:
    """``(Hq, Hkv, D)`` of the attention of ``args.lm_arch``."""
    from repro_torch.configs.registry import get_lm_config
    cfg = get_lm_config(args.lm_arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim


def randn_heads(g, dev, heads, s: int, d: int, dtype) -> list:
    """One random ``[n, s, d]`` tensor of ``dtype`` on ``dev`` for each
    ``n`` of ``heads``, drawn in that order from CPU generator ``g``."""
    import torch
    return [torch.randn((n, s, d), generator=g).to(dtype).to(dev)
            for n in heads]


def flash_bwd_inputs(g, dev, bh: int, bkv: int, s: int, d: int, dtype,
                     window=None) -> tuple:
    """K8's inputs: random ``q, k, v, do`` and K7's own causal ``o`` and
    ``lse`` for them -> ``(q, k, v, o, lse, do)``."""
    from repro_torch.kernels import flash_attention as k78
    q, k, v, do = randn_heads(g, dev, (bh, bkv, bkv, bh), s, d, dtype)
    o, lse = k78.flash_fwd(q, k, v, causal=True, window=window)
    return q, k, v, o, lse, do


def attention_kernel(args, record, g, dev):
    """K7 against its plain version at (a) minitron-4b's prefill shape
    (timed), (b) recurrentgemma's local attention and (c) an odd f32
    length with GQA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels.ref import flash_attention_ref

    def qkv(bh, bkv, s, d, dtype):
        return randn_heads(g, dev, (bh, bkv, bkv), s, d, dtype)

    def held(case, q, k, v, dtype, window=None):
        o, lse = k7.flash_fwd(q, k, v, causal=True, window=window)
        po, plse = flash_attention_ref(q, k, v, causal=True, window=window)
        err_o = (o.float() - po.float()).abs().max().item()
        err_l = (lse - plse).abs().max().item()
        tol_o, tol_l = ATTN_TOL[dtype]
        check(err_o <= tol_o and err_l <= tol_l,
              f"flash_fwd {case}: max abs err o {err_o}, lse {err_l} (bounds "
              f"{tol_o}, {tol_l})")
        print(f"flash_fwd {case}: q {list(q.shape)} k/v {list(k.shape)} "
              f"{dtype}, window {window}: max abs err o {err_o:.3g} (bound "
              f"{tol_o}), lse {err_l:.3g} (bound {tol_l})")
        return o, po

    # (b) recurrentgemma's local attention: Hq 16, Hkv 1, D 256, window 2048
    s = args.attn_seq
    held("(b)", *qkv(16, 1, s, 256, torch.bfloat16), "bf16", window=s // 2)
    # (c) an odd length in f32 with GQA g = 2
    held("(c)", *qkv(8, 4, args.attn_odd_seq, 64, torch.float32), "f32")
    # (a) minitron-4b prefill: B 2, Hq 24, Hkv 8, D 128, S 4096, causal
    b, (hq, hkv, d) = args.lm_batch, lm_attn_shape(args)
    q, k, v = qkv(b * hq, b * hkv, s, d, torch.bfloat16)
    o, po = held("(a)", q, k, v, "bf16")
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, k, v))
    pairs = s * (s + 1) // 2                   # causal (query, key) pairs
    record("flash_fwd", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:101", o.float(), po.float(),
           False, None, lambda: k7.flash_fwd(q, k, v, causal=True),
           lambda: flash_attention_ref(q, k, v, causal=True),
           lambda: F.scaled_dot_product_attention(
               q4, k4, v4, is_causal=True, enable_gqa=True),
           2 * (q.numel() + k.numel() + v.numel() + q.numel())
           + 4 * b * hq * s, 4 * b * hq * d * pairs, reps=5,
           flops_per_s=BF16_TC_FLOPS, iters=10)


def attention_bwd_kernel(args, record, g, dev):
    """K8 against its plain version on K7's own ``o`` and ``lse``, twice
    (the bits must repeat), at (a) minitron-4b's training shape (timed,
    with ``scaled_dot_product_attention``'s backward as the yardstick), (b)
    recurrentgemma's local attention at an S no tile divides and (c) an odd
    f32 length with GQA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k78
    from repro_torch.kernels.ref import (BF16_GRAD_RULE,
                                         flash_attention_bwd_ref,
                                         grad_row_error)

    def inputs(bh, bkv, s, d, dtype, window=None):
        return flash_bwd_inputs(g, dev, bh, bkv, s, d, dtype, window)

    def held(case, ins, dtype, window=None):
        got = k78.flash_bwd(*ins, causal=True, window=window)
        again = k78.flash_bwd(*ins, causal=True, window=window)
        want = flash_attention_bwd_ref(*ins, causal=True, window=window)
        errs = []
        for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
            check(torch.equal(x, y), f"flash_bwd {case} {name}: two "
                  "launches differ")
            top = w.float().abs().max().item()
            err = (x.float() - w.float()).abs().max().item()
            if dtype == "f32":
                check(err <= ATTN_BWD_TOL_F32, f"flash_bwd {case} {name}: "
                      f"max abs err {err} above {ATTN_BWD_TOL_F32}")
                errs.append(f"{name} {err:.3g} (bound {ATTN_BWD_TOL_F32})")
                continue
            peak, whole, worst = grad_row_error(x, w)
            check(peak <= BF16_GRAD_RULE["peak"]
                  and whole <= BF16_GRAD_RULE["whole"] and worst <= 1.0,
                  f"flash_bwd {case} {name}: max abs err {peak} of max "
                  f"|{name}| (bound {BF16_GRAD_RULE['peak']}), relative L2 "
                  f"{whole} (bound {BF16_GRAD_RULE['whole']}), worst row at "
                  f"{worst} of its limit (bound 1)")
            errs.append(f"{name} {err:.3g} (bound "
                        f"{BF16_GRAD_RULE['peak'] * top:.3g}), "
                        f"relative L2 {whole:.3g} (bound "
                        f"{BF16_GRAD_RULE['whole']}), worst row {worst:.3g} "
                        f"of its limit")
        q, k = ins[0], ins[1]
        print(f"flash_bwd {case}: q/o/do {list(q.shape)} k/v "
              f"{list(k.shape)} {dtype}, window {window}: max abs err "
              + ", ".join(errs) + "; two launches bit-identical")
        return (torch.cat([x.float().flatten() for x in got]),
                torch.cat([x.float().flatten() for x in want]))

    # (b) recurrentgemma's local attention: Hq 16, Hkv 1, D 256, window 2048
    held("(b)", inputs(16, 1, args.attn_bwd_local_seq, 256, torch.bfloat16,
                       2048), "bf16", window=2048)
    # (c) an odd length in f32 with GQA g = 2
    held("(c)", inputs(8, 4, args.attn_odd_seq, 64, torch.float32), "f32")
    # (a) minitron-4b training: B 1, Hq 24, Hkv 8, D 128, S 4096, causal
    (hq, hkv, d), s = lm_attn_shape(args), args.attn_seq
    ins = inputs(hq, hkv, s, d, torch.bfloat16)
    got, want = held("(a)", ins, "bf16")
    q, k, v, o, lse, do = ins
    pairs = s * (s + 1) // 2
    rec = record("flash_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "src/repro/kernels/flash_attention.py:233", got, want,
                 False, None, lambda: k78.flash_bwd(*ins, causal=True),
                 lambda: flash_attention_bwd_ref(*ins, causal=True), None,
                 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                 5 * 2 * hq * d * pairs, reps=5, flops_per_s=BF16_TC_FLOPS,
                 iters=10)
    # the yardstick: sdpa forward + backward, minus its forward
    q4, k4, v4 = (t.detach().view(1, -1, s, d).requires_grad_()
                  for t in (q, k, v))
    do4 = do.view(1, hq, s, d)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    fwd_ms = time_ms(sdpa, 10)
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4),
                                                  do4), 10)
    rec["library_ms"] = both_ms - fwd_ms
    print(f"flash_bwd yardstick: scaled_dot_product_attention forward + "
          f"backward {both_ms:.4f} ms minus forward {fwd_ms:.4f} ms = "
          f"{both_ms - fwd_ms:.4f} ms")


# ---------------------------------------------------------------------------
# phases 4-5: train full-width DLRM through fit(), then deploy it
# ---------------------------------------------------------------------------

def declare(args, cfg):
    """The ``dlrm-criteo`` graph through the port's graph API."""
    from repro_torch.api import CreateSolver, DataReaderParams, dlrm_graph
    return dlrm_graph(cfg, solver=CreateSolver(
        batch_size=args.train_batch, lr=args.lr, seed=args.seed),
        reader=DataReaderParams(num_dense_features=cfg.num_dense_features,
                                seed=args.seed))


#: device kernels by kind, by a piece of their name (first match wins)
KINDS = (("K7", ("flash_fwd",)), ("K8", ("flash_bwd",)),
         ("K1", ("lookup_fwd_kernel",)), ("K3", ("lookup_bwd_",)),
         ("K2", ("interaction_fwd_kernel",)),
         ("K4", ("interaction_bwd_kernel",)), ("K5/K6", ("gather_rows",)),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet")), ("fill", ("Fill",)),
         ("sort", ("radix", "Radix", "sort")), ("reduce", ("reduce_kernel",)),
         ("copy", ("copy", "Memcpy")), ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    for k, keys in KINDS:
        if any(key in name for key in keys):
            return k
    return "other"


def profile(label: str, fn) -> None:
    """Where one call's time goes: its host wall time against the device's
    busy time in it (the sum of kernel times from ``torch.profiler``), the
    busy time by kind of kernel, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile {label}: wall {wall:.2f} ms; device time not "
              "measured (the profiler recorded no device events)")
        return
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    by_kind = {}
    for n, t in by_name.items():
        by_kind[kind(n)] = by_kind.get(kind(n), 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {len(kernels)} device events; by "
          "kind: " + "; ".join(f"{k} {t:.3f} ms" for k, t in sorted(
              by_kind.items(), key=lambda kv: -kv[1]))
          + "; top: " + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top))


def train_phase(args, dev):
    """fit() full-width DLRM; returns the trained model and the launch
    counts of its run."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.train.trainer import Trainer

    from repro_torch.configs.registry import dlrm_criteo
    cfg = capped_config(args)
    full_rows = sum(t.vocab_size for t in dlrm_criteo.tables)
    rows = sum(t.vocab_size for t in cfg.tables)
    print(f"reduced: vocabulary capped at {args.vocab_cap} rows per table: "
          f"{rows} rows ({rows * 128 * 4 / 1e9:.2f} GB f32) instead of "
          f"{full_rows} ({full_rows * 128 * 4 / 1e9:.2f} GB); widths, 26 "
          f"tables, hotness and both MLPs as published")
    steps = args.warm_steps + args.timed_steps
    t0 = time.perf_counter()
    m = declare(args, cfg).compile(device=dev)
    print("train groups: " + ", ".join(
        f"{k} {g.num_tables} tables {g.total_rows} rows"
        for k, g in m.model.embedding.groups.items()))
    reader = SyntheticCTR(cfg, args.train_batch, seed=args.seed)
    per_step, data_ms = [], []

    def data_fn(step):             # launch counts as each step begins, and
        per_step.append(LAUNCHES.snapshot())     # the reader's host time
        t = time.perf_counter()
        batch = reader.batch(step)
        data_ms.append((time.perf_counter() - t) * 1e3)
        return batch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    hist = m.fit(data_fn, steps=steps)
    torch.cuda.synchronize()
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step.append(launches)
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and np.isfinite(losses).all(),
          f"train: {len(hist)} steps, losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    groups = len(m.model.embedding.groups)
    for i in range(steps):
        d = {k: per_step[i + 1].get(k, 0) - per_step[i].get(k, 0)
             for k in ("lookup_bwd", "interaction_bwd")}
        check(d == {"lookup_bwd": groups, "interaction_bwd": 1},
              f"train step {i}: launches {d}, want K3 once per embedding "
              f"group ({groups}) and K4 once")
    ms = [h["time"] * 1e3 for h in hist[args.warm_steps:]]
    p50 = float(np.median(ms))
    print(f"train on {torch.cuda.get_device_name(0)}: {steps} steps at "
          f"batch {args.train_batch} ({args.warm_steps} warm-up) in "
          f"{time.perf_counter() - t0:.1f} s with set-up; step p50 "
          f"{p50:.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}), "
          f"{args.train_batch / p50 * 1e3:.0f} samples/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak memory "
          f"{peak:.2f} GiB; synthetic batch on the host p50 "
          f"{float(np.median(data_ms[args.warm_steps:])):.2f} ms of each "
          f"step; launches {launches}")

    # one more step, profiled, from the trained state (not kept)
    tr = Trainer(m.model, m.solver.to_train_config(), reader.batch)
    profile("train step", lambda: tr.train(
        1, initial_state=(m.params, None)))

    # the first steps again on the plain versions, from the same init
    plain = declare(args, cfg).compile(device=dev, use_kernels=False)
    ph = plain.fit(reader.batch, steps=args.plain_steps)
    err = max(abs(a["loss"] - b["loss"]) for a, b in zip(ph, hist))
    check(err <= TRAIN_TOL, f"train: plain-version losses "
          f"{[h['loss'] for h in ph]} vs {losses[:args.plain_steps]}")
    print(f"train plain versions: first {args.plain_steps} losses within "
          f"{err:.3g} of the kernel path (bound {TRAIN_TOL})")
    del plain, ph
    torch.cuda.empty_cache()
    return m, launches


def deploy_phase(args, m, bundle_dir):
    """Model.deploy() the trained model; returns what the serving checks
    need: the config, the bundle's PDB and the dense params."""
    from repro_torch.core.hps.persistent_db import PersistentDB
    t0 = time.perf_counter()
    server = m.deploy(bundle_dir, cache_capacity=args.cache_capacity,
                      max_batch=args.batch)
    server.close()
    pdb = PersistentDB(os.path.join(bundle_dir, "pdb"))
    for t in m.cfg.tables:
        pdb.open_table(m.name, t.name)
    print(f"deploy: {len(m.cfg.tables)} trained tables written in "
          f"{time.perf_counter() - t0:.1f} s")
    return m.cfg, pdb, m.dense_params()


# ---------------------------------------------------------------------------
# phase 6: serve the bundle
# ---------------------------------------------------------------------------

def make_requests(args, cfg, n, stream):
    import numpy as np
    rng = np.random.default_rng((args.seed, stream))
    reqs = []
    for _ in range(n):
        dense = rng.standard_normal((args.batch, cfg.num_dense_features)
                                    ).astype(np.float32)
        cat = np.stack([zipf_ids(rng, t.vocab_size, (args.batch, 1))
                        for t in cfg.tables], axis=1).astype(np.int32)
        reqs.append((dense, cat))
    return reqs


def plain_predict(cfg, pdb, params, dev, dense, cat):
    """The plain path: pooled rows straight from the PDB memmap, the dense
    net with the plain dot interaction, then the sigmoid."""
    import numpy as np
    import torch
    from repro_torch.models.recsys.model import RecsysModel
    emb = np.stack([pdb.fetch(cfg.name, t.name, cat[:, ti, 0])
                    for ti, t in enumerate(cfg.tables)], axis=1)
    model = RecsysModel(cfg, device=dev, use_kernels=False)
    with torch.no_grad():
        logit = model.apply_dense(params, torch.from_numpy(dense).to(dev),
                                  torch.from_numpy(emb).to(dev))
    return torch.sigmoid(logit).cpu().numpy(), emb


def serve_phase(args, ps_path, cfg, pdb, params, dev, payload_dtype,
                trained=None):
    """Serve the bundle; with ``trained`` (the api.Model that deployed it)
    the served predictions are also held against its ``predict``."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.serve import build_server_from_config

    server, _ = build_server_from_config(ps_path, device=dev,
                                         payload_dtype=payload_dtype)
    warm = make_requests(args, cfg, args.warmup, 1)
    reqs = make_requests(args, cfg, args.requests, 2)
    try:
        for dense, cat in warm:                  # fill L1, warm the caches
            server.predict(dense, cat)
        server.reset_latencies()
        before = {k: c.counters() for k, c in server.hps.caches.items()}
        server.start()
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        handles = [server.submit(d, c) for d, c in reqs]
        preds = [h.get(timeout=600) for h in handles]
        probe = server.hps.caches[cfg.tables[0].name].query(
            reqs[0][1][:, 0, 0].astype(np.int64))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES.snapshot()
        server.stop()
        for p in preds:
            if isinstance(p, Exception):
                raise p
        after = {k: c.counters() for k, c in server.hps.caches.items()}
        hits = sum(after[k]["hits"] - before[k]["hits"] for k in after)
        miss = sum(after[k]["misses"] - before[k]["misses"] for k in after)
        pct = server.latency_percentiles()      # submit burst, queueing in
        server.reset_latencies()
        for dense, cat in reqs[:8]:             # one request at a time
            server.predict(dense, cat)
        seq = server.latency_percentiles()
        profile("predict", lambda: server.predict(*reqs[8 % len(reqs)]))

        # predictions against the plain path
        err = 0.0
        for (dense, cat), p in zip(reqs, preds):
            check(p.shape == (args.batch,) and np.isfinite(p).all(),
                  f"{payload_dtype}: bad prediction block {p.shape}")
            want, emb = plain_predict(cfg, pdb, params, dev, dense, cat)
            err = max(err, float(np.abs(p - want).max()))
        tol = SERVE_TOL[payload_dtype]
        check(err <= tol, f"{payload_dtype}: served predictions deviate "
              f"{err} from the plain path (bound {tol})")
        trained_err = None
        if trained is not None:
            trained_err = max(
                float(np.abs(p - trained.predict(
                    {"dense": d, "cat": c})).max())
                for (d, c), p in zip(reqs, preds))
            check(trained_err <= TRAIN_TOL, f"{payload_dtype}: served "
                  f"predictions deviate {trained_err} from the trained "
                  f"Model.predict (bound {TRAIN_TOL})")
        # the pooled L1 read itself: bit-exact for f32, within half a
        # quantization step for int8
        dense, cat = reqs[-1]
        got = server.hps.lookup(cat).cpu().numpy()
        _, emb = plain_predict(cfg, pdb, params, dev, dense, cat)
        if payload_dtype == "f32":
            check(np.array_equal(got, emb), "f32 L1 read is not bit-exact")
        else:
            step = np.abs(emb).max(axis=2, keepdims=True) / 127.0
            check(bool((np.abs(got - emb) <= 0.5 * step + 1e-6).all()),
                  "int8 L1 read exceeds half a quantization step")
        first = probe.cpu().numpy()
        want_rows = pdb.fetch(cfg.name, cfg.tables[0].name,
                              reqs[0][1][:, 0, 0])
        check(np.abs(first - want_rows).max() <= (
            0 if payload_dtype == "f32" else
            np.abs(want_rows).max() / 254 + 1e-6),
            "DeviceEmbeddingCache.query rows disagree with the PDB")
    finally:
        server.close()
    # f32 reads go through K1 (pooled) and K5 (the cache query); int8
    # reads through K6 for both
    need = (["lookup_fwd", "gather_rows"] if payload_dtype == "f32"
            else ["dequant_gather_rows"]) + ["interaction_fwd"]
    for k in need:
        check(launches.get(k, 0) > 0,
              f"{payload_dtype}: kernel {k} was not launched on the main "
              f"path (counts {launches})")
    hit = hits / max(1, hits + miss)
    print(f"serve {payload_dtype} on {torch.cuda.get_device_name(0)}: "
          f"{len(reqs)} requests x {args.batch} rows in {wall:.2f} s "
          f"through submit (per-group p50 {pct['p50']:.2f} ms, p99 "
          f"{pct['p99']:.2f} ms, queueing included); one request at a "
          f"time through predict: p50 {seq['p50']:.2f} ms; "
          f"L1 hit rate {hit:.4f}; max |p - plain| {err:.3g} "
          f"(bound {tol})"
          + ("" if trained_err is None else
             f"; max |p - Model.predict| {trained_err:.3g} (bound "
             f"{TRAIN_TOL})") + f"; launches {launches}")
    return launches, err


# ---------------------------------------------------------------------------
# phase 7: serve full-width minitron-4b: prefill, then KV-cache decode
# ---------------------------------------------------------------------------

def lm_embed_check(model, plain, params, tokens) -> str:
    """K1 against its plain version at the LM's shapes: each token table's
    lookup (ids masked to -1 where the other hybrid table holds the token)
    and the model's ``embed``, at the prefill's rows and at one decode
    step's. One id a row makes each result a copy, so both must agree bit
    for bit. Returns what was checked, for the prefill line."""
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    err, masked = 0.0, []
    for toks in (tokens, tokens[:, :1]):
        ids = toks.reshape(-1, 1).to(torch.int32)
        if model.embed_mode == "hybrid":
            hot = ids < model.hot_rows
            lookups = ((params["embed_hot"], torch.where(hot, ids, -1)),
                       (params["embed_cold"],
                        torch.where(hot, -1, ids - model.hot_rows)))
        else:
            lookups = ((params["embed"], ids),)
        for table, rows in lookups:
            got, want = k1.lookup_fwd(table, rows), k1.lookup_fwd_plain(table,
                                                                      rows)
            masked.append(float((rows < 0).float().mean()))
            err = max(err, (got - want).abs().max().item())
            check(torch.equal(got, want), f"K1 at table {tuple(table.shape)}, "
                  f"rows {tuple(rows.shape)}: max abs err {err} from its "
                  "plain version (bound: bit-exact)")
        got, want = model.embed(params, toks), plain.embed(params, toks)
        check(torch.equal(got, want), f"embed of tokens {tuple(toks.shape)}: "
              f"max abs err {(got - want).abs().max().item()} from the "
              "plain path (bound: bit-exact)")
    shapes = ", ".join(f"[{t.shape[0]},{t.shape[1]}]" for t, _ in lookups)
    share = " / ".join(f"{100 * m:.1f}%" for m in masked[:len(lookups)])
    return (f"K1 at tables {shapes} on rows [{tokens.numel()},1] ({share} "
            f"masked to -1) and [{tokens.shape[0]},1]: max abs err {err:.3g} "
            "(bound: bit-exact), embed bit-exact")


def lm_phase(args, dev, cfg):
    """Prefill and decode ``cfg`` at full width with random weights;
    returns the launch counts of the kernel path's run."""
    import numpy as np
    import torch
    from repro_torch.configs.base import LM_SHAPE_BY_NAME
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.lm.backbone import LMModel
    from repro_torch.tree import flatten, leaves

    full = LM_SHAPE_BY_NAME["prefill_32k"]
    b, s = args.lm_batch, args.lm_seq
    print(f"reduced: {cfg.name} prefill at batch {b} x seq {s} instead of "
          f"prefill_32k's {full.global_batch} x {full.seq_len}, so the first, "
          f"simple K7 fits the smoke's time; widths, {cfg.num_layers} layers "
          f"and the {cfg.vocab_size}-token vocabulary as published; random "
          f"weights (seed {args.seed})")
    model = LMModel(cfg, device=dev)
    plain = LMModel(cfg, device=dev, use_kernels=False)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in leaves(params))
    print(f"lm init: {n / 1e9:.3f} B f32 params ({n * 4 / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; embedding {model.embed_mode} "
          f"(hot {model.hot_rows} rows, cold {model.cold_rows})")
    rng = np.random.default_rng((args.seed, 7))
    tokens = torch.from_numpy(zipf_ids(rng, cfg.vocab_size, (b, s),
                                       a=1.2)).to(dev)
    batch = {"tokens": tokens}
    hot = float((tokens < model.hot_rows).float().mean())
    with torch.inference_mode():
        # K1 at this path's shapes, before the counted run
        k1_line = lm_embed_check(model, plain, params, tokens)
        # 1. prefill: one warm-up, then timed calls
        torch.cuda.synchronize()
        LAUNCHES.reset()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        first = LAUNCHES.snapshot()
        check(first.get("flash_fwd", 0) == cfg.num_layers
              and first.get("lookup_fwd", 0) == 2,
              f"prefill launches {first}: want K7 {cfg.num_layers} times "
              "and K1 twice")
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(args.lm_timed):
            t = time.perf_counter()
            model.prefill(params, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(tuple(logits.shape) == (b, model.logits_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite or of the "
              "wrong shape")
        want = plain.prefill(params, batch)
        err = (logits - want).abs().max().item()
        top = want.abs().max().item()
        check(err <= LM_LOGIT_TOL * top, f"prefill logits deviate {err} "
              f"from the plain path (bound {LM_LOGIT_TOL} x {top})")
        del want
        p50 = float(np.median(ms))
        print(f"prefill on {torch.cuda.get_device_name(0)}: {b} x {s} tokens "
              f"({100 * hot:.1f}% hot) p50 {p50:.2f} ms (min {min(ms):.2f}, "
              f"max {max(ms):.2f}) over {args.lm_timed} calls, "
              f"{b * s / p50 * 1e3:.0f} tokens/s; peak memory {peak:.2f} GiB; "
              f"max |logit - plain| {err:.4g} (bound {LM_LOGIT_TOL} x max "
              f"|logit| {top:.4g}); {k1_line}; launches per prefill {first}")
        profile("prefill", lambda: model.prefill(params, batch))

        # 2. decode: replay a prompt into the cache, hold the last step
        # against prefill of the same tokens, then greedy tokens
        p = args.prompt
        prompt = tokens[:, :p]
        cache = model.init_cache(b, s)
        for i in range(p):
            step, cache = model.decode_step(
                params, prompt[:, i:i + 1], cache,
                torch.full((b,), i, device=dev))
        full_logits = model.prefill(params, {"tokens": prompt})
        v = cfg.vocab_size
        got, ref = step[:, :v].cpu().numpy(), full_logits[:, :v].cpu().numpy()
        dmax = float(np.abs(got - ref).max())
        corr = float(np.corrcoef(got.ravel(), ref.ravel())[0, 1])
        check(np.allclose(got, ref, rtol=DECODE_TOL.rtol,
                          atol=DECODE_TOL.atol) and corr > DECODE_TOL.corr,
              f"decode after {p} tokens vs prefill: max abs {dmax}, "
              f"correlation {corr}")
        tok = step.argmax(-1, keepdim=True)
        ms = []
        for i in range(args.decode_steps):
            t = time.perf_counter()
            step, cache = model.decode_step(
                params, tok, cache, torch.full((b,), p + i, device=dev))
            tok = step.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(step).all()), "decode logits not finite")
        launches = LAUNCHES.snapshot()
        dp50 = float(np.median(ms))
        # what the per-call f32 -> bf16 cast of the weights moves in a
        # step: every dense weight and the head read as f32, written bf16
        cast = sum(t.numel() for k, t in flatten(params)
                   if not k.startswith("embed"))
        cast_gb = cast * 6 / 1e9
        print(f"decode on {torch.cuda.get_device_name(0)}: {p}-token prompt "
              f"replayed into a {s}-entry cache, last logits vs prefill max "
              f"abs {dmax:.4g}, correlation {corr:.6f} (bounds rtol "
              f"{DECODE_TOL.rtol}, atol {DECODE_TOL.atol}, corr > "
              f"{DECODE_TOL.corr}); {args.decode_steps} greedy steps at batch "
              f"{b}: step p50 {dp50:.2f} ms (min {min(ms):.2f}, max "
              f"{max(ms):.2f}), {b / dp50 * 1e3:.1f} tokens/s; the weights' "
              f"per-call cast moves {cast_gb:.1f} GB a step, "
              f"{cast_gb / HBM_BYTES_PER_S * 1e12:.2f} ms at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s")
        profile("decode step", lambda: model.decode_step(
            params, tok, cache, torch.full((b,), p + args.decode_steps,
                                           device=dev)))
    return launches


# ---------------------------------------------------------------------------
# phases 8-9: train full-width minitron-4b
# ---------------------------------------------------------------------------

def lm_tokens(args, cfg, dev, b, s):
    """A ``[b, s]`` bounded-Zipf(1.2) token batch (the draw of
    ``examples/lm_pretrain_smoke.py``) from the run's seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng((args.seed, 7))
    return torch.from_numpy(zipf_ids(rng, cfg.vocab_size, (b, s),
                                     a=1.2)).to(dev)


def lm_grad_check(args, dev, cfg):
    """The kernels (K1, K3, K7, K8) against the plain path on a copy of
    ``cfg`` cut to ``args.lm_check_layers`` layers at full width: the loss
    and, per parameter, the gradients' relative L2 error and cosine."""
    import dataclasses
    import torch
    from repro_torch.launch.train import lm_value_and_grad
    from repro_torch.models.lm.backbone import LMModel
    from repro_torch.tree import flatten
    small = dataclasses.replace(cfg, num_layers=args.lm_check_layers)
    model = LMModel(small, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    tokens = lm_tokens(args, cfg, dev, args.lm_train_batch, args.lm_seq)
    loss, grads = lm_value_and_grad(model, params, tokens)
    plain = LMModel(small, device=dev, use_kernels=False)
    ploss, pgrads = lm_value_and_grad(plain, params, tokens)
    dl = abs(float(loss) - float(ploss))
    tol = LM_GRAD_TOL
    check(dl <= tol.loss_rel * abs(float(ploss)), f"lm grad check: loss "
          f"{float(loss)} on the kernels, {float(ploss)} on the plain path")
    worst_rel, worst_cos, lines = 0.0, 1.0, []
    for (key, g), (_, pg) in zip(flatten(grads), flatten(pgrads)):
        g, pg = g.double().flatten(), pg.double().flatten()
        rel = ((g - pg).norm() / pg.norm()).item()
        cos = (g @ pg / (g.norm() * pg.norm())).item()
        check(rel <= tol.rel and cos >= tol.cos, f"lm grad check {key}: "
              f"relative error {rel}, cosine {cos} (bounds {tol.rel}, "
              f"{tol.cos})")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        lines.append(f"{key.split('_attn/')[-1]} {rel:.2e}/{cos:.6f}")
    print(f"lm grad check: {cfg.name} cut to {small.num_layers} layers at "
          f"full width, tokens [{tokens.shape[0]}, {tokens.shape[1]}]: loss "
          f"{float(loss):.6f} on the kernels, {float(ploss):.6f} on the plain "
          f"path (|diff| {dl:.3g}, bound {tol.loss_rel} relative); gradients "
          f"relative L2 error / cosine per parameter: {'; '.join(lines)}; "
          f"worst {worst_rel:.3g} / {worst_cos:.6f} (bounds {tol.rel}, "
          f"{tol.cos})")
    del grads, pgrads, params


def lm_k3_inputs(model, tokens) -> list:
    """K3's inputs at the LM's shapes: for the hot and the cold token table
    of hybrid ``model``, ``(table shape, rows [N, 1], dpooled [N, d])``,
    the batch's rows masked to -1 where the other table holds the token,
    and one random ``dpooled`` shared by both."""
    import torch
    ids = tokens.reshape(-1, 1).to(torch.int32)
    hot = ids < model.hot_rows
    g = torch.Generator(device=tokens.device).manual_seed(3)
    d = model.cfg.d_model
    dp = torch.randn((ids.shape[0], d), generator=g, device=tokens.device)
    return [((model.hot_rows, d), torch.where(hot, ids, -1), dp),
            ((model.cold_rows, d), torch.where(hot, -1, ids - model.hot_rows),
             dp)]


def lm_k3_check(model, tokens) -> str:
    """K3 against its plain versions at the LM's shapes
    (:func:`lm_k3_inputs`), twice (the bits must repeat), bit-exact to the
    chunked plain version (the kernel's order of adds) and within the f32
    sum-order bound of the summed magnitudes of the one-pass plain version;
    timed on both tables, the kernel and ``zeros`` + ``index_add_`` also
    as device time (CUDA graph replay)."""
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    parts = []
    for shape, rows, dp in lm_k3_inputs(model, tokens):
        got = k1.lookup_bwd(shape, rows, dp)
        check(torch.equal(got, k1.lookup_bwd(shape, rows, dp)),
              f"K3 at {shape}: two launches differ")
        check(torch.equal(got, k1.lookup_bwd_chunked_plain(shape, rows, dp)),
              f"K3 at {shape}: not bit-exact to its chunked plain version")
        want = k1.lookup_bwd_plain(shape, rows, dp)
        scale = k1.lookup_bwd_plain(shape, rows, dp.abs())
        err = (got - want).abs().max().item()
        check(bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()),
              f"K3 at {shape}: max abs err {err} above 1e-5 of the summed "
              "magnitudes")
        del got, want, scale
        keep = rows.view(-1) >= 0
        flat, src = rows.view(-1)[keep].long(), dp[keep]

        def lib():
            return torch.zeros(shape, device=dp.device).index_add_(0, flat,
                                                                   src)

        ms = time_ms(lambda: k1.lookup_bwd(shape, rows, dp), 10)
        dms = graph_ms(lambda: k1.lookup_bwd(shape, rows, dp), 5)
        pms = time_ms(lambda: k1.lookup_bwd_plain(shape, rows, dp), 10)
        lms, lgms = time_ms(lib, 10), graph_ms(lib, 5)
        # the ids, the dpooled rows of valid ids (a -1 row is never read)
        # and the dense output
        nkeep = int(keep.sum())
        bms, by = bound_ms(rows.numel() * 4 + nkeep * shape[1] * 4
                           + shape[0] * shape[1] * 4, nkeep * shape[1])
        runs = torch.unique(flat, return_counts=True)[1]
        masked = 100 * float((~keep).float().mean())
        parts.append(f"[{shape[0]},{shape[1]}] ({masked:.1f}% of rows -1, "
                     f"{runs.numel()} distinct ids, longest run "
                     f"{int(runs.max())}): device {dms:.4f} ms (CUDA graph "
                     f"replay; wrapper {ms:.4f} ms), bound {bms:.4f} ms by "
                     f"{by}, plain {pms:.4f} ms, library zeros + index_add_ "
                     f"device {lgms:.4f} ms (wrapper {lms:.4f} ms); max abs "
                     f"err {err:.3g}, bit-exact to the chunked plain version")
    return "K3 at " + "; ".join(parts)


def lm_train_phase(args, dev, cfg):
    """SGD steps of full-width ``cfg`` on one fixed batch; returns the
    launch counts of the counted run (warm-up and timed steps)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import LM_SHAPE_BY_NAME
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.train import lm_sgd_step_
    from repro_torch.models.lm.backbone import LMModel

    full = LM_SHAPE_BY_NAME["train_4k"]
    b, s = args.lm_train_batch, args.lm_seq
    print(f"reduced: {cfg.name} training at batch {b} x seq {s} instead of "
          f"train_4k's {full.global_batch} x {full.seq_len} (one card's "
          f"memory: f32 weights and gradients and every layer's "
          f"activations); widths, {cfg.num_layers} layers and the "
          f"{cfg.vocab_size}-token vocabulary as published; random weights "
          f"(seed {args.seed}); SGD at lr {args.lm_train_lr}, remat "
          f"'none'")
    model = LMModel(cfg, device=dev, remat="none")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    tokens = lm_tokens(args, cfg, dev, b, s)
    print(lm_k3_check(model, tokens))
    want = {"lookup_fwd": 2, "lookup_bwd": 2, "flash_fwd": cfg.num_layers,
            "flash_bwd": 2 * cfg.num_layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    losses, ms = [], []
    for i in range(args.lm_train_warm + args.lm_train_timed):
        before = LAUNCHES.snapshot()
        t = time.perf_counter()
        loss = lm_sgd_step_(model, params, tokens, args.lm_train_lr)
        losses.append(float(loss))           # the loss's copy to the host
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        after = LAUNCHES.snapshot()
        step = {k: after.get(k, 0) - before.get(k, 0) for k in want}
        check(step == want, f"lm train step {i}: launches {step}, want "
              f"{want}")
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(np.isfinite(losses).all()) and all(
        y < x for x, y in zip(losses, losses[1:])),
        f"lm train: the loss did not fall at every step: {losses}")
    timed = ms[args.lm_train_warm:]
    p50 = float(np.median(timed))
    print(f"lm train on {torch.cuda.get_device_name(0)}: {len(losses)} SGD "
          f"steps at {b} x {s} tokens ({args.lm_train_warm} warm-up): step "
          f"p50 {p50:.2f} ms (min {min(timed):.2f}, max {max(timed):.2f}), "
          f"{b * s / p50 * 1e3:.0f} tokens/s; loss "
          + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; peak memory {peak:.2f} GiB; launches per step {want}")
    profile("lm train step", lambda: lm_sgd_step_(model, params, tokens,
                                                  args.lm_train_lr))
    del params
    return launches


def recsys_phases(args, dev):
    """Phases 4-6; returns the launch counts of their main paths."""
    import torch
    bundle_dir = os.path.join(ROOT, "_smoke_bundle")
    shutil.rmtree(bundle_dir, ignore_errors=True)
    try:
        model, total = train_phase(args, dev)
        cfg, pdb, params = deploy_phase(args, model, bundle_dir)
        ps = os.path.join(bundle_dir, "ps.json")
        for pd in ("f32", "int8"):
            launches, _ = serve_phase(args, ps, cfg, pdb, params, dev, pd,
                                      trained=model)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
    finally:
        shutil.rmtree(bundle_dir, ignore_errors=True)
    del model, params, pdb
    torch.cuda.empty_cache()
    return total


def main() -> int:
    args = RUN
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing measured", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port is missing ({SRC}/repro_torch); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda", 0)

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_info['path']})")
    print(_build.build_info["log"].strip())

    # 3. kernels against their plain versions
    from repro_torch.models.recsys.layers import pin_f32_matmul
    pin_f32_matmul()
    kernels = kernel_phase(args, dev)

    torch.cuda.empty_cache()

    # 4-6. train, deploy, serve
    total = recsys_phases(args, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 7. LM serve
    from repro_torch.configs.registry import get_lm_config
    lm_cfg = get_lm_config(args.lm_arch)
    for k, n in lm_phase(args, dev, lm_cfg).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()

    # 8-9. LM train: the kernels against the plain path at depth 2, then
    # the full-width steps
    lm_grad_check(args, dev, lm_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in lm_train_phase(args, dev, lm_cfg).items():
        total[k] = total.get(k, 0) + n

    # 10. kernels line, then the device line last
    for name, rec in kernels.items():
        rec["launches"] = total.get(name, 0)
        check(rec["launches"] > 0, f"{name}: no launches on the main path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
