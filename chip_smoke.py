#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for sm_90a.
3. Kernels: time the launch floor (a one-element ``add_`` replayed from a
   CUDA graph), then launch K1 (pooled lookup) and K6 (dequantizing read)
   as the served batch runs them, one grouped launch for all 26 tables
   (f32 through K1, int8 through K6), K2 (dot interaction, also with the
   diagonal) and K5 (the cache's row read, f32 and f16) at the served
   shapes, K6's single-table row read (int8 and f16), K1 and K2 again at
   the training shapes and K1 at the LM's token tables,
   and K3 (the lookup's adjoint) and K4 (the interaction's) at the
   training shapes, and hold each against its plain PyTorch version on
   the card; time kernel, plain version and one library call with CUDA
   events. K1 and K3 again at full-vocabulary ``wdl-criteo``'s ``dist``
   group (D 16) and its wide twins (D 1), and the grouped served read (K1,
   K6) and the cache query (K5, K6) at D 16 and D 1: the shapes of DCN,
   WDL and DeepFM; then K1 and K3 at full-vocabulary ``neumf-criteo``'s
   largest ``deep`` group (D 64) and ``ctx`` group (D 8), the grouped
   served read of its three HPSes (13 x D 64, 9 x D 16, 4 x D 8) and the
   cache query at D 64 and D 8; K1 and K3 at phase 6d's ETC cache (the
   first training batch's slots offset onto the flattened [26 x 131072,
   128] cache); each time kept under its kernel's ``shapes`` in the JSON
   line. K7 (flash-attention forward) likewise at minitron-4b's
   prefill shape, recurrentgemma's local-attention prefill shape (q
   [32,4096,256], k/v [2,4096,256], window 2048, timed under ``shapes``
   with ``sdpa`` and the windowed mask as yardstick) and an odd f32
   length, and K8 (its backward) at minitron-4b's training shape,
   recurrentgemma's local attention at S 2500 and at its training shape
   (timed likewise) and an odd f32 length, with
   ``scaled_dot_product_attention``'s backward (forward + backward minus
   forward) as K8's yardstick; K7 and K8 also at granite-moe-3b-a800m's
   D 64 prefill (q [48,4096,64], k/v [16,4096,64]) and training (q/o/do
   [24,4096,64], k/v [8,4096,64]) shapes, held and timed under ``shapes``
   beside ``sdpa``; K7 and K8 also at seamless-m4t-large-v2's three
   shapes at D 64 (the encoder's non-causal [32,512,64], the decoder's
   causal [32,4096,64] at g = 1, and the cross-attention, q [32,4096,64]
   over the encoder's k/v [32,512,64]; K8 at batch 1, 16 heads) and
   pixtral-12b's (q [64,4096,128], k/v [16,4096,128]), each held and timed
   under ``shapes`` beside ``sdpa``; K7 and K8 with a causal query offset
   (``q_pos0``, a shard of sequence-parallel attention) on every route
   (bf16 at D 16, 32, 64, 96, 128 and 256, and f32) at the first shard of
   a split, an offset every tile divides, one none does and the last
   shard, the keys no query sees with zero ``dk`` / ``dv``, and both timed
   under ``shapes`` at minitron-4b's last shard of a model axis of 16 (q
   [48,256,128] at ``q_pos0`` 3840, k/v [16,4096,128]) beside ``sdpa``
   with the explicit causal mask (its backend named); K1 also at
   granite's and xLSTM's token tables. The mesh half of the striped L1 (``sharded_gather_rows`` /
   ``sharded_dequant_gather_rows``): 8 stripes of the 131,072-row cache
   over a cache mesh naming the card twice, one owner-mapped K5 (K6 for
   int8) launch an entry at the global slots, then the 26 served tables
   off a 2-stripe L1 there through ``hps._pooled_stack`` (one launch an
   entry for all of them); each bit-exact to the unstriped read and to the
   plain version, its launches counted and timed beside it (one card
   cannot show the copy between cards). The
   mesh path's own kernel calls at capped DLRM's ``dist`` group (5.76M
   rows) and the first training batch's ids: the all-to-all owner's
   gather ``ops.row_gather`` (K5, its adjoint K3 at one id a row) over the
   slots ``_bucket_by_owner`` makes at capacity factor 2 (half of them
   holes), and ``masked_range_lookup`` (K1, its adjoint K3) against shard
   1 of 4 of that table (the ids outside it holes); rows bit-exact, the
   table gradients bit-exact to K3's chunked plain version; each timed.
4. Train: declare full-width ``dlrm-criteo`` (26 tables at D=128, 13 dense
   features, bottom MLP 512-256-128, top MLP 1024-1024-512-256-1, bf16
   compute) through the port's graph API and ``fit()`` it at batch
   ``RUN.train_batch`` on the synthetic reader: warm-up steps, then timed
   steps; the loss must fall, K1 and K3 must launch once per embedding
   group and K2 and K4 once on every step, and the first steps with the
   plain versions must give the same losses. The one cut: each table's
   vocabulary is capped at ``RUN.vocab_cap``.
5. Deploy: ``Model.deploy()`` writes the trained model's serving bundle.
6. Serve: rebuild the server from ``ps.json`` on ``cuda`` and push
   batch-1024 Zipf requests through ``submit`` on the stream engine, once
   with an f32 and once with an int8 L1 payload; check the predictions
   against the plain path (pooled rows straight from the PDB, dense net
   with the plain ops) and, for both payloads, against the trained
   model's ``predict``; that the kernels' launch counters rose; and that
   one pooled read of the 26 tables is one K1 (f32) or one K6 (int8)
   launch.
6b. Online (DLRM's bundle, full width): rebuild with ``cache_shards=2``
   on the one card and serve the same requests as the unstriped server
   (f32 and int8): equal predictions and launches, the pooled read still
   one K1 / K6 launch and bit-exact, the cache query bit-exact, each
   kernel on the stripes' flat view bit-exact to its plain version. Then,
   striped f32 with a ``MessageBus`` and the bundle's ``refresh_budget``,
   closed-loop ``submit`` traffic while a ``Producer`` publishes new rows
   for the ``RUN.online_ids`` hottest ids of every table at versions
   1..``RUN.online_versions``: each version's publish -> applied and ->
   visible lag (``update_versions()`` reaches it and a probe batch's f32
   L1 rows equal the published rows bit for bit), ``predict`` p50 with and
   without the update stream, rows refreshed, the L1 hit rate, and
   ``refresh_step``'s host and device time with a full backlog; the served
   predictions against the plain path from the updated PDB
   (``SERVE_TOL["f32"]``); an int8 L1 on the same bus catches up through
   its own loop, its refreshed rows within half a quantization step of the
   published ones and its predictions within ``SERVE_TOL["int8"]``; then
   ``resize_caches`` to half the capacity keeps every hot row and serves
   within the same bound. Full-width WDL and NeuMF (phases 7 and 8) take
   one update version on their bundles the same way: each of their two or
   three HPSes applies every message (``updates_applied`` = messages x
   HPSes, as in the reference), and every HPS's f32 L1 reads the
   published rows bit for bit.
6c. The rest of the serving engine, on DLRM's bundle and that of
   ``dcn-criteo`` (6 cross layers, deep 1024-1024, a 1-unit combine; its
   vocabulary capped at ``RUN.vocab_cap``, trained through ``fit``
   (``RUN.recipe_timed_steps`` timed), deployed, rebuilt and served
   through ``predict`` with an f32 L1 first, as phase 7's capped
   recipes): (a) a burst of the ``RUN.requests`` measured requests after
   ``RUN.warmup`` through each of the ``stream``, ``sync`` and
   ``stage_sync`` engines (delivered p50 / p99, per-group p50, rows/s;
   the f32 predictions equal bit for bit); (b) ``set_admission(
   queue_depth=8, slo_ms=2 x the stream per-group p50)`` and a burst of
   64 requests, with deadline batching and the fixed-batch arm (every
   handle resolves; delivered + shed + expired = 64; the counts and the
   delivered p50 / p99); (c) ``deploy_ensemble([DLRM, DCN])`` with
   ``cache_budget`` 2 x ``RUN.cache_capacity``, rebuilt from its
   ``ps.json`` alone: each member's predictions equal its single-model
   server's bit for bit, one K1 launch a batch, each member's closed-loop
   p50 / p99 against its single-model server's and its L1 hit rate; then
   traffic to DLRM alone and ``rebalance_now()`` (its wall time, the
   capacities before and after; predictions after the resize equal those
   before bit for bit); (d) the hot-path twin
   (``repro_torch.analysis.HotPathMonitor``) and
   ``torch.cuda.set_sync_debug_mode("warn")`` over 16 closed-loop stream
   groups after warm-up, DLRM alone and the ensemble's DLRM member with
   admission on: one sync a group in both, no fresh kernel build.
6d. ETC and online training, on capped ``dlrm-criteo``: (i) ``fit()``
   with ``Solver(etc=ETCParams(cache_rows=RUN.etc_cache_rows, ps="staged",
   passes=RUN.etc_passes))`` from phase 4's initial weights over its
   batches: every step one K1 and one K3 launch over the flattened cache
   and one K2 and one K4, no eviction, the losses within ``TRAIN_TOL`` of
   phase 4's and of the plain versions' first steps; the step's reader,
   host ``prepare`` and device step against phase 4's step, and one
   profiled ETC step; (ii) an evicting fit (``RUN.etc_evict_rows`` rows a
   table, ``ps="cached"`` under ``_smoke_bundle/``, one pass): it evicts,
   its loss falls, after the flush each resident row of the PS equals its
   cache row bit for bit, and the pulls, evictions, ``prepare`` ms and
   flush + ``fsync`` seconds; (iii) phase 4's trained model deployed live
   (external ``VolatileDB`` + ``MessageBus``, f32 L1, stream engine) while
   an ``OnlineTrainer`` with an ``UpdatePublisher`` trains
   ``RUN.etc_passes`` passes of ``RUN.etc_online_steps`` steps: each
   version's rows and publish -> visible lag (``wait_visible``), one host
   sync a served group by the hot-path twin while the consumer applies it,
   and the probe from its baseline onto the oracle (the trained rows under
   the deployed dense net) within ``SERVE_TOL["f32"]``.
6e. The launchers, their ``main(argv)`` in process: (a)
   ``launch.loadtest`` on 6c's ensemble bundle (DLRM + DCN): requests of
   256 rows, ``--max-coalesce 4`` (max_batch 1024), Poisson arrivals, Zipf
   1.2, a 3:1 mix, ``queue_depth`` 64, an SLO of 100 ms; a steady phase at
   10% of C (the rows/s of 6c's closed-loop stream run) for 5 s, then 4 x
   C for 2 s, with the launcher's smoke assertions (a p99, sheds under
   overload, nothing lost in either phase, the artifact written, each
   read from the artifact's counts; a shed at steady load is printed with
   its counts as ROADMAP queue 3's open fault, not failed on: the steady
   rate, a share of C fixed before the first run, is above the capacity
   for this traffic, ``PERF.md`` §7.9); per phase and member the delivered,
   shed, expired and lost counts, client p50 / p99 / p999, the peak
   delivered qps and the largest submit lag (``LOADTEST``); (b) DLRM alone
   with the hot set drifting 2% of the vocabulary a second, its steady
   phase recorded to a trace and driven from the replay (the same
   scheduled count), reported only; (c) ``launch.serve --sanitize`` on
   DLRM's single-model bundle, 16 requests of 1024 rows, f32 then int8
   (full batches, one host sync a group, no kernel-library load, int8
   within 0.1 of the f32 rebuild); (d) ``launch.train --arch wdl-criteo``
   at full width and vocabulary, batch ``RUN.train_batch``: 6 steps with
   ``--ckpt-dir`` / ``--ckpt-interval 6`` under ``_smoke_bundle/``, then
   ``--steps 10`` resumes at step 6, and an uninterrupted 10-step run gives
   the losses of steps 6-9 the resumed ones must match within
   ``RESUME_TOL``; step p50, samples/s, checkpoint write seconds, K1 / K3
   launches a step.
7. The other recipes: phases 4-6 for full-width ``wdl-criteo`` with no
   cut (26 tables at D 16 over 33,762,590 rows and their dim-1 wide twins,
   deep MLP 1024-1024-1), K1 and K3 launched for both collections every
   step, served through two HPSes (one pooled read of each is one
   launch); then ``deepfm-criteo`` (deep 400-400-400-1, FM), its
   vocabulary capped at ``RUN.vocab_cap``, through ``fit``
   (``RUN.recipe_timed_steps`` timed), deploy, rebuild and ``predict``
   with an f32 L1, held to the same bounds.
8. The graph recipes (``model="graph"``): phases 4-6 for full-width
   ``neumf-criteo`` with no cut (three embedding groups: 13 ``deep``
   tables at D 64 over 20,802,983 rows, 9 ``gmf`` at D 16 over
   12,530,733, 4 ``ctx`` at D 8 over 428,874; towers 256-64, head 64),
   K1 and K3 once per planner group of all three collections every step,
   served through three HPSes, one a group (one pooled read of each is one
   launch); then ``twotower-criteo`` (26 tables at D 64, towers 256-64,
   head 64) and ``crossdeep-criteo`` (D 16, 4 cross layers, deep
   1024-256), each vocabulary capped at ``RUN.vocab_cap``, as DCN.
8b. Mesh: full-width ``dlrm-criteo`` (phase 4's cap) on a
   ``torch.distributed`` mesh of ``torch.cuda.device_count()`` ranks over
   NCCL: one card, one rank in process on a ``FileStore`` and a (1, 1)
   mesh; more cards, one spawned process a card on a ``(world // 2, 2)``
   or ``(1, world)`` mesh. From phase 4's weights and batches: gspmd fits
   with ``comm`` "allgather_rs" and "all_to_all" (each within
   ``TRAIN_TOL`` of phase 4's losses), manual with the bf16 gradient
   all-reduce (within ``MANUAL_TOL``), and the 26 tables localized, each
   vocabulary capped at ``RUN.loc_vocab`` rows (sparse SGD, against the
   same config's one-device fit within ``TRAIN_TOL``; where the table
   count does not divide over the mesh, ``compile`` must refuse it); each
   model built through the graph API (``recipe_graph``, then
   ``Model.compile`` on the mesh). K1 / K3 (all-gather path) and K5
   / K3 (all-to-all path) launches counted inside the mesh steps; step p50
   of each against phase 4's. The gspmd model is deployed with
   ``cache_shards`` 2, rebuilt from ``ps.json`` over
   ``make_cache_mesh(2)`` (one device on one card) and over a cache mesh
   naming the card twice, and held against the one-device server and the
   trained model's ``predict``, each server's ``predict`` p50 timed over
   ``RUN.requests`` requests; then the ``mp_train_smoke`` twin on the
   same mesh shape. The group is torn down after it.
8c. The LM on the mesh (run after phase 15, whose steps it is held
   against): a one-rank NCCL group on a (1, 1) mesh (on any card count),
   full-depth ``granite-moe-3b-a800m`` (its ``sharded`` token table
   striped over ``"model"``, the head and the loss vocab-parallel, its 40
   experts over ``"model"``) and phase 14's depth-5 full-width
   ``recurrentgemma-9b`` (a ``hybrid`` tied 256,000-token table: the
   cold rows striped, the loss's log-sum-exp over ``"model"``) through
   ``LMModel(cfg, mesh)`` from phases 15's and 14's weights, batch and
   steps: losses within ``TRAIN_TOL`` of the one-device steps, K1 / K3 /
   K7 / K8 launches a step equal to theirs, step p50 against theirs; then
   ``launch.train --arch granite-moe-3b-a800m --mesh 1x1`` under the same
   group (two steps). The group is torn down after it.
8d. Sequence-parallel attention, replayed shard by shard on the card:
   ``LMModel``'s rule picks ``"seq"`` for minitron-4b and
   granite-moe-3b-a800m on a model axis of 16 (checked on a shape-only
   mesh); each rank's part of ``seqpar_attention``
   (``transformer.seqpar_shard``: its 256 query rows against the whole
   K/V through K7 / K8 at ``q_pos0 = 256 i``) runs for i = 0..15 in turn
   at minitron's prefill (q [2,4096,24,128], forward) and training (q
   [1,4096,24,128], forward and backward) shapes and at granite's D 64
   ones; the outputs concatenated against one whole-sequence K7 launch
   (bit-equality reported, ``ATTN_TOL`` held) and the gradients (``dq``
   concatenated, ``dk`` / ``dv`` summed over the shards in f32) against
   one K8 call (``ref.BF16_GRAD_RULE``); the shards' launches count as the
   path's, and the 16 shards' forward is timed beside the whole launch.
9. LM serve: full-width ``minitron-4b`` (hybrid token embedding, random
   weights from a seed) prefills a 2 x 4096 Zipf(1.2) batch through K1 and
   K7, held against the plain path (K1 first alone, bit-exact, on both
   token tables at the prefill's and a decode step's rows); then a
   64-token prompt is replayed through ``decode_step`` into a 4096-entry
   KV cache, held against the prefill of the same tokens, and 32 greedy
   tokens are decoded. The cut:
   ``prefill_32k``'s batch 32 x 32768 becomes 2 x 4096.
10. LM train, checked: a depth-2 copy of ``minitron-4b`` at full width
   takes one gradient on the kernels (K1, K3, K7, K8) and on the plain
   path; the loss and every parameter's gradient must agree.
11. LM train: full-width ``minitron-4b`` (hybrid token table, seed-0
   weights, bf16 compute) takes SGD steps on one 1 x 4096 Zipf(1.2) batch
   through K1 and K7 forward and K8 and K3 backward (K3 first alone at the
   LM's shapes), one warm-up and timed steps; the loss must fall at every
   step. The cut: ``train_4k``'s batch 256 x 4096 becomes 1 x 4096.
12. Remat: full-width ``minitron-4b`` takes one gradient at 1 x 4096
   under each of ``remat`` "none", "full", "dots" and "group" from one set
   of weights: each policy's peak memory and gradient time, then every
   parameter's gradient (and the loss) held against "none"'s within
   ``REMAT_TOL``.
13. recurrentgemma serve: full-width, full-depth ``recurrentgemma-9b``
   (38 layers: 12 x (rglru, rglru, local_attn) + 2 rglru, d 4096, hybrid
   token table, seed-0 f32 weights, bf16 compute) as phase 9: a 2 x 4096
   prefill through K1 and the windowed K7 (12 launches, window 2048)
   against the plain path, a 64-token decode replay into a 4096-token
   cache (rolling 2048-entry caches for the local layers, the RG-LRU
   state for the recurrent ones) against the prefill, 32 greedy tokens.
   At 38 layers the bf16 replay is held by its correlation and an f32
   replay on the plain path; full-width copies at 5 and 12 layers replay
   in bf16 on the kernels and on the plain path, the 5-layer one held to
   the reference's bound (``DECODE_TOL``, set for 5 layers), and the
   drift is printed by depth.
14. recurrentgemma train: a full-width copy at depth 5 (one pattern
   period and the 2-layer tail) as phases 10 and 11: one gradient on the
   kernels (K1, K3, K7, K8) against the plain path, then SGD steps on one
   1 x 4096 batch, the loss falling at every step. The cut: all 38 layers'
   f32 weights and gradients take about 75 GB.
15. granite: full-width, full-depth ``granite-moe-3b-a800m`` (32 layers,
   40 experts, top 8, Hq 24, Hkv 8, D 64, one ``sharded`` token table,
   seed-0 f32 weights, bf16 compute) as phase 9: a 2 x 4096 prefill
   through K1 and K7 (32 launches) against the plain path, with the
   assignments the published capacity factor 1.25 drops and the tokens
   routed to other experts on the kernels than on the plain path; the
   decode replay on its copy whose capacity factor drops nothing (at the
   published one a decode step routes only the batch's 2 tokens, and
   drops what prefill keeps, by the reference's own semantics), held as
   recurrentgemma's at full depth (correlation, and an f32 replay on the
   plain path) and at 5 layers to the reference's bf16 bound on both
   paths, 32 greedy tokens at the published factor and the assignments a
   decode step drops; then phase 10's check at depth 2 and phase 11's SGD
   steps at full depth (K1 1, K3 1, K7 32, K8 64 launches a step).
16. xLSTM: full-width, full-depth ``xlstm-125m`` (12 layers of mLSTM and
   sLSTM, d 768, 4 heads) as phases 9-11 at sequence ``RUN.xlstm_seq``
   (the recurrences run as Python loops over the time steps, about 270
   launches a token forward): prefill through K1 against the plain path,
   the decode replay against prefill, greedy tokens, a gradient of a
   depth-2 copy (one mLSTM and one sLSTM layer) against the plain path,
   SGD steps at full depth (K1 and K3 once a step); its profiled prefill
   and step run ``RUN.xlstm_profile_seq`` tokens.
17. seamless: full-width, full-depth ``seamless-m4t-large-v2`` (24
   encoder and 24 decoder layers, d 1024, 16 MHA heads at D 64, the
   256,206-token hybrid tied table): a 2 x 4096 prefill with frames [2,
   512, 1024] bf16 (``max(S // 8, 16)``, the reference's) through the
   encoder and the decoder, K7 72 times (24 encoder, 24 causal
   self-attention, 24 cross-attention with the encoder's 512 keys),
   against the plain path; a 64-token prompt replayed through decode on
   the kernels and on the plain path (decode never sees the frames, so
   prefill is no yardstick), the cross cache left as it came, 32 greedy
   tokens; a 2 + 2-layer full-width copy's gradient on the kernels
   against the plain path; SGD steps at full depth on 1 x 4096 with
   frames [1, 512, 1024], the loss falling at every step (K7 72, K8 144
   launches a step).
18. pixtral: full-width, full-depth ``pixtral-12b`` (40 layers, d 5120,
   Hq 32, Hkv 8, D 128): a prefill of 2 x 4096 positions (1024 random bf16
   patch positions ahead of 3072 text tokens, as ``repro/launch/specs.py``
   splits them) against the plain path, the decode replay on both paths
   and 32 greedy tokens as 17's; SGD steps on a full-width copy cut to
   ``RUN.pixtral_train_layers`` layers (all 40 layers' f32 weights and
   gradients take about 98 GB), the loss on the text positions only.
19. The twins of ``examples/`` (``repro_torch.examples.*``), each once
   on the card at its smallest setting with its own checks.
20. One JSON line of per-kernel numbers, then the device line last.

Needs ``torch.cuda.is_available()`` and the package under ``src/``; with
either missing it prints no result and exits 2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
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
#: a resumed run's losses against an uninterrupted run's, the same steps
#: on the same card: the restored parameters and optimizer state are the
#: saved bits and K1 / K3 are deterministic, so only a lost or corrupted
#: state moves them
RESUME_TOL = 1e-6
#: the remat policies' gradients against "none"'s, per parameter, relative
#: L2 (and their losses, relative): the recomputed layers run the same
#: deterministic kernels on the same inputs, so only a wrong recompute
#: moves the gradients (the forward pass, and so the loss, is the same
#: under every policy)
REMAT_TOL = 1e-6
#: the run: vocabulary cap per table (the one cut), L1 rows per table,
#: request batch, warm-up and measured requests, seed; training batch,
#: warm-up and timed steps, steps on the plain versions, learning rate;
#: the attention kernels' sequences (timed, odd, D 64 edges, K8's local);
#: the LM phases' archs, sequences, timed calls and cut depths (xLSTM's
#: sequence and timed calls cut for time: its recurrences run as Python
#: loops, about 270 launches a token forward, and its profiled calls run
#: ``xlstm_profile_seq`` tokens: the profiler takes ~0.4 ms a device event
#: to collect, minutes for a full call);
#: DCN's and DeepFM's timed steps and learning rate (at 1e-3 the first
#: AdamW step lifts DCN's loss from 0.70 to 0.94, and six steps do not
#: bring it back under the first); the online phase's hottest ids a table
#: that each update rewrites, update versions, and requests served before
#: the first update; phase 6d's ETC cache rows a table, passes, the
#: evicting run's cache rows, and the freshness loop's steps a pass; the
#: mesh phases' L1 stripes and localized vocabulary cap; phase 8d's model
#: axis (how many sequence-parallel shards it replays)
RUN = types.SimpleNamespace(vocab_cap=1 << 20, cache_capacity=131072,
                            batch=1024, warmup=4, requests=16, seed=0,
                            train_batch=4096, warm_steps=2, timed_steps=8,
                            plain_steps=3, lr=1e-3, recipe_timed_steps=4,
                            recipe_lr=3e-4,
                            attn_seq=4096, attn_odd_seq=1000,
                            attn_edge_seq=700,
                            lm_arch="minitron-4b", lm_batch=2, lm_seq=4096,
                            lm_timed=5, prompt=64, decode_steps=32,
                            attn_bwd_local_seq=2500, lm_train_batch=1,
                            lm_train_warm=1, lm_train_timed=5,
                            lm_train_lr=3e-4,
                            lm_check_layers=2, rg_arch="recurrentgemma-9b",
                            rg_train_layers=5,
                            rg_decode_depths=(5, 12, 24),
                            granite_arch="granite-moe-3b-a800m",
                            xlstm_arch="xlstm-125m", xlstm_seq=768,
                            xlstm_timed=2, xlstm_train_timed=2,
                            xlstm_profile_seq=32,
                            seamless_arch="seamless-m4t-large-v2",
                            pixtral_arch="pixtral-12b",
                            pixtral_train_layers=8, online_ids=4096,
                            online_versions=4, online_quiet=48,
                            etc_cache_rows=131072, etc_passes=2,
                            etc_evict_rows=8192, etc_online_steps=4,
                            mesh_stripes=8, loc_vocab=1 << 16,
                            seq_shards=16)
#: manual mode's bf16 gradient all-reduce against phase 4's f32 run (the
#: reference's bar, ``tests/test_mp_train.py:65-85``)
MANUAL_TOL = 5e-3
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
#: the share (%) of granite-moe-3b-a800m's prefill routing decisions
#: (tokens x layers) that went to other experts on the kernels than on the
#: plain path when K7 ran D 64 on mma.sync: exact bf16 ties in the router
#: logits flip on K7's bf16 p; printed beside this run's share, not held
ROUTING_FLIPS_MMA_SYNC = 8.9
#: the depth-2 full-width model on the kernels against the plain path:
#: relative loss, and per parameter the relative L2 error and the cosine of
#: the gradients (bf16 compute: K7 and K8 round p and ds to bf16, the plain
#: versions do not; a narrow 2-layer emulation on the CPU gave 8e-5 of the
#: loss, 8.1e-3 and 0.99996 at worst)
LM_GRAD_TOL = types.SimpleNamespace(loss_rel=1e-3, rel=5e-2, cos=0.999)
#: decode against prefill: the reference's bound for the same check
#: (tests/test_models_smoke.py::test_decode_matches_prefill, a 5-layer
#: model); holds minitron at full depth and the full-width 5-layer copies
#: of recurrentgemma and granite on both paths (``decode_depths``). At
#: granite's full 32 layers bf16 routing ties make it a coin flip (seeds
#: 0-3 on the card: the plain path misses it at seed 0, K7 on mma.sync at
#: seed 3), so that replay is held as recurrentgemma's 38-layer one is
DECODE_TOL = types.SimpleNamespace(rtol=0.1, atol=0.15, corr=0.99)
#: decode against prefill in f32 on the plain path, relative to the largest
#: |logit|: the same function summed in another order. Checks the decode
#: state of a model deeper than the bf16 bound above was set for (5
#: layers): bf16 rounding drifts with depth, in the reference's decode as
#: in the port's
DECODE_F32_TOL = 1e-3


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


def launch_floor_call(dev):
    """The smallest launch the card runs, a one-element ``add_``: replayed
    from a CUDA graph (:func:`graph_ms`), what any kernel that moves almost
    nothing takes."""
    import torch
    t = torch.zeros(1, device=dev)
    return lambda: t.add_(1.0)


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

def recipe_config(args, arch: str, capped: bool):
    """A recipe at full width: a paper recipe of the registry, or a graph
    recipe as its module's ``build_model()`` lowers it; with ``capped``
    each vocabulary (of every group) is cut to ``args.vocab_cap`` rows."""
    import dataclasses
    import importlib
    from repro_torch.configs.registry import RECSYS_ARCHS, RECSYS_RECIPES
    if arch in RECSYS_ARCHS:
        cfg = RECSYS_ARCHS[arch]
    else:
        cfg = importlib.import_module(RECSYS_RECIPES[arch]).build_model() \
            .to_recsys_config()
    if not capped:
        return cfg

    def cap(tables):
        return tuple(dataclasses.replace(
            t, vocab_size=min(t.vocab_size, args.vocab_cap)) for t in tables)

    return dataclasses.replace(cfg, tables=cap(cfg.tables), extra_groups=tuple(
        dataclasses.replace(g, tables=cap(g.tables))
        for g in cfg.extra_groups))


def capped_config(args):
    """Full-width ``dlrm-criteo`` with each vocabulary capped (the cut)."""
    return recipe_config(args, "dlrm-criteo", capped=True)


def training_rows(args, dev, cfg=None, wide: bool = False, group=None):
    """K1's and K3's inputs as the training run gives them: the embedding
    groups the planner makes for ``cfg``'s primary tables (capped
    ``dlrm-criteo`` unless given; with ``wide``, the one ``dp`` group of
    their dim-1 twins; with ``group``, the tables of that extra group),
    ``{key: (group rows, that group's row ids of the first training batch,
    [B * T_g, 1])}``."""
    from repro_torch.configs.base import SINGLE_DEVICE
    from repro_torch.core.embedding.collection import EmbeddingCollection
    from repro_torch.core.embedding.planner import resolve_strategies
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.models.recsys.model import wide_tables
    from repro_torch.train.trainer import put_batch
    cfg = cfg or capped_config(args)
    lo, tables = 0, cfg.tables
    if group is not None:                # its columns follow the earlier
        lo = len(cfg.tables)             # groups' in ``cat``
        for g in cfg.extra_groups:
            if g.name == group:
                tables = g.tables
                break
            lo += len(g.tables)
    tables = wide_tables(cfg) if wide else resolve_strategies(
        tables, SINGLE_DEVICE, args.train_batch)
    coll = EmbeddingCollection(tables, device=dev)
    cat = put_batch(SyntheticCTR(cfg, args.train_batch,
                                 seed=args.seed).batch(0), dev)["cat"]
    cat = cat[:, lo:lo + len(tables)]
    return {k: (coll.groups[k].total_rows, r.reshape(-1, r.shape[-1]))
            for k, r in coll.group_rows(cat).items()}


def wdl_training_rows(args, dev) -> dict:
    """K1's and K3's inputs at full-vocabulary ``wdl-criteo``'s largest
    deep group (``dist``, D 16) and at its wide twins (``wide``, D 1):
    ``{label: (rows of the group, row ids [B * T_g, 1], D)}``."""
    cfg = recipe_config(args, "wdl-criteo", capped=False)
    deep = training_rows(args, dev, cfg)
    wide = training_rows(args, dev, cfg, wide=True)
    big = max(deep, key=lambda k: deep[k][0])
    return {f"wdl {big}": (*deep[big], cfg.embedding_dim),
            "wdl wide": (*wide["dp"], 1)}


def neumf_training_rows(args, dev) -> dict:
    """K1's and K3's inputs at full-vocabulary ``neumf-criteo``'s largest
    group of the primary collection (``deep``, D 64) and of its ``ctx``
    group (D 8), in :func:`wdl_training_rows`' form."""
    cfg = recipe_config(args, "neumf-criteo", capped=False)
    out = {}
    for name, dim, group in (("deep", cfg.embedding_dim, None),
                             ("ctx", None, "ctx")):
        rows = training_rows(args, dev, cfg, group=group)
        big = max(rows, key=lambda k: rows[k][0])
        dim = dim or next(g.dim for g in cfg.extra_groups if g.name == group)
        out[f"neumf {name} {big}"] = (*rows[big], dim)
    return out


def etc_training_rows(args, dev) -> dict:
    """K1's and K3's inputs as phase 6d's ETC step gives them: the first
    training batch of capped ``dlrm-criteo`` staged by a fresh cache of
    ``args.etc_cache_rows`` rows a table (``prepare``: its slots), each
    table's slots offset onto the flattened ``[T * C, D]`` cache, as
    ``cached_lookup`` reads it, in :func:`wdl_training_rows`' form."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.core.etc.cache import EmbeddingTrainingCache
    from repro_torch.core.etc.parameter_server import StagedPS
    from repro_torch.data.synthetic import SyntheticCTR
    cfg = capped_config(args)
    with warnings.catch_warnings():      # the small tables fit whole
        warnings.simplefilter("ignore", RuntimeWarning)
        etc = EmbeddingTrainingCache(cfg.tables, args.etc_cache_rows,
                                     StagedPS(cfg.tables, seed=args.seed),
                                     device=dev)
    cat = SyntheticCTR(cfg, args.train_batch, seed=args.seed).batch(0)["cat"]
    params, rem = etc.prepare(etc.init_params(), cat)
    del params
    t, c = len(cfg.tables), etc.capacity
    rows = np.where(rem >= 0, rem + np.arange(t).reshape(1, t, 1) * c, -1)
    rows = torch.from_numpy(rows.reshape(-1, rem.shape[-1]).astype(np.int32))
    return {"etc cache": (t * c, rows.to(dev), cfg.embedding_dim)}


#: batches of slots a served-read timing turns through: each call of a
#: replayed CUDA graph reads rows the last 19 did not (20 x 13.6 MB of f32
#: rows, more than the card's 50 MB L2), as a new batch would
SLOT_SETS = 20


def served_inputs(args, dev, payload_dtype: str, sets: int = 1,
                  d: int = 128, tables: int = 26) -> tuple:
    """K1's (``"f32"``) or K6's (``"int8"``) inputs as a served batch gives
    them: for each of ``tables`` tables (an HPS's: the 26 Criteo tables,
    or NeuMF's 13, 9 or 4) an L1 payload ``[cache rows, d]`` (int8 with
    per-row scales, or f32; ``d`` 128 for ``dlrm-criteo``, 16 for the
    other recipes' deep tables and 1 for their wide twins, 64, 16 and 8 for
    NeuMF's groups), and ``sets`` batches of one ``[batch, 1]`` block of
    uniform slots a table, made on ``dev`` from the run's seed ->
    ``(payloads as (payload, scales) pairs, [slot blocks of batch 0,
    ...])``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    c, b = args.cache_capacity, args.batch
    pays = []
    for _ in range(tables):
        if payload_dtype == "int8":
            p = torch.randint(-127, 128, (c, d), generator=g, device=dev,
                              dtype=torch.int8)
            sc = torch.rand((c,), generator=g, device=dev) * 0.02 + 1e-3
        else:
            p, sc = torch.randn((c, d), generator=g, device=dev) * 0.3, None
        pays.append((p, sc))
    return pays, [[torch.randint(0, c, (b, 1), generator=g, device=dev,
                                 dtype=torch.int32) for _ in pays]
                  for _ in range(sets)]


def rotating(fn, inputs):
    """A call of ``fn`` on each of ``inputs`` in turn, one a call."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


def lm_k1_inputs(args, dev, arch=None) -> list:
    """K1's inputs at an LM's token tables as a training step of
    ``args.lm_train_batch`` x ``args.lm_seq`` tokens gives them: ``(name,
    table, rows [N, 1])`` for each token table of ``arch`` (default
    ``args.lm_arch``: ``lm_hot`` and ``lm_cold``, its hybrid tables; an
    arch with one table: ``<arch>``), random f32 tables, rows of
    :func:`lm_k3_inputs`."""
    import torch
    from repro_torch.configs.registry import get_lm_config
    from repro_torch.models.lm.backbone import LMModel
    cfg = get_lm_config(arch or args.lm_arch)
    tokens = lm_tokens(args, cfg, dev, args.lm_train_batch, args.lm_seq)
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    model = LMModel(cfg, device=dev)
    names = (("lm_hot", "lm_cold") if model.embed_mode == "hybrid"
             else (cfg.name,))
    return [(name, torch.randn(shape, generator=g, device=dev), rows)
            for name, (shape, rows, _) in zip(
                names, lm_k3_inputs(model, tokens))]


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
    sc16 = (torch.rand((C,), generator=g) + 0.5).to(dev)
    x = torch.cat([torch.randn((B, 1, D), generator=g),
                   torch.randn((B, F - 1, D), generator=g) * 0.3], 1)
    x = x.to(torch.bfloat16).float().to(dev).contiguous()
    li, lj = torch.tril_indices(F, F, -1, device=dev)
    out, device, device_lib, shapes = {}, {}, {}, {}
    floor = graph_ms(launch_floor_call(dev), 100)
    print(f"launch floor: {floor:.4f} ms device (a one-element add_, CUDA "
          "graph replay)")

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
        if lib is not None:
            device_lib[name] = graph_ms(lib, reps)
        return out[name]

    def shape_line(name, shape, fn, plain, lib, nbytes, flops, reps=20,
                   err=None, flops_per_s=F32_FLOPS, lib_minus=None,
                   iters=20):
        """A kernel's times at another main-path shape: printed, and kept
        under the kernel's ``shapes`` in the JSON line. ``lib_minus``'s
        time is taken off the library call's (a backward's yardstick is
        forward + backward minus the forward, timed on the host's events
        only: autograd is not captured in a graph)."""
        bms, by = bound_ms(nbytes, flops, flops_per_s)
        dms = graph_ms(fn, reps)
        if lib_minus is None:
            lib_ms, lib_dms = time_ms(lib, iters), graph_ms(lib, reps)
        else:
            lib_ms = time_ms(lib, iters) - time_ms(lib_minus, iters)
            lib_dms = None
        rec = {"shape": shape, "ms": time_ms(fn, iters), "device_ms": dms,
               "bound_ms": bms, "bound_by": by,
               "plain_ms": time_ms(plain, iters), "library_ms": lib_ms,
               "library_device_ms": lib_dms, "max_abs_err": err}
        shapes.setdefault(name, []).append(rec)
        print(f"kernel {name} at {shape}: device {dms:.4f} ms (CUDA graph "
              f"replay, {100 * bms / dms:.1f}% of the bound, "
              f"{100 * max(bms, floor) / dms:.1f}% of the larger of bound "
              f"and launch floor), wrapper "
              f"{rec['ms']:.4f} ms, bound {bms:.4f} ms by {by}, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              "ms" + ("" if lib_dms is None else
                      f" (device {lib_dms:.4f} ms)"))

    def k1_line(label, table, rows, reps=20):
        # the bound reads each distinct valid row once (a Zipf batch
        # repeats its head ids)
        keep = rows >= 0
        n = rows.shape[0]
        distinct = int(torch.unique(rows[keep]).numel())
        shape_line("lookup_fwd", f"{label}: rows [{n},{rows.shape[1]}] "
                   f"({100 * float((~keep).float().mean()):.1f}% -1, "
                   f"{distinct} distinct ids) into "
                   f"[{table.shape[0]},{table.shape[1]}]",
                   lambda: k1.lookup_fwd(table, rows),
                   lambda: k1.lookup_fwd_plain(table, rows),
                   lambda: (table.index_select(0, rows.view(-1).clamp_min(0))
                            .view(n, rows.shape[1], -1) * keep[..., None])
                   .sum(1),
                   rows.numel() * 4 + distinct * table.shape[1] * 4
                   + n * table.shape[1] * 4,
                   int(keep.sum()) * table.shape[1], reps)

    # K1 and K6 as a served batch runs them: one grouped read of all the
    # tables, f32 through K1 and int8 through K6; the yardstick is each
    # table's index_select (+ the scale) + sum, then torch.stack
    for pd in ("f32", "int8"):
        served_record(args, dev, pd, record)
    # K1 off the served shape: bf16 table, H=3 with pads and duplicates
    multi = torch.randint(-1, 64, (B, 3), generator=g,
                          dtype=torch.int32).to(dev)
    tb = table.to(torch.bfloat16)
    got, want = k1.lookup_fwd(tb, multi), k1.lookup_fwd_plain(tb, multi)
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          "lookup_fwd bf16 H=3: above 1e-6")

    # K5: the L1 row read of DeviceEmbeddingCache.query (f32 timed; f16
    # checked), bit-exact with holes
    holes = slots.clone()
    holes[::7] = -1
    h16 = rows_f32.to(torch.float16).to(dev)
    check(torch.equal(k56.gather_rows(h16, holes),
                      k56.gather_rows_plain(h16, holes)),
          "gather_rows float16: not bit-exact")
    record("gather_rows", "src/repro_torch/csrc/hps_gather.cu",
           "src/repro/kernels/hps_gather.py:54",
           k56.gather_rows(table, holes), k56.gather_rows_plain(table, holes),
           True, 0.0, lambda: k56.gather_rows(table, slots),
           lambda: k56.gather_rows_plain(table, slots),
           lambda: table.index_select(0, slots),
           B * D * 4 + B * 4 + B * D * 4, 0)

    # K6's single-table row read, the cache query's (int8 and f16)
    for pay, sc in ((q8, sc8), (h16, sc16)):
        check(torch.equal(k56.dequant_gather_rows(pay, sc, holes),
                          k56.dequant_gather_rows_plain(pay, sc, holes)),
              f"dequant_gather_rows {pay.dtype}: not exact")
    shape_line("dequant_gather_rows", f"the int8 cache query: slots [{B}] "
               f"into [{C},{D}]", lambda: k56.dequant_gather_rows(q8, sc8,
                                                                  slots),
               lambda: k56.dequant_gather_rows_plain(q8, sc8, slots),
               lambda: q8.index_select(0, slots).float()
               * sc8.index_select(0, slots)[:, None],
               B * D + B * 4 + B * 4 + B * D * 4, B * D)

    # the mesh half of the striped L1 over a cache mesh naming this card
    # twice (f32 through K5, int8 through K6), bit-exact to the unstriped
    # read of the same slots
    mesh_half(args, dev, shape_line, table, q8, sc8, holes)

    # K2: DLRM's interaction at F = 26 tables + 1, D = 128; two launches
    # give the same bits, and with the diagonal it holds too
    got = k2.interaction_fwd(x)
    check(torch.equal(got, k2.interaction_fwd(x)),
          "interaction_fwd: two launches differ")
    check(torch.allclose(k2.interaction_fwd(x, self_interaction=True),
                         k2.interaction_fwd_plain(x, self_interaction=True),
                         rtol=1e-5, atol=1e-5),
          f"interaction_fwd self_interaction at [{B}, {F}, {D}]: above 1e-5")
    record("interaction_fwd", "src/repro_torch/csrc/dot_interaction.cu",
           "src/repro/kernels/dot_interaction.py:55",
           got, k2.interaction_fwd_plain(x), False, 1e-5,
           lambda: k2.interaction_fwd(x),
           lambda: k2.interaction_fwd_plain(x),
           lambda: torch.bmm(x, x.transpose(1, 2))[:, li, lj],
           B * F * D * 4 + B * P * 4, 2 * B * P * D)
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
        if key == largest:
            k1_line(f"DLRM group {key}", mega, rows3, reps=10)
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

    # the mesh path's own K5 / K1 / K3 calls, at the dist group's ids
    mesh_path_kernels(args, dev, shape_line, groups)
    torch.cuda.empty_cache()

    # K4: the interaction's adjoint at the training shape (f32 x, as the
    # dense net feeds K2); bf16 and self_interaction checked off it
    P = F * (F - 1) // 2
    xt, dtri = interaction_bwd_inputs(g, dev, tb, F, D)
    bi, bj = torch.tril_indices(F, F, -1, device=dev)
    got = k2.interaction_fwd(xt)
    check(torch.equal(got, k2.interaction_fwd(xt)) and torch.allclose(
        got, k2.interaction_fwd_plain(xt), rtol=1e-5, atol=1e-5),
          f"interaction_fwd at the training shape [{tb}, {F}, {D}]: above "
          "1e-5 or two launches differ")
    # K2 against the exact dots (f64) at unit-variance x, more samples
    # than the grid: the kernel's error and the f32 plain version's
    xu = torch.randn((tb + 7, F, D),
                     generator=torch.Generator().manual_seed(args.seed + 3))
    xu = xu.to(dev)
    exact = k2.interaction_fwd_plain(xu.double())
    got = k2.interaction_fwd(xu).double()
    err_k = (got - exact).abs().max().item()
    err_p = (k2.interaction_fwd_plain(xu).double() - exact).abs().max().item()
    check(torch.allclose(got, exact, rtol=1e-5, atol=1e-5),
          f"interaction_fwd at unit-variance x: {err_k} from the f64 dots")
    print(f"interaction_fwd at unit-variance x [{tb + 7},{F},{D}] against "
          f"the f64 dots: kernel max abs err {err_k:.3g}, f32 plain "
          f"version {err_p:.3g} (the kernel held to 1e-5)")
    del xu, exact, got
    shape_line("interaction_fwd", f"x [{tb},{F},{D}] f32 (DLRM training)",
               lambda: k2.interaction_fwd(xt),
               lambda: k2.interaction_fwd_plain(xt),
               lambda: torch.bmm(xt, xt.transpose(1, 2))[:, bi, bj],
               tb * F * D * 4 + tb * P * 4, 2 * tb * P * D)

    def lib_k4():
        gm = torch.zeros((tb, F, F), device=dev)
        gm[:, bi, bj] = dtri
        return torch.bmm(gm + gm.transpose(1, 2), xt)

    got = k2.interaction_bwd(xt, dtri)
    check(torch.equal(got, k2.interaction_bwd(xt, dtri)),
          "interaction_bwd: two launches differ")
    record("interaction_bwd", "src/repro_torch/csrc/dot_interaction.cu",
           "src/repro/kernels/dot_interaction.py:73",
           got, k2.interaction_bwd_plain(xt, dtri),
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
    # K1 at the LM's token tables (a training step's rows): minitron's
    # hybrid pair, granite's and xLSTM's one table each
    for arch in (args.lm_arch, args.granite_arch, args.xlstm_arch):
        for label, table, rows in lm_k1_inputs(args, dev, arch):
            check(torch.equal(k1.lookup_fwd(table, rows),
                              k1.lookup_fwd_plain(table, rows)),
                  f"lookup_fwd {label}: not bit-exact")
            k1_line(label, table, rows, reps=10)
            del table
    torch.cuda.empty_cache()
    recipe_kernels(args, dev, shape_line, wdl_training_rows(args, dev),
                   ((26, 16), (26, 1)), (16, 1))
    torch.cuda.empty_cache()
    recipe_kernels(args, dev, shape_line, neumf_training_rows(args, dev),
                   ((13, 64), (9, 16), (4, 8)), (64, 8))
    torch.cuda.empty_cache()
    recipe_kernels(args, dev, shape_line, etc_training_rows(args, dev), (),
                   ())
    torch.cuda.empty_cache()
    route_edges(args, dev)
    torch.cuda.empty_cache()
    attention_kernel(args, record, shape_line, g, dev)
    attention_bwd_kernel(args, record, shape_line, g, dev)
    for name, recs in shapes.items():
        out[name]["shapes"] = recs
    for rec in out.values():
        dl = device_lib.get(rec["name"])
        dms, bms = device[rec["name"]], rec["bound_ms"]
        print(f"kernel {rec['name']}: {rec['ms']:.4f} ms (bound "
              f"{bms:.4f} ms by {rec['bound_by']}, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              f"ms), max abs err {rec['max_abs_err']:.3g}; device time "
              f"{dms:.4f} ms (CUDA graph replay, {100 * bms / dms:.1f}% of "
              f"the bound, {100 * max(bms, floor) / dms:.1f}% of the larger "
              "of bound and launch floor)"
              + ("" if dl is None else
                 f", library device time {dl:.4f} ms"))
    return out


def mesh_half(args, dev, shape_line, table, q8, sc8, holes):
    """The mesh half of ``hps_gather.sharded_gather_rows`` /
    ``sharded_dequant_gather_rows`` on the card, over a cache mesh naming
    ``dev`` twice (each entry a block of its own): one owner-mapped K5 (K6
    with scales) launch an entry at the GLOBAL slots. The row read of one
    table over ``RUN.mesh_stripes`` stripes, then the served pooled read of
    the 26 tables off a 2-stripe L1 (``hps._pooled_stack``, one launch an
    entry for all of them); each bit-exact to the unstriped read of the
    flat views and to the plain version, and timed beside it."""
    import torch
    from repro_torch.kernels import hps_gather as k56
    from repro_torch.kernels import ops
    n = args.mesh_stripes
    c, d = table.shape
    cl = c // n
    mesh = [dev, dev]
    gpu = torch.cuda.get_device_name(0)
    slots = torch.where(holes >= 0, holes % (n * cl), -1).to(torch.int32)
    b = slots.shape[0]
    for label, pay, sc in (("f32", table, None), ("int8", q8, sc8)):
        stripes = pay[:n * cl].view(n, cl, d)
        scales = None if sc is None else sc[:n * cl].view(n, cl)
        blocks, bsc = ops.place_stripes(stripes, scales, mesh)
        name = "gather_rows" if sc is None else "dequant_gather_rows"

        def fn():
            return ops.sharded_cache_gather(blocks, slots, scales=bsc,
                                            mesh=mesh)

        def one():
            return ops.sharded_cache_gather(stripes, slots, scales=scales)

        got, launched = launches_of(fn)
        check(launched == {name: 2}, f"mesh half {label}: launches "
              f"{launched}, want one {name} an entry")
        want = one()
        check(torch.equal(got, want), f"mesh half {label}: not bit-exact "
              "to the unstriped read")
        check(torch.equal(got, ops.mesh_pooled_read(
            ((blocks, bsc),), (slots.view(-1, 1),), plain=True)[:, 0]),
            f"mesh half {label}: not bit-exact to the plain version")
        flat, fsc = ops.striped_view((stripes, scales))
        fslots = ops.flatten_striped_slots(stripes, slots)
        plain = (lambda: k56.gather_rows_plain(flat, fslots)) if sc is None \
            else (lambda: k56.dequant_gather_rows_plain(flat, fsc, fslots))
        lib = (lambda: flat.index_select(0, fslots.clamp_min(0))) \
            if sc is None else (lambda: flat.index_select(
                0, fslots.clamp_min(0)).float() * fsc.index_select(
                    0, fslots.clamp_min(0))[:, None])
        row = d * pay.element_size() + (0 if sc is None else 4)
        shape_line(name, f"the mesh half ({label}): slots [{b}] over {n} "
                   f"stripes of [{cl},{d}] laid out on [{dev}, {dev}]",
                   fn, plain, lib, b * row + b * 4 + b * d * 4,
                   0 if sc is None else b * d,
                   err=(got - want).abs().max().item())
        print(f"mesh half {label} on {gpu}: the striped-mesh read "
              f"{graph_ms(fn, 20):.4f} ms device, {time_ms(fn, 100):.4f} ms "
              f"wrapper, against the unstriped read {graph_ms(one, 20):.4f} "
              f"/ {time_ms(one, 100):.4f} ms (CUDA graph replay / CUDA "
              f"events over 100 calls; launches {launched}: two entries on "
              "one card, no copy between cards, which one card cannot "
              "show); bit-exact")
    for label in ("f32", "int8"):
        mesh_stack(args, dev, shape_line, label, mesh)


def mesh_stack(args, dev, shape_line, payload_dtype, mesh):
    """The served pooled read of the 26 tables (:func:`served_inputs`)
    off an L1 of two stripes a table laid out on the cache ``mesh``:
    ``hps._pooled_stack(..., mesh=)``, one owner-mapped K5 (f32) or K6
    (int8) launch an entry for all the tables, held bit-exact to the
    one-device read of the stripes' flat views (K1 / K6, the slots remapped)
    and to the plain version; timed beside the one-device read, with each
    table's ``index_select`` + ``sum`` and a ``torch.stack`` on the flat
    views as the library yardstick."""
    import torch
    from repro_torch.core.hps.hps import _pooled_stack
    from repro_torch.kernels import ops
    pays, sets = served_inputs(args, dev, payload_dtype, SLOT_SETS)
    stripes = [(p.view(2, -1, p.shape[1]),
                None if sc is None else sc.view(2, -1)) for p, sc in pays]
    placed = [ops.place_stripes(st, sc, mesh) for st, sc in stripes]
    flat = [ops.striped_view(st) for st in stripes]
    fsets = [[ops.flatten_striped_slots(st[0], s)
              for st, s in zip(stripes, batch)] for batch in sets]
    combiners = ("sum",) * len(pays)
    b, d = args.batch, pays[0][0].shape[1]
    name = "gather_rows" if payload_dtype == "f32" else "dequant_gather_rows"

    def fn(sl):
        return _pooled_stack(placed, sl, combiners, mesh=mesh)

    def one(fs):
        return _pooled_stack(flat, fs, combiners)

    def plain(sl):
        return ops.mesh_pooled_read(placed, sl, plain=True)

    def lib(fs):
        return torch.stack([
            (p.index_select(0, s.view(-1)).float() if sc is None else
             p.index_select(0, s.view(-1)).float()
             * sc.index_select(0, s.view(-1))[:, None]).view(b, -1, d)
            .sum(1) for (p, sc), s in zip(flat, fs)], 1)

    got, launched = launches_of(lambda: fn(sets[0]))
    check(launched == {name: len(mesh)}, f"mesh stack {payload_dtype}: "
          f"launches {launched}, want one {name} an entry")
    check(torch.equal(got, one(fsets[0])), f"mesh stack {payload_dtype}: "
          "not bit-exact to the one-device read")
    check(torch.equal(got, plain(sets[0])), f"mesh stack {payload_dtype}: "
          "not bit-exact to the plain version")
    slots = sets[0]
    ids = sum(s.numel() for s in slots)
    valid = sum(int((s >= 0).sum()) for s in slots)
    distinct = sum(int(torch.unique(s[s >= 0]).numel()) for s in slots)
    row = d * pays[0][0].element_size() + (0 if pays[0][1] is None else 4)
    shape_line(name, f"the mesh half, served ({payload_dtype}): "
               f"{len(pays)} tables x slots [{b},1] over 2 stripes of "
               f"[{pays[0][0].shape[0] // 2},{d}] on [{dev}, {dev}] "
               "(hps._pooled_stack; library on the flat views)",
               rotating(fn, sets), rotating(plain, sets),
               rotating(lib, fsets),
               ids * 4 + distinct * row + len(pays) * b * d * 4,
               (1 if pays[0][1] is None else 2) * valid * d, err=0.0)
    mesh_fn, one_fn = rotating(fn, sets), rotating(one, fsets)
    print(f"mesh stack {payload_dtype} on {torch.cuda.get_device_name(0)}: "
          f"{len(pays)} tables over [{dev}, {dev}], launches {launched}; "
          f"device {graph_ms(mesh_fn, SLOT_SETS):.4f} ms, wrapper "
          f"{time_ms(mesh_fn, 100):.4f} ms, against the one-device read's "
          f"{graph_ms(one_fn, SLOT_SETS):.4f} / {time_ms(one_fn, 100):.4f} "
          "ms (CUDA graph replay / CUDA events over 100 calls); bit-exact "
          "to it and to the plain version")
    del pays, placed, flat
    torch.cuda.empty_cache()


def mesh_path_kernels(args, dev, shape_line, groups):
    """The mesh path's own kernel calls on the card, at capped DLRM's
    ``dist`` group and the first training batch's ids (``groups``, as
    :func:`training_rows` gives them): the all-to-all owner's gather
    ``ops.row_gather`` (K5; its adjoint, K3 at one id a row) over the
    slots ``_bucket_by_owner`` makes for one shard at capacity factor 2
    (the main path's at one card: half of them holes), and the all-gather
    path's ``masked_range_lookup`` through ``ops.kernel_pool`` (K1; its
    adjoint, K3) against shard 1 of 4 of the same table, where the ids
    outside the shard become holes. Rows bit-exact to the plain versions,
    table gradients bit-exact to K3's chunked plain version and within
    1e-5 of the summed magnitudes of the plain one; each kernel timed at
    these inputs with ``shape_line``."""
    import torch
    from repro_torch.core.embedding.common import masked_range_lookup
    from repro_torch.core.embedding.strategies import (
        _bucket_by_owner, a2a_capacity)
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels import hps_gather as k56
    from repro_torch.kernels import ops
    v, rows2 = groups["dist"]
    b, d = args.train_batch, 128
    t = rows2.shape[0] // b
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    mega = torch.randn((v, d), generator=gen, device=dev)

    def grad_check(label, table, fn, rows, cot):
        """``fn``'s table gradient for the cotangent ``cot`` against K3's
        plain versions at ``rows [N, 1]`` (-1 holes)."""
        tab = table.detach().requires_grad_()
        fn(tab).backward(cot)
        got = tab.grad
        flat_cot = cot.reshape(rows.shape[0], d)
        check(torch.equal(got, k1.lookup_bwd_chunked_plain(
            tuple(table.shape), rows, flat_cot)),
              f"{label}: the table gradient is not bit-exact to K3's "
              "chunked plain version")
        scale = k1.lookup_bwd_plain(tuple(table.shape), rows,
                                    flat_cot.abs())
        want = k1.lookup_bwd_plain(tuple(table.shape), rows, flat_cot)
        check(bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()),
              f"{label}: the table gradient is above 1e-5 of the summed "
              "magnitudes")
        return (got - want).abs().max().item()

    def bwd_line(label, shape, rows, cot):
        keep = rows.view(-1) >= 0
        flat, src = rows.view(-1)[keep].long(), cot[keep]
        n = rows.shape[0]
        shape_line("lookup_bwd", f"{label}: rows [{n},1] "
                   f"({100 * float((~keep).float().mean()):.1f}% -1) into "
                   f"[{shape[0]},{d}]",
                   lambda: k1.lookup_bwd(shape, rows, cot),
                   lambda: k1.lookup_bwd_plain(shape, rows, cot),
                   lambda: torch.zeros(shape, device=dev).index_add_(
                       0, flat, src),
                   int(keep.sum()) * d * 4 + n * 4 + shape[0] * d * 4,
                   int(keep.sum()) * d, reps=4)

    # the all-to-all owner's gather: one shard's send buffer (world 1)
    flat_ids = rows2.view(-1)
    cap = a2a_capacity(flat_ids.numel(), 1, 2.0)
    send, _, _ = _bucket_by_owner(flat_ids, 1, cap)
    slots = send.reshape(-1).contiguous()
    n = slots.shape[0]
    keep = slots >= 0
    got = ops.row_gather(mega, slots)
    want = k56.gather_rows_plain(mega, slots)
    check(torch.equal(got, want), f"row_gather at slots [{n}] into "
          f"[{v},{d}]: not bit-exact to gather_rows_plain")
    cot = torch.randn((n, d), generator=gen, device=dev)
    gerr = grad_check(f"row_gather at slots [{n}]", mega,
                      lambda tab: ops.row_gather(tab, slots),
                      slots.view(-1, 1), cot)
    distinct = int(torch.unique(slots[keep]).numel())
    shape_line("gather_rows", f"the all-to-all owner's read (dist): slots "
               f"[{n}] ({100 * float((~keep).float().mean()):.1f}% -1, "
               f"{distinct} distinct) into [{v},{d}]",
               lambda: k56.gather_rows(mega, slots),
               lambda: k56.gather_rows_plain(mega, slots),
               lambda: mega.index_select(0, slots.clamp_min(0))
               * keep[:, None],
               distinct * d * 4 + n * 4 + n * d * 4, 0,
               err=(got - want).abs().max().item())
    bwd_line("the all-to-all owner's adjoint (dist)", (v, d),
             slots.view(-1, 1), cot)
    print(f"row_gather (dist, all-to-all at one shard): slots [{n}] into "
          f"[{v},{d}], rows bit-exact, table gradient bit-exact to K3's "
          f"chunked plain version ({gerr:.3g} from the plain one)")
    del got, want, cot

    # the all-gather path's masked range, shard 1 of 4 of the same table
    shard = -(-v // 4)
    v0 = shard
    local = mega[v0:v0 + shard]
    rows3 = rows2.view(b, t, 1)
    got = masked_range_lookup(local, rows3, v0, pool_fn=ops.kernel_pool)
    want = masked_range_lookup(local, rows3, v0)
    check(torch.equal(got, want), f"masked_range_lookup shard 1 of 4: not "
          "bit-exact to its plain version")
    rel = rows2 - v0
    rel = torch.where((rows2 >= 0) & (rel >= 0) & (rel < shard), rel,
                      torch.full_like(rel, -1))
    held = float((rel >= 0).float().mean())
    cot = torch.randn((b, t, d), generator=gen, device=dev)
    gerr = grad_check("masked_range_lookup shard 1 of 4", local,
                      lambda tab: masked_range_lookup(
                          tab, rows3, v0, pool_fn=ops.kernel_pool),
                      rel, cot)
    kept = rel.view(-1) >= 0
    distinct = int(torch.unique(rel[rel >= 0]).numel())
    shape_line("lookup_fwd", f"masked range (dist, shard 1 of 4): rows "
               f"[{b * t},1] ({100 * (1 - held):.1f}% -1, {distinct} "
               f"distinct) into [{shard},{d}]",
               lambda: k1.lookup_fwd(local, rel),
               lambda: k1.lookup_fwd_plain(local, rel),
               lambda: local.index_select(0, rel.view(-1).clamp_min(0))
               * kept[:, None],
               rel.numel() * 4 + distinct * d * 4 + rel.shape[0] * d * 4,
               int(kept.sum()) * d, err=(got - want).abs().max().item())
    bwd_line("masked range adjoint (dist, shard 1 of 4)", (shard, d), rel,
             cot.view(-1, d).contiguous())
    print(f"masked_range_lookup (dist, shard 1 of 4, v0 {v0}): "
          f"{100 * held:.1f}% of the ids in the shard, rows bit-exact, "
          "table gradient bit-exact to K3's chunked plain version "
          f"({gerr:.3g} from the plain one)")
    del mega, local, got, want, cot


def served_record(args, dev, payload_dtype, record):
    """K1 (f32) or K6 (int8) at the served shape (:func:`served_inputs`):
    one grouped launch for all the tables, bit-exact to the plain version
    and to a second launch, recorded with each table's ``index_select`` +
    ``sum`` and a ``torch.stack`` as the library yardstick."""
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels import hps_gather as k56
    pays, sets = served_inputs(args, dev, payload_dtype, SLOT_SETS)
    slots = sets[0]
    tabs, scs = [p for p, _ in pays], [sc for _, sc in pays]
    b, d = args.batch, tabs[0].shape[1]
    if payload_dtype == "f32":
        name, row_bytes, flops = "lookup_fwd", d * 4, 1
        source = "src/repro_torch/csrc/embedding_lookup.cu"
        replaces = "src/repro/kernels/embedding_lookup.py:67"

        def fn(sl):
            return k1.lookup_fwd_grouped(tabs, sl)

        def plain(sl):
            return k1.lookup_fwd_grouped_plain(tabs, sl)

        def lib(sl):
            return torch.stack([t.index_select(0, s.view(-1)).view(b, -1, d)
                                .sum(1) for t, s in zip(tabs, sl)], 1)
    else:
        name, row_bytes, flops = "dequant_gather_rows", d + 4, 2
        source = "src/repro_torch/csrc/hps_gather.cu"
        replaces = "src/repro/kernels/hps_gather.py:98"

        def fn(sl):
            return k56.dequant_gather_grouped(tabs, scs, sl)

        def plain(sl):
            return k56.dequant_gather_grouped_plain(tabs, scs, sl)

        def lib(sl):
            return torch.stack([
                (q.index_select(0, s.view(-1)).float()
                 * c.index_select(0, s.view(-1))[:, None]).view(b, -1, d)
                .sum(1) for q, c, s in zip(tabs, scs, sl)], 1)
    got = fn(slots)
    check(torch.equal(got, fn(slots)), f"{name} grouped: two launches differ")
    # the bound reads each table's distinct valid rows once
    ids = sum(s.numel() for s in slots)
    valid = sum(int((s >= 0).sum()) for s in slots)
    distinct = sum(int(torch.unique(s[s >= 0]).numel()) for s in slots)
    print(f"kernel {name} grouped: {len(tabs)} tables x slots "
          f"[{b},{slots[0].shape[1]}] into [{tabs[0].shape[0]},{d}] "
          f"{tabs[0].dtype}, one launch, bit-exact to the plain version; "
          f"timed over {len(sets)} batches of slots in turn")
    record(name, source, replaces, got, plain(slots), True, 0.0,
           rotating(fn, sets), rotating(plain, sets), rotating(lib, sets),
           ids * 4 + distinct * row_bytes + len(tabs) * b * d * 4,
           flops * valid * d)


def recipe_kernels(args, dev, shape_line, training, served, query_dims):
    """K1, K3, K5 and K6 at the shapes the recipes beyond DLRM give them,
    held against their plain versions and timed (``shape_line``): K1 and
    K3 at each group of ``training`` (:func:`wdl_training_rows`' form) on
    the first training batch's ids; the grouped served read (K1 f32, K6
    int8) at each ``(tables, D)`` of ``served``, and the cache query's row
    read (K5 f32, K6 int8) at each D of ``query_dims``. WDL's call: its
    ``dist`` group (D 16) and wide twins (D 1), 26 tables at D 16 and D 1;
    NeuMF's: its ``deep`` (D 64) and ``ctx`` (D 8) groups, its three HPSes'
    13 x D 64, 9 x D 16 and 4 x D 8, queries at D 64 and D 8."""
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels import hps_gather as k56
    gm = torch.Generator(device=dev).manual_seed(args.seed + 4)
    for label, (v, rows, d) in training.items():
        mega = torch.randn((v, d), generator=gm, device=dev)
        got = k1.lookup_fwd(mega, rows)
        check(torch.equal(got, k1.lookup_fwd_plain(mega, rows)),
              f"lookup_fwd {label}: not bit-exact at rows [{rows.shape[0]}, "
              f"1] into [{v}, {d}]")
        keep = rows >= 0
        n = rows.shape[0]
        distinct = int(torch.unique(rows[keep]).numel())
        valid = int(keep.sum())
        shape = (f"{label}: rows [{n},1] ({distinct} distinct ids) into "
                 f"[{v},{d}]")
        shape_line("lookup_fwd", shape, lambda: k1.lookup_fwd(mega, rows),
                   lambda: k1.lookup_fwd_plain(mega, rows),
                   lambda: (mega.index_select(0, rows.view(-1).clamp_min(0))
                            * keep.view(-1, 1)),
                   n * 4 + distinct * d * 4 + n * d * 4, valid * d, 10, 0.0)
        del mega
        dp = torch.randn((n, d), generator=gm, device=dev)
        got = k1.lookup_bwd((v, d), rows, dp)
        check(torch.equal(got, k1.lookup_bwd((v, d), rows, dp)),
              f"lookup_bwd {label}: two launches differ")
        check(torch.equal(got, k1.lookup_bwd_chunked_plain((v, d), rows,
                                                           dp)),
              f"lookup_bwd {label}: not bit-exact to its chunked plain "
              "version")
        want = k1.lookup_bwd_plain((v, d), rows, dp)
        scale = k1.lookup_bwd_plain((v, d), rows, dp.abs())
        check(bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all()),
              f"lookup_bwd {label}: above 1e-5 of the summed magnitudes")
        err = (got - want).abs().max().item()
        del got, want, scale
        flat, src = rows.view(-1)[keep.view(-1)].long(), dp[keep.view(-1)]
        shape_line("lookup_bwd", shape, lambda: k1.lookup_bwd((v, d), rows,
                                                              dp),
                   lambda: k1.lookup_bwd_plain((v, d), rows, dp),
                   lambda: torch.zeros((v, d), device=dev).index_add_(
                       0, flat, src),
                   valid * d * 4 + n * 4 + v * d * 4, valid * d, 4, err)
        del dp, flat, src
        torch.cuda.empty_cache()
    b, c = args.batch, args.cache_capacity
    for t, d in served:
        for pd in ("f32", "int8"):
            # enough batches of slots that the replayed reads leave L2 at
            # D 16 (the 26 payloads of D 1 fit in L2 whole, as in serving)
            sets = 64 if d > 1 else SLOT_SETS
            pays, slot_sets = served_inputs(args, dev, pd, sets, d=d,
                                            tables=t)
            tabs, scs = [p for p, _ in pays], [sc for _, sc in pays]
            if pd == "f32":
                name, row_bytes = "lookup_fwd", d * 4

                def fn(sl):
                    return k1.lookup_fwd_grouped(tabs, sl)

                def plain(sl):
                    return k1.lookup_fwd_grouped_plain(tabs, sl)

                def lib(sl):
                    return torch.stack([t.index_select(0, s.view(-1))
                                        for t, s in zip(tabs, sl)], 1)
            else:
                name, row_bytes = "dequant_gather_rows", d + 4

                def fn(sl):
                    return k56.dequant_gather_grouped(tabs, scs, sl)

                def plain(sl):
                    return k56.dequant_gather_grouped_plain(tabs, scs, sl)

                def lib(sl):
                    return torch.stack([
                        q.index_select(0, s.view(-1)).float()
                        * cs.index_select(0, s.view(-1))[:, None]
                        for q, cs, s in zip(tabs, scs, sl)], 1)
            slots = slot_sets[0]
            got = fn(slots)
            check(torch.equal(got, plain(slots)) and torch.equal(
                got, fn(slots)), f"{name} grouped at D {d}: not bit-exact "
                "or two launches differ")
            distinct = sum(int(torch.unique(s).numel()) for s in slots)
            shape_line(name, f"grouped: {len(tabs)} x [{b},1] into "
                       f"[{c},{d}] {pd}", rotating(fn, slot_sets),
                       rotating(plain, slot_sets), rotating(lib, slot_sets),
                       len(tabs) * b * 4 + distinct * row_bytes
                       + len(tabs) * b * d * 4,
                       (2 if pd == "int8" else 1) * len(tabs) * b * d,
                       sets, 0.0)
            if d not in query_dims:
                del pays, slot_sets, tabs, scs
                continue
            # the cache query's row read of one table (K5 f32, K6 int8)
            (p0, s0), q = pays[0], slots[0].view(-1)
            if s0 is None:
                qn, qfn = "gather_rows", lambda: k56.gather_rows(p0, q)
                qplain = lambda: k56.gather_rows_plain(p0, q)
                qlib = lambda: p0.index_select(0, q)
            else:
                qn = "dequant_gather_rows"
                qfn = lambda: k56.dequant_gather_rows(p0, s0, q)
                qplain = lambda: k56.dequant_gather_rows_plain(p0, s0, q)
                qlib = lambda: p0.index_select(0, q).float() \
                    * s0.index_select(0, q)[:, None]
            check(torch.equal(qfn(), qplain()),
                  f"{qn} query at D {d} {pd}: not bit-exact")
            shape_line(qn, f"the {pd} cache query: slots [{b}] into "
                       f"[{c},{d}]", qfn, qplain, qlib,
                       b * row_bytes + b * 4 + b * d * 4,
                       (b * d if pd == "int8" else 0), 20, 0.0)
            del pays, slot_sets, tabs, scs
    torch.cuda.empty_cache()


def interaction_bwd_inputs(g, dev, b: int, f: int = 27, d: int = 128):
    """K4's inputs at DLRM's training shape: ``x [b, f, d]`` f32 (as the
    dense net feeds K2) and ``dtri [b, f(f-1)/2]``, drawn in that order
    from CPU generator ``g``."""
    import torch
    x = torch.randn((b, f, d), generator=g).mul_(0.3).to(dev)
    dtri = torch.randn((b, f * (f - 1) // 2), generator=g).to(dev)
    return x, dtri


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
                     window=None, causal=True, sk=None,
                     q_pos0: int = 0) -> tuple:
    """K8's inputs: random ``q, k, v, do`` and K7's own ``o`` and ``lse``
    for them (causal unless told otherwise, queries from position
    ``q_pos0``; ``k``, ``v`` over ``sk`` keys, ``s`` if not given) ->
    ``(q, k, v, o, lse, do)``."""
    from repro_torch.kernels import flash_attention as k78
    q, k, v, do = (randn_heads(g, dev, (n,), t, d, dtype)[0]
                   for n, t in ((bh, s), (bkv, sk or s), (bkv, sk or s),
                                (bh, s)))
    # no offset, no argument: tools/kernel_times.py builds these inputs
    # for checkouts whose kernels predate the offset too
    shard = {"q_pos0": q_pos0} if q_pos0 else {}
    o, lse = k78.flash_fwd(q, k, v, causal=causal, window=window, **shard)
    return q, k, v, o, lse, do


def window_pairs(s: int, window: int) -> int:
    """The (query, key) pairs causal attention with a window of ``window``
    keys computes over ``s`` positions: ``min(i + 1, window)`` a query."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def window_mask(s: int, window: int, dev):
    """``[s, s]`` bool, True where query ``i`` attends key ``j``:
    ``i - window < j <= i``, K7's windowed causal mask."""
    import torch
    i = torch.arange(s, device=dev)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


def rg_attn_shape() -> tuple:
    """``(Hq, Hkv, D, window)`` of recurrentgemma-9b's local attention."""
    from repro_torch.configs.registry import get_lm_config
    cfg = get_lm_config("recurrentgemma-9b")
    return (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.local_attn_window)


def granite_attn_shape(args) -> tuple:
    """``(Hq, Hkv, D)`` of the attention of ``args.granite_arch``."""
    from repro_torch.configs.registry import get_lm_config
    cfg = get_lm_config(args.granite_arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def encdec_attn_shapes(args, b: int) -> list:
    """``(label, BH, BKV, Sq, Sk, D, causal)`` of the attention launches of
    ``args.seamless_arch`` and ``args.pixtral_arch`` at batch ``b`` over
    ``args.attn_seq`` positions: seamless's encoder (non-causal over the
    ``max(S // 8, 16)`` frames of ``repro/launch/specs.py``), its
    decoder's causal self-attention and its cross-attention (S queries
    over the frames), then pixtral's causal GQA over its patch and text
    positions together."""
    from repro_torch.configs.registry import get_lm_config
    sm = get_lm_config(args.seamless_arch)
    px = get_lm_config(args.pixtral_arch)
    s = args.attn_seq
    f = max(s // 8, 16)
    h, kv, d = sm.num_heads, sm.num_kv_heads, sm.resolved_head_dim
    return [(f"{sm.name} encoder", b * h, b * kv, f, f, d, False),
            (f"{sm.name} decoder self-attention", b * h, b * kv, s, s, d,
             True),
            (f"{sm.name} cross-attention", b * h, b * kv, s, f, d, False),
            (px.name, b * px.num_heads, b * px.num_kv_heads, s, s,
             px.resolved_head_dim, True)]


def attn_pairs(sq: int, sk: int, causal: bool, q_pos0: int = 0) -> int:
    """(query, key) pairs a head computes: the causal triangle (for queries
    at positions ``q_pos0 ...``: ``n p + n (n + 1) / 2`` over ``n``
    queries at offset ``p``), or every pair of a non-causal
    (cross-)attention."""
    if not causal:
        return sq * sk
    return sq * q_pos0 + sq * (sq + 1) // 2


#: K7 / K8 with a causal query offset, on every route: ``(label, D,
#: dtype)``, each at every ``(Sq, Sk, q_pos0)`` of :data:`OFFSET_CASES`
#: with 6 query heads over 2 KV heads (at D 256 the dk/dv grid splits the
#: group 3 ways)
OFFSET_ROUTES = (("D 16", 16, "bf16"), ("D 32", 32, "bf16"),
                 ("D 64", 64, "bf16"), ("D 96", 96, "bf16"),
                 ("D 128", 128, "bf16"), ("D 256", 256, "bf16"),
                 ("f32 D 64", 64, "f32"))
#: the first shard of a split (offset 0 over more keys than queries), an
#: offset every query and key tile divides, one none does (37 queries at
#: 100) and the last shard
OFFSET_CASES = ((100, 700, 0), (100, 700, 384), (37, 700, 100),
                (100, 700, 600))


def shard_shape(args) -> tuple:
    """``(n, p)``: the queries of the last of ``args.seq_shards``
    sequence-parallel shards of ``args.attn_seq`` positions and its query
    offset."""
    n = args.attn_seq // args.seq_shards
    return n, args.attn_seq - n


def causal_mask(n: int, sk: int, q_pos0: int, dev):
    """``[n, sk]`` bool, True where query row ``i`` (at position ``q_pos0
    + i``) attends key ``j``: K7's causal mask with a query offset, as
    ``sdpa`` takes it (its ``is_causal`` aligns the diagonal top-left when
    the lengths differ, another function)."""
    import torch
    i = torch.arange(n, device=dev)
    j = torch.arange(sk, device=dev)
    return j[None, :] <= q_pos0 + i[:, None]


def device_kernels(fn, calls: int = 10) -> dict:
    """The device kernels a call of ``fn`` launches: each kernel's name
    (its function's, without the anonymous namespace and the arguments) ->
    launches a call, from ``torch.profiler`` over ``calls`` calls after a
    warm-up (as ``tools/kernel_times.py``'s ``parts_ms``: a single
    profiled call can lose its first kernel); empty if the profiler
    records no device events."""
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
            name = e.name.split("(anonymous namespace)::")[-1].split("(")[0]
            out[name] = out.get(name, 0) + 1
    return {name: n / calls for name, n in out.items()}


def bwd_form(kernels: dict) -> str:
    """Which form of K8's D 64 kernels :func:`device_kernels` saw: "short"
    (the dq kernel with a head's K / V resident, the dk/dv walk split over
    a cluster), "long", "not measured" (no device events) or "not D 64"."""
    if not kernels:
        return "not measured"
    names = " ".join(kernels)
    if "flash_bwd_dq_wgmma64_short_kernel" in names and \
            "flash_bwd_dkv_wgmma64_kernel<true>" in names:
        return "short"
    if "flash_bwd_dq_wgmma64_kernel" in names:
        return "long"
    return "not D 64"


#: K8's D 64 short form at the edges of its dk/dv split, ``(label, BH,
#: BKV, Sq, Sk)``, non-causal: runs of whole query tiles, runs that end
#: inside a tile's heads (45 items over 8 splits), one query tile of 40
#: queries (2 splits), the longest Sk with g = 4
K8_SHORT_EDGES = (("split runs of whole tiles, g 4", 8, 2, 1000, 300),
                  ("split runs inside a tile, g 3", 6, 2, 900, 300),
                  ("40 queries, g 2", 4, 2, 40, 300),
                  ("Sk 512, g 4", 8, 2, 700, 512))


def sdpa_backend(fn) -> str:
    """The device kernels one call of ``fn`` (an ``sdpa`` call) launches,
    by name, from ``torch.profiler``: which backend ``sdpa`` took; "not
    measured" if the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    if not names:
        return "not measured"
    return ", ".join(n[:60] for n in names[:6])


#: K3 at the edges of its routes, ``(D, B)``: rows ``[B, 1]`` over a
#: vocabulary of 2^20 with a run of one id across hundreds of chunks, at
#: every group width of the narrow passes and the first D past them, each
#: at the longest list the hand-written sort takes and at one id more
K3_EDGES = tuple((d, b) for d in (1, 2, 8, 24, 32, 33)
                 for b in (32_768, 32_769))
#: K7 at the edges of the D 64 short-key form, ``(label, BH, BKV, Sq, Sk,
#: causal, q_pos0)``: its longest Sk with GQA g = 4 and one key more, a
#: ragged Sk, causal self-attention at its longest S, a causal query
#: offset over 500 keys
K7_EDGES = (("Sk 512, g 4", 8, 2, 700, 512, False, 0),
            ("Sk 513, g 4", 8, 2, 700, 513, False, 0),
            ("Sk 300", 8, 8, 700, 300, False, 0),
            ("causal S 512, g 3", 6, 2, 512, 512, True, 0),
            ("causal at q_pos0 400 over 500 keys, g 3", 6, 2, 100, 500,
             True, 400))


def route_edges(args, dev) -> None:
    """K3 and K7 at the edges of the routes their wrappers choose by shape
    (:data:`K3_EDGES`, :data:`K7_EDGES`), each held against its plain
    version with two launches bit-equal; then K7's two D 64 forms against
    each other: the same queries over 512 keys (the short form) and over
    513 (the long form), the 513th key scored so low that its p is 0, give
    the same bits."""
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels.ref import flash_attention_ref
    g = torch.Generator(device=dev).manual_seed(args.seed + 9)
    gc = torch.Generator().manual_seed(args.seed + 9)
    v, run = 1 << 20, 9000
    for d, b in K3_EDGES:
        rows = torch.randint(-1, v, (b, 1), generator=g, device=dev,
                             dtype=torch.int32)
        rows[:run] = 7
        dp = torch.randn((b, d), generator=g, device=dev)
        got = k1.lookup_bwd((v, d), rows, dp)
        check(torch.equal(got, k1.lookup_bwd((v, d), rows, dp)),
              f"lookup_bwd D {d} rows [{b},1]: two launches differ")
        check(torch.equal(got, k1.lookup_bwd_chunked_plain((v, d), rows,
                                                           dp)),
              f"lookup_bwd D {d} rows [{b},1]: not bit-exact to its "
              "chunked plain version")
        del got, rows, dp
    print(f"kernel lookup_bwd at its route edges: D "
          f"{', '.join(str(d) for d in sorted({d for d, _ in K3_EDGES}))} "
          f"x rows [{K3_EDGES[0][1]},1] (the hand-written sort) and "
          f"[{K3_EDGES[1][1]},1] (torch.sort) into [{v},D], a {run}-row "
          "run: bit-exact to the chunked plain version, two launches equal")
    tol_o, tol_l = ATTN_TOL["bf16"]
    worst = 0.0
    for label, bh, bkv, sq, sk, causal, p in K7_EDGES:
        q, = randn_heads(gc, dev, (bh,), sq, 64, torch.bfloat16)
        k, v_ = randn_heads(gc, dev, (bkv, bkv), sk, 64, torch.bfloat16)
        o, lse = k7.flash_fwd(q, k, v_, causal=causal, q_pos0=p)
        o2, lse2 = k7.flash_fwd(q, k, v_, causal=causal, q_pos0=p)
        po, plse = flash_attention_ref(q, k, v_, causal=causal, q_pos0=p)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd D 64 {label}: two launches differ")
        err = (o.float() - po.float()).abs().max().item()
        check(err <= tol_o and (lse - plse).abs().max().item() <= tol_l,
              f"flash_fwd D 64 {label}: o {err} or lse off its plain "
              "version")
        worst = max(worst, err)
    q, = randn_heads(gc, dev, (8,), 700, 64, torch.bfloat16)
    q[..., 0] = q[..., 0].abs() + 1
    k, v_ = randn_heads(gc, dev, (2, 2), 513, 64, torch.bfloat16)
    k[:, 512] = 0
    k[:, 512, 0] = -3000.0
    short = k7.flash_fwd(q, k[:, :512].contiguous(), v_[:, :512].contiguous(),
                         causal=False)
    long_ = k7.flash_fwd(q, k, v_, causal=False)
    check(torch.equal(short[0], long_[0]) and torch.equal(short[1],
                                                          long_[1]),
          "flash_fwd D 64: the short-key form's o / lse differ from the long "
          "form's over the same keys")
    print(f"kernel flash_fwd D 64 at its route edges: "
          f"{'; '.join(e[0] for e in K7_EDGES)}: within {tol_o} / {tol_l} of "
          f"the plain version (worst o {worst:.3g}), two launches equal; "
          "q [8,700,64] over 512 keys (the short-key form) and over 513 "
          "(the long form, key 513 scored -3000 x q_0): o and lse bit-equal")


def attention_kernel(args, record, shape_line, g, dev):
    """K7 against its plain version at (a) minitron-4b's prefill shape
    (timed), (b) recurrentgemma's local attention at its prefill shape
    (timed, under the kernel's ``shapes``, with ``sdpa`` and the windowed
    mask as the yardstick), (c) an odd f32 length with GQA, (d)
    granite-moe-3b-a800m's prefill at D 64 (timed under ``shapes``, with
    ``sdpa`` as the yardstick) and two edges of the D 64 route at
    ``attn_edge_seq``: MHA without the causal mask (an encoder's
    self-attention) and g = 2 with a window no tile divides; (e) the
    encoder-decoder's and the vision prefix's prefill shapes
    (:func:`encdec_attn_shapes`: seamless's encoder, decoder and
    cross-attention, whose keys are the encoder's 512, and pixtral's),
    each timed under ``shapes`` with ``sdpa`` as the yardstick; (f) a
    causal query offset on every route (:data:`OFFSET_ROUTES` x
    :data:`OFFSET_CASES`), then minitron-4b's last sequence-parallel shard
    (:func:`shard_shape`) timed under ``shapes`` with ``sdpa`` and the
    explicit causal mask as the yardstick (the kernels it launches
    printed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels.ref import flash_attention_ref

    def qkv(bh, bkv, s, d, dtype):
        return randn_heads(g, dev, (bh, bkv, bkv), s, d, dtype)

    def held(case, q, k, v, dtype, window=None, causal=True, q_pos0=0):
        o, lse = k7.flash_fwd(q, k, v, causal=causal, window=window,
                              q_pos0=q_pos0)
        o2, lse2 = k7.flash_fwd(q, k, v, causal=causal, window=window,
                                q_pos0=q_pos0)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd {case}: two launches differ")
        po, plse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_pos0=q_pos0)
        err_o = (o.float() - po.float()).abs().max().item()
        err_l = (lse - plse).abs().max().item()
        tol_o, tol_l = ATTN_TOL[dtype]
        check(err_o <= tol_o and err_l <= tol_l,
              f"flash_fwd {case}: max abs err o {err_o}, lse {err_l} (bounds "
              f"{tol_o}, {tol_l})")
        print(f"flash_fwd {case}: q {list(q.shape)} k/v {list(k.shape)} "
              f"{dtype}, causal {causal}, window {window}"
              + (f", q_pos0 {q_pos0}" if q_pos0 else "") + ": max abs err o "
              f"{err_o:.3g} (bound "
              f"{tol_o}), lse {err_l:.3g} (bound {tol_l}); two launches "
              "bit-identical")
        return o, po

    # (b) recurrentgemma's local attention at its prefill: B 2, Hq 16,
    # Hkv 1, D 256, S 4096, window 2048
    s = args.attn_seq
    hq, hkv, d, w = rg_attn_shape()
    b = args.lm_batch
    q, k, v = qkv(b * hq, b * hkv, s, d, torch.bfloat16)
    o, po = held("(b)", q, k, v, "bf16", window=w)
    err = (o.float() - po.float()).abs().max().item()
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, k, v))
    mask = window_mask(s, w, dev)
    shape_line("flash_fwd", f"recurrentgemma-9b prefill: q [{b * hq},{s},{d}]"
               f", k/v [{b * hkv},{s},{d}] bf16, causal, window {w} "
               f"({window_pairs(s, w)} query-key pairs a head); library: "
               "sdpa with the windowed mask",
               lambda: k7.flash_fwd(q, k, v, causal=True, window=w),
               lambda: flash_attention_ref(q, k, v, causal=True, window=w),
               lambda: F.scaled_dot_product_attention(
                   q4, k4.expand(-1, hq, -1, -1), v4.expand(-1, hq, -1, -1),
                   attn_mask=mask),
               2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * s,
               4 * b * hq * d * window_pairs(s, w), reps=5, err=err,
               flops_per_s=BF16_TC_FLOPS, iters=10)
    del q, k, v, o, po, q4, k4, v4
    # (c) an odd length in f32 with GQA g = 2
    held("(c)", *qkv(8, 4, args.attn_odd_seq, 64, torch.float32), "f32")
    # the D 64 route's edges: an encoder's self-attention (MHA, no causal
    # mask), then g = 2 with a window that no tile divides
    e = args.attn_edge_seq
    held("(d) g=1 non-causal", *qkv(4, 4, e, 64, torch.bfloat16), "bf16",
         causal=False)
    held("(d) g=2 window 300", *qkv(4, 2, e, 64, torch.bfloat16), "bf16",
         window=300)
    # (d) granite-moe-3b-a800m prefill: B 2, Hq 24, Hkv 8, D 64, S 4096,
    # causal (the wgmma route of D 64)
    hq, hkv, d = granite_attn_shape(args)
    q, k, v = qkv(b * hq, b * hkv, s, d, torch.bfloat16)
    o, po = held("(d)", q, k, v, "bf16")
    err = (o.float() - po.float()).abs().max().item()
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, k, v))
    pairs = s * (s + 1) // 2                   # causal (query, key) pairs
    shape_line("flash_fwd", f"{args.granite_arch} prefill: q [{b * hq},{s},"
               f"{d}], k/v [{b * hkv},{s},{d}] bf16, causal; library: sdpa",
               lambda: k7.flash_fwd(q, k, v, causal=True),
               lambda: flash_attention_ref(q, k, v, causal=True),
               lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=True, enable_gqa=True),
               2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * s,
               4 * b * hq * d * pairs, reps=5, err=err,
               flops_per_s=BF16_TC_FLOPS, iters=10)
    del q, k, v, o, po, q4, k4, v4

    # (e) seamless's three shapes at D 64 and pixtral's at D 128
    def prefill_shape(label, bh, bkv, sq, sk, d, causal):
        q, = randn_heads(g, dev, (bh,), sq, d, torch.bfloat16)
        k, v = randn_heads(g, dev, (bkv, bkv), sk, d, torch.bfloat16)
        o, po = held(f"(e) {label}", q, k, v, "bf16", causal=causal)
        err = (o.float() - po.float()).abs().max().item()
        q4, k4, v4 = (t.view(b, -1, t.shape[1], d) for t in (q, k, v))
        shape_line("flash_fwd", f"{label} prefill: q [{bh},{sq},{d}], k/v "
                   f"[{bkv},{sk},{d}] bf16, "
                   f"{'causal' if causal else 'non-causal'}; library: sdpa",
                   lambda: k7.flash_fwd(q, k, v, causal=causal),
                   lambda: flash_attention_ref(q, k, v, causal=causal),
                   lambda: F.scaled_dot_product_attention(
                       q4, k4, v4, is_causal=causal, enable_gqa=True),
                   2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * bh * sq,
                   4 * bh * d * attn_pairs(sq, sk, causal), reps=5, err=err,
                   flops_per_s=BF16_TC_FLOPS, iters=10)

    for shape in encdec_attn_shapes(args, b):
        prefill_shape(*shape)
    # (f) a causal query offset (a shard of sequence-parallel attention) on
    # every route, then timed at minitron-4b's last shard of a model axis
    # of 16: q [48, 256, 128] at q_pos0 3840 over k/v [16, 4096, 128]
    for label, d, dt in OFFSET_ROUTES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        for sq, sk, p in OFFSET_CASES:
            q, = randn_heads(g, dev, (6,), sq, d, dtype)
            k, v = randn_heads(g, dev, (2, 2), sk, d, dtype)
            held(f"(f) {label} offset", q, k, v, dt, q_pos0=p)
    hq, hkv, d = lm_attn_shape(args)
    n, p = shard_shape(args)
    q, = randn_heads(g, dev, (b * hq,), n, d, torch.bfloat16)
    k, v = randn_heads(g, dev, (b * hkv, b * hkv), s, d, torch.bfloat16)
    o, po = held("(f) minitron-4b's last seq shard", q, k, v, "bf16",
                 q_pos0=p)
    err = (o.float() - po.float()).abs().max().item()
    q4, k4, v4 = (t.view(b, -1, t.shape[1], d) for t in (q, k, v))
    mask = causal_mask(n, s, p, dev)

    def sdpa_shard():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)

    print(f"flash_fwd (f) yardstick: sdpa with the explicit causal mask "
          f"[{n},{s}] took {sdpa_backend(sdpa_shard)}")
    shape_line("flash_fwd", f"{args.lm_arch} last seq shard of "
               f"{args.seq_shards}: q [{b * hq},{n},{d}] at q_pos0 {p}, k/v "
               f"[{b * hkv},{s},{d}] bf16, causal ({attn_pairs(n, s, True, p)}"
               " query-key pairs a head); library: sdpa with the explicit "
               "causal mask",
               lambda: k7.flash_fwd(q, k, v, causal=True, q_pos0=p),
               lambda: flash_attention_ref(q, k, v, causal=True, q_pos0=p),
               sdpa_shard,
               2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * n,
               4 * b * hq * d * attn_pairs(n, s, True, p), reps=5, err=err,
               flops_per_s=BF16_TC_FLOPS, iters=10)
    del q, k, v, o, po, q4, k4, v4
    # (a) minitron-4b prefill: B 2, Hq 24, Hkv 8, D 128, S 4096, causal
    hq, hkv, d = lm_attn_shape(args)
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


def attention_bwd_kernel(args, record, shape_line, g, dev):
    """K8 against its plain version on K7's own ``o`` and ``lse``, twice
    (the bits must repeat), at (a) minitron-4b's training shape (timed,
    with ``scaled_dot_product_attention``'s backward as the yardstick), (b)
    recurrentgemma's local attention at an S no tile divides and at its
    training shape (timed, under the kernel's ``shapes``, with ``sdpa``'s
    backward under the windowed mask as the yardstick), (c) an odd f32
    length with GQA, (d) granite-moe-3b-a800m's training shape at D 64
    (timed under ``shapes``, with ``sdpa``'s backward as the yardstick)
    and K7's two D 64 edges at ``attn_edge_seq``, (e) the
    encoder-decoder's and the vision prefix's training shapes
    (:func:`encdec_attn_shapes` at batch 1: the cross-attention's dk and
    dv are the encoder's 512 keys), timed under ``shapes`` as (d), each
    with the form of the D 64 kernels that ran and its device kernels a
    call, then the short form at the edges of its dk/dv split
    (:data:`K8_SHORT_EDGES`); (f) a
    causal query offset on every route as K7's, the ``dk`` / ``dv`` of the
    keys no query sees 0, then minitron-4b's last sequence-parallel shard
    timed under ``shapes`` with ``sdpa``'s backward under the explicit
    causal mask as the yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k78
    from repro_torch.kernels.ref import (BF16_GRAD_RULE,
                                         flash_attention_bwd_ref,
                                         grad_row_error)

    def inputs(bh, bkv, s, d, dtype, window=None, causal=True, sk=None,
               q_pos0=0):
        return flash_bwd_inputs(g, dev, bh, bkv, s, d, dtype, window, causal,
                                sk, q_pos0)

    def held(case, ins, dtype, window=None, causal=True, q_pos0=0):
        got = k78.flash_bwd(*ins, causal=causal, window=window,
                            q_pos0=q_pos0)
        again = k78.flash_bwd(*ins, causal=causal, window=window,
                              q_pos0=q_pos0)
        want = flash_attention_bwd_ref(*ins, causal=causal, window=window,
                                       q_pos0=q_pos0)
        errs = []
        seen = q_pos0 + ins[0].shape[1]        # keys past it: no query
        for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
            check(torch.equal(x, y), f"flash_bwd {case} {name}: two "
                  "launches differ")
            if name != "dq" and causal:
                check(not x[:, seen:].any(), f"flash_bwd {case} {name}: "
                      f"the keys from {seen} on, which no query sees, are "
                      "not 0")
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
              f"{list(k.shape)} {dtype}, causal {causal}, window {window}"
              + (f", q_pos0 {q_pos0}" if q_pos0 else "")
              + (f" (dk/dv of keys {seen}+ all 0)"
                 if seen < k.shape[1] and causal else "")
              + ": max abs err "
              + ", ".join(errs) + "; two launches bit-identical")
        return (torch.cat([x.float().flatten() for x in got]),
                torch.cat([x.float().flatten() for x in want]))

    # (b) recurrentgemma's local attention: Hq 16, Hkv 1, D 256, window
    # 2048, at an S no tile divides, then at its training shape (B 1)
    rq, rkv, rd, w = rg_attn_shape()
    held("(b)", inputs(rq, rkv, args.attn_bwd_local_seq, rd, torch.bfloat16,
                       w), "bf16", window=w)
    s = args.attn_seq
    ins = inputs(rq, rkv, s, rd, torch.bfloat16, w)
    got, want = held("(b) at training", ins, "bf16", window=w)
    err = (got - want).abs().max().item()
    del got, want
    q, k, v, o, lse, do = ins
    q4, k4, v4 = (t.detach().view(1, -1, s, rd).requires_grad_()
                  for t in (q, k, v))
    do4, mask = do.view(1, rq, s, rd), window_mask(s, w, dev)

    def sdpa_w():
        return F.scaled_dot_product_attention(
            q4, k4.expand(-1, rq, -1, -1), v4.expand(-1, rq, -1, -1),
            attn_mask=mask)

    shape_line("flash_bwd", f"recurrentgemma-9b training: q/o/do "
               f"[{rq},{s},{rd}], k/v [{rkv},{s},{rd}] bf16, causal, window "
               f"{w} ({window_pairs(s, w)} query-key pairs a head); library: "
               "sdpa with the windowed mask, forward + backward minus "
               "forward",
               lambda: k78.flash_bwd(*ins, causal=True, window=w),
               lambda: flash_attention_bwd_ref(*ins, causal=True, window=w),
               lambda: torch.autograd.grad(sdpa_w(), (q4, k4, v4), do4),
               2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
               5 * 2 * rq * rd * window_pairs(s, w), reps=5, err=err,
               flops_per_s=BF16_TC_FLOPS, lib_minus=sdpa_w, iters=10)
    del ins, q, k, v, o, lse, do, q4, k4, v4
    # (c) an odd length in f32 with GQA g = 2
    held("(c)", inputs(8, 4, args.attn_odd_seq, 64, torch.float32), "f32")
    # the D 64 route's edges, as K7's
    e = args.attn_edge_seq
    held("(d) g=1 non-causal", inputs(4, 4, e, 64, torch.bfloat16,
                                      causal=False), "bf16", causal=False)
    held("(d) g=2 window 300", inputs(4, 2, e, 64, torch.bfloat16, 300),
         "bf16", window=300)
    # (d) granite-moe-3b-a800m training: B 1, Hq 24, Hkv 8, D 64, S 4096
    (gq, gkv, gd), s = granite_attn_shape(args), args.attn_seq
    ins = inputs(gq, gkv, s, gd, torch.bfloat16)
    got, want = held("(d)", ins, "bf16")
    err = (got - want).abs().max().item()
    del got, want
    q, k, v, o, lse, do = ins
    q4, k4, v4 = (t.detach().view(1, -1, s, gd).requires_grad_()
                  for t in (q, k, v))
    do4 = do.view(1, gq, s, gd)

    def sdpa_g():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    shape_line("flash_bwd", f"{args.granite_arch} training: q/o/do "
               f"[{gq},{s},{gd}], k/v [{gkv},{s},{gd}] bf16, causal; "
               "library: sdpa, forward + backward minus forward",
               lambda: k78.flash_bwd(*ins, causal=True),
               lambda: flash_attention_bwd_ref(*ins, causal=True),
               lambda: torch.autograd.grad(sdpa_g(), (q4, k4, v4), do4),
               2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
               5 * 2 * gq * gd * (s * (s + 1) // 2), reps=5, err=err,
               flops_per_s=BF16_TC_FLOPS, lib_minus=sdpa_g, iters=10)
    del ins, q, k, v, o, lse, do, q4, k4, v4

    # (e) seamless's three shapes at D 64 and pixtral's at D 128, batch 1,
    # each with the form of K8 that ran and its device kernels a call (at
    # D 64 and at most SHORT_KEYS keys the short form must run); then the
    # short form at the edges of its dk/dv split
    def training_shape(label, bh, bkv, sq, sk, d, causal):
        ins = inputs(bh, bkv, sq, d, torch.bfloat16, causal=causal, sk=sk)
        got, want = held(f"(e) {label}", ins, "bf16", causal=causal)
        err = (got - want).abs().max().item()
        del got, want
        kernels = device_kernels(lambda: k78.flash_bwd(*ins, causal=causal))
        form = bwd_form(kernels)
        splits = k78.dkv_splits(bkv, sk, bh // bkv, d, torch.bfloat16,
                                torch.cuda.get_device_properties(
                                    dev).multi_processor_count, sq=sq)
        print(f"flash_bwd (e) {label}: form {form}, dk/dv split "
              f"{splits} ways; device kernels a call: "
              + ", ".join(f"{n} x{c:g}" for n, c in kernels.items()))
        if d == 64 and sk <= k78.SHORT_KEYS and form != "not measured":
            check(form == "short", f"flash_bwd (e) {label}: form {form} "
                  f"at {sk} keys")
        q, k, v, o, lse, do = ins
        q4, k4, v4 = (t.detach().view(1, -1, t.shape[1], d).requires_grad_()
                      for t in (q, k, v))
        do4 = do.view(1, bh, sq, d)

        def sdpa_e():
            return F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, enable_gqa=True)

        shape_line("flash_bwd", f"{label} training: q/o/do [{bh},{sq},{d}], "
                   f"k/v [{bkv},{sk},{d}] bf16, "
                   f"{'causal' if causal else 'non-causal'}; library: sdpa, "
                   "forward + backward minus forward",
                   lambda: k78.flash_bwd(*ins, causal=causal),
                   lambda: flash_attention_bwd_ref(*ins, causal=causal),
                   lambda: torch.autograd.grad(sdpa_e(), (q4, k4, v4), do4),
                   2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                   5 * 2 * bh * d * attn_pairs(sq, sk, causal), reps=5,
                   err=err, flops_per_s=BF16_TC_FLOPS, lib_minus=sdpa_e,
                   iters=10)

    for shape in encdec_attn_shapes(args, args.lm_train_batch):
        training_shape(*shape)
    for label, bh, bkv, sq, sk in K8_SHORT_EDGES:
        held(f"(e) short form, {label}", inputs(bh, bkv, sq, 64,
                                                torch.bfloat16, causal=False,
                                                sk=sk), "bf16", causal=False)
    # (f) a causal query offset on every route, as K7's, then timed at
    # minitron-4b's last shard of a model axis of 16 (K7's shape)
    for label, d, dt in OFFSET_ROUTES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        for sq, sk, p in OFFSET_CASES:
            held(f"(f) {label} offset", inputs(6, 2, sq, d, dtype, sk=sk,
                                              q_pos0=p), dt, q_pos0=p)
    (hq, hkv, d), s = lm_attn_shape(args), args.attn_seq
    n, p = shard_shape(args)
    b = args.lm_batch
    ins = inputs(b * hq, b * hkv, n, d, torch.bfloat16, sk=s, q_pos0=p)
    got, want = held("(f) minitron-4b's last seq shard", ins, "bf16",
                     q_pos0=p)
    err = (got - want).abs().max().item()
    del got, want
    q, k, v, o, lse, do = ins
    q4, k4, v4 = (t.detach().view(b, -1, t.shape[1], d).requires_grad_()
                  for t in (q, k, v))
    do4, mask = do.view(b, hq, n, d), causal_mask(n, s, p, dev)

    def sdpa_f():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)

    print("flash_bwd (f) yardstick: sdpa with the explicit causal mask, "
          "forward + backward, took " + sdpa_backend(
              lambda: torch.autograd.grad(sdpa_f(), (q4, k4, v4), do4)))
    shape_line("flash_bwd", f"{args.lm_arch} last seq shard of "
               f"{args.seq_shards}: q/o/do [{b * hq},{n},{d}] at q_pos0 {p}, "
               f"k/v [{b * hkv},{s},{d}] bf16, causal "
               f"({attn_pairs(n, s, True, p)} query-key pairs a head); "
               "library: sdpa with the explicit causal mask, forward + "
               "backward minus forward",
               lambda: k78.flash_bwd(*ins, causal=True, q_pos0=p),
               lambda: flash_attention_bwd_ref(*ins, causal=True, q_pos0=p),
               lambda: torch.autograd.grad(sdpa_f(), (q4, k4, v4), do4),
               2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
               5 * 2 * b * hq * d * attn_pairs(n, s, True, p), reps=5,
               err=err, flops_per_s=BF16_TC_FLOPS, lib_minus=sdpa_f,
               iters=10)
    del ins, q, k, v, o, lse, do, q4, k4, v4
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

def declare(args, cfg, etc=None):
    """``cfg``'s recipe graph (DLRM, DCN, WDL or DeepFM) through the port's
    graph API; with ``etc`` (an ``ETCParams``) its ``fit()`` trains
    through the Embedding Training Cache."""
    from repro_torch.api import CreateSolver, DataReaderParams, recipe_graph
    return recipe_graph(cfg, solver=CreateSolver(
        batch_size=args.train_batch, lr=args.lr, seed=args.seed, etc=etc),
        reader=DataReaderParams(num_dense_features=cfg.num_dense_features,
                                seed=args.seed))


#: each in-memory fit of :func:`train_phase` by config name: its losses
#: and step p50 (ms), which phase 6d's ETC fit is held against
FIT_HISTORY = {}


#: device kernels by kind, by a piece of their name (first match wins); K1
#: and K5 run one kernel (the unscaled pooled read), so the profile names
#: them together and :func:`profile` prints each wrapper's launches
KINDS = (("K7", ("flash_fwd",)), ("K8", ("flash_bwd",)),
         ("K6", ("pooled_read_kernel<signed char, true",
                 "pooled_read_kernel<__half, true")),
         ("K1/K5", ("pooled_read_kernel",)), ("K3", ("lookup_bwd_",)),
         ("K2", ("interaction_fwd_kernel",)),
         ("K4", ("interaction_bwd_kernel",)),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet")), ("fill", ("Fill",)),
         ("sort", ("radix", "Radix", "sort")), ("reduce", ("reduce_kernel",)),
         ("copy", ("copy", "Memcpy")), ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    for k, keys in KINDS:
        if any(key in name for key in keys):
            return k
    return "other"


def profile(label: str, fn, host_top: int = 0) -> None:
    """Where one call's time goes: its host wall time against the device's
    busy time in it (the sum of kernel times from ``torch.profiler``), the
    busy time by kind of kernel, the top kernels, the launches of each
    kernel wrapper (``_build.LAUNCHES``) in the call and, with
    ``host_top``, that many host ops by their own host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.kernels._build import LAUNCHES
    torch.cuda.synchronize()
    before = LAUNCHES.snapshot()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    after = LAUNCHES.snapshot()
    wrappers = {k: n - before.get(k, 0) for k, n in sorted(after.items())
                if n != before.get(k, 0)}
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
          + "; top: " + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top)
          + f"; wrapper launches {wrappers}")
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        print(f"profile {label}: host ops by own host time: " + "; ".join(
            f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms x {e.count}"
            for e in ops[:host_top]))


def train_phase(args, dev, cfg, timed_steps: int):
    """fit() ``cfg`` at full width; returns the trained model and the
    launch counts of its run. Every step must launch K1 and K3 once for
    each planner group of every collection (the primary tables', the wide
    twins' of WDL and DeepFM, each extra group's of an N-group graph), and
    DLRM's K2 and K4 once."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.train.trainer import Trainer

    steps = args.warm_steps + timed_steps
    t0 = time.perf_counter()
    m = declare(args, cfg).compile(device=dev)
    colls = m.model.collections()
    print(f"train {cfg.name} groups: " + "; ".join(
        f"{key}: " + ", ".join(f"{k} {g.num_tables} tables {g.total_rows} "
                               f"rows at D {g.dim}"
                               for k, g in c.groups.items())
        for key, c in colls.items()))
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
          f"train {cfg.name}: {len(hist)} steps, losses {losses}")
    check(losses[-1] < losses[0],
          f"train {cfg.name}: loss did not fall: {losses}")
    groups = sum(len(c.groups) for c in colls.values())
    want = {"lookup_fwd": groups, "lookup_bwd": groups}
    if cfg.model == "dlrm":
        want.update(interaction_fwd=1, interaction_bwd=1)
    for i in range(steps):
        d = {k: per_step[i + 1].get(k, 0) - per_step[i].get(k, 0)
             for k in want}
        check(d == want, f"train {cfg.name} step {i}: launches {d}, want "
              f"{want} (K1 and K3 once per embedding group of "
              f"{list(colls)})")
    ms = [h["time"] * 1e3 for h in hist[args.warm_steps:]]
    p50 = float(np.median(ms))
    FIT_HISTORY[cfg.name] = {"losses": losses, "p50": p50}
    print(f"train {cfg.name} on {torch.cuda.get_device_name(0)}: {steps} "
          f"steps at batch {args.train_batch} ({args.warm_steps} warm-up) "
          f"in {time.perf_counter() - t0:.1f} s with set-up; step p50 "
          f"{p50:.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}), "
          f"{args.train_batch / p50 * 1e3:.0f} samples/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak memory "
          f"{peak:.2f} GiB; synthetic batch on the host p50 "
          f"{float(np.median(data_ms[args.warm_steps:])):.2f} ms of each "
          f"step; launches per step {want}; launches {launches}")

    # one more step, profiled, from the trained state (not kept)
    tr = Trainer(m.model, m.solver.to_train_config(), reader.batch)
    profile(f"{cfg.name} train step", lambda: tr.train(
        1, initial_state=(m.params, None)))
    del tr

    # the first steps again on the plain versions, from the same init
    plain = declare(args, cfg).compile(device=dev, use_kernels=False)
    ph = plain.fit(reader.batch, steps=args.plain_steps)
    err = max(abs(a["loss"] - b["loss"]) for a, b in zip(ph, hist))
    check(err <= TRAIN_TOL, f"train {cfg.name}: plain-version losses "
          f"{[h['loss'] for h in ph]} vs {losses[:args.plain_steps]}")
    print(f"train {cfg.name} plain versions: first {args.plain_steps} "
          f"losses within {err:.3g} of the kernel path (bound {TRAIN_TOL})")
    del plain, ph
    gc.collect()
    torch.cuda.empty_cache()
    return m, launches


def deploy_phase(args, m, bundle_dir):
    """Model.deploy() the trained model; returns what the serving checks
    need: the config, the bundle's PDB (every table, the wide twins and the
    extra groups' tables included) and the dense params."""
    from repro_torch.core.hps.persistent_db import PersistentDB
    from repro_torch.models.recsys.model import wide_tables
    t0 = time.perf_counter()
    server = m.deploy(bundle_dir, cache_capacity=args.cache_capacity,
                      max_batch=args.batch)
    server.close()
    pdb = PersistentDB(os.path.join(bundle_dir, "pdb"))
    tables = m.cfg.all_tables + (wide_tables(m.cfg) if m.model.wide
                                 is not None else ())
    for t in tables:
        pdb.open_table(m.name, t.name)
    rows = sum(t.vocab_size * t.dim for t in tables)
    print(f"deploy {m.name}: {len(tables)} trained tables ({rows * 4 / 1e9:.2f}"
          f" GB f32) written in {time.perf_counter() - t0:.1f} s")
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
                        for t in cfg.all_tables], axis=1).astype(np.int32)
        reqs.append((dense, cat))
    return reqs


def table_sets(cfg):
    """``(lookup key, tables, cat columns)`` of every HPS of ``cfg``'s
    bundle, in the server's order: the primary tables, the wide twins (the
    primary columns), then each extra group."""
    from repro_torch.models.recsys.model import has_wide, wide_tables
    n = len(cfg.tables)
    out = [("embedding", cfg.tables, (0, n))]
    if has_wide(cfg):
        out.append(("embedding", wide_tables(cfg), (0, n)))
    for g in cfg.extra_groups:
        out.append((f"embedding@{g.name}", g.tables, (n, n + len(g.tables))))
        n += len(g.tables)
    return out


def plain_predict(cfg, pdb, params, dev, dense, cat):
    """The plain path: pooled rows straight from the PDB memmap (every
    table set: the primary tables, a wide model's twins, each extra group's
    tables, each from its own ``cat`` columns), the dense net with the
    plain ops, then the sigmoid -> ``(probabilities, [rows of each table
    set, in the server's HPS order])``."""
    import numpy as np
    import torch
    from repro_torch.models.recsys.model import RecsysModel
    model = RecsysModel(cfg, device=dev, use_kernels=False)
    sets = table_sets(cfg)
    rows = [np.stack([pdb.fetch(cfg.name, t.name, cat[:, lo + ti, 0])
                      for ti, t in enumerate(ts)], axis=1)
            for _, ts, (lo, _) in sets]
    blocks = [torch.from_numpy(r).to(dev) for r in rows]
    wide = blocks[1] if model.wide is not None else None
    extras = dict(zip((g.name for g in cfg.extra_groups),
                      blocks[len(blocks) - len(cfg.extra_groups):])) or None
    with torch.no_grad():
        logit = model.apply_dense(params, torch.from_numpy(dense).to(dev),
                                  blocks[0], wide, extras=extras)
    return torch.sigmoid(logit).cpu().numpy(), rows


def serve_phase(args, ps_path, cfg, pdb, params, dev, payload_dtype,
                trained=None, submit: bool = True):
    """Serve the bundle: requests through ``submit`` on the stream engine
    (``submit``), then one at a time through ``predict``; with ``trained``
    (the api.Model that deployed it) the served predictions are also held
    against its ``predict``. Wide models serve through two HPSes, an
    N-group model through one an extra group more; one pooled read of each
    must be one launch."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.serve import build_server_from_config

    server, _ = build_server_from_config(ps_path, device=dev,
                                         payload_dtype=payload_dtype)
    hpses = [h for _, h in server._hpses()]
    keys = [k for k, _ in server._hpses()]
    warm = make_requests(args, cfg, args.warmup, 1)
    reqs = make_requests(args, cfg, args.requests, 2)
    try:
        for dense, cat in warm:                  # fill L1, warm the caches
            server.predict(dense, cat)
        server.reset_latencies()
        before = [{k: c.counters() for k, c in h.caches.items()}
                  for h in hpses]
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        if submit:
            server.start()
            handles = [server.submit(d, c) for d, c in reqs]
            preds = [h.get(timeout=600) for h in handles]
        else:
            preds = [server.predict(d, c) for d, c in reqs]
        # the cache query of each HPS's first table (K5 f32, K6 int8)
        firsts = [server._group_cat(reqs[0][1], k)[:, 0, 0].astype(np.int64)
                  for k in keys]
        probes = [h.caches[h.tables[0].name].query(ids)
                  for h, ids in zip(hpses, firsts)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES.snapshot()
        server.stop()
        for p in preds:
            if isinstance(p, Exception):
                raise p
        after = [{k: c.counters() for k, c in h.caches.items()}
                 for h in hpses]
        hit = []
        for b4, af in zip(before, after):
            hits = sum(af[k]["hits"] - b4[k]["hits"] for k in af)
            miss = sum(af[k]["misses"] - b4[k]["misses"] for k in af)
            hit.append(hits / max(1, hits + miss))
        pct = server.latency_percentiles()      # queueing in, for submit
        server.reset_latencies()
        for dense, cat in reqs[:8]:             # again, one at a time
            server.predict(dense, cat)
        seq = server.latency_percentiles()
        profile(f"{cfg.name} predict",
                lambda: server.predict(*reqs[8 % len(reqs)]))

        # predictions against the plain path
        err = 0.0
        for (dense, cat), p in zip(reqs, preds):
            check(p.shape == (args.batch,) and np.isfinite(p).all(),
                  f"{cfg.name} {payload_dtype}: bad prediction block "
                  f"{p.shape}")
            want, _ = plain_predict(cfg, pdb, params, dev, dense, cat)
            err = max(err, float(np.abs(p - want).max()))
        tol = SERVE_TOL[payload_dtype]
        check(err <= tol, f"{cfg.name} {payload_dtype}: served predictions "
              f"deviate {err} from the plain path (bound {tol})")
        trained_err = None
        if trained is not None:
            trained_err = max(
                float(np.abs(p - trained.predict(
                    {"dense": d, "cat": c})).max())
                for (d, c), p in zip(reqs, preds))
            check(trained_err <= TRAIN_TOL, f"{cfg.name} {payload_dtype}: "
                  f"served predictions deviate {trained_err} from the "
                  f"trained Model.predict (bound {TRAIN_TOL})")
        # the pooled L1 read of each HPS: one launch, bit-exact for f32,
        # within half a quantization step for int8
        dense, cat = reqs[-1]
        pooled_k = ("lookup_fwd" if payload_dtype == "f32"
                    else "dequant_gather_rows")
        _, rows = plain_predict(cfg, pdb, params, dev, dense, cat)
        one_read = []
        for h, key, emb, probe, ids in zip(hpses, keys, rows, probes,
                                           firsts):
            LAUNCHES.reset()
            got = h.lookup(server._group_cat(cat, key))
            torch.cuda.synchronize()
            one_read.append(LAUNCHES.snapshot())
            check(one_read[-1] == {pooled_k: 1}, f"{cfg.name} "
                  f"{payload_dtype}: one pooled read of {len(h.tables)} "
                  f"tables at D {h.tables[0].dim} launched {one_read[-1]}, "
                  f"want one {pooled_k}")
            got = got.cpu().numpy()
            if payload_dtype == "f32":
                check(np.array_equal(got, emb), f"{cfg.name}: f32 L1 read "
                      f"at D {h.tables[0].dim} is not bit-exact")
            else:
                step = np.abs(emb).max(axis=2, keepdims=True) / 127.0
                check(bool((np.abs(got - emb) <= 0.5 * step + 1e-6).all()),
                      f"{cfg.name}: int8 L1 read at D {h.tables[0].dim} "
                      "exceeds half a quantization step")
            want_rows = pdb.fetch(cfg.name, h.tables[0].name, ids)
            check(np.abs(probe.cpu().numpy() - want_rows).max() <= (
                0 if payload_dtype == "f32" else
                np.abs(want_rows).max() / 254 + 1e-6),
                f"{cfg.name}: DeviceEmbeddingCache.query rows disagree "
                "with the PDB")
    finally:
        server.close()
    # f32 reads go through K1 (pooled) and K5 (the cache query); int8
    # reads through K6 for both
    need = (["lookup_fwd", "gather_rows"] if payload_dtype == "f32"
            else ["dequant_gather_rows"])
    if cfg.model == "dlrm":
        need.append("interaction_fwd")
    for k in need:
        check(launches.get(k, 0) > 0,
              f"{cfg.name} {payload_dtype}: kernel {k} was not launched on "
              f"the main path (counts {launches})")
    how = (f"through submit (per-group p50 {pct['p50']:.2f} ms, p99 "
           f"{pct['p99']:.2f} ms, queueing included)" if submit else
           f"through predict (p50 {pct['p50']:.2f} ms)") \
        + "; the first 8 again through predict"
    print(f"serve {cfg.name} {payload_dtype} on "
          f"{torch.cuda.get_device_name(0)}: {len(reqs)} requests x "
          f"{args.batch} rows in {wall:.2f} s {how}: p50 "
          f"{seq['p50']:.2f} ms; L1 hit rate "
          + ", ".join(f"{len(h.tables)} x D {h.tables[0].dim} HPS {r:.4f}"
                      for h, r in zip(hpses, hit))
          + f"; max |p - plain| {err:.3g} (bound {tol}); one pooled read "
          f"a HPS: launches {one_read}"
          + ("" if trained_err is None else
             f"; max |p - Model.predict| {trained_err:.3g} (bound "
             f"{TRAIN_TOL})") + f"; launches {launches}")
    return launches, err


# ---------------------------------------------------------------------------
# phase 6b: DLRM's online path: the striped L1, online updates, resize
# ---------------------------------------------------------------------------

def launches_of(fn):
    """``fn()`` and the kernel launches it made (differences of the
    counts, so a caller's counting is left alone)."""
    import torch
    from repro_torch.kernels._build import LAUNCHES
    before = LAUNCHES.snapshot()
    out = fn()
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    return out, {k: n - before.get(k, 0) for k, n in sorted(after.items())
                 if n != before.get(k, 0)}


def counted(total, fn):
    """``fn()`` as a main path: the launch counts set to 0 just before it
    and added to ``total`` just after."""
    import torch
    from repro_torch.kernels._build import LAUNCHES
    torch.cuda.synchronize()
    LAUNCHES.reset()
    out = fn()
    torch.cuda.synchronize()
    for k, n in LAUNCHES.snapshot().items():
        total[k] = total.get(k, 0) + n
    return out


def striped_ps(ps_path: str, shards: int) -> str:
    """A ps.json beside ``ps_path`` for the same bundle with its L1 striped
    ``shards`` ways (the bundle's ``cache_shards``)."""
    with open(ps_path) as f:
        d = json.load(f)
    d["cache_shards"] = shards
    out = os.path.join(os.path.dirname(ps_path), f"ps_striped{shards}.json")
    with open(out, "w") as f:
        json.dump(d, f, indent=1)
    return out


def hot_ids(args, cfg) -> list:
    """Each table's ``args.online_ids`` hottest ids (the Zipf draws are
    frequency-ranked: id r is the r-th hottest), fewer where the
    vocabulary is smaller."""
    import numpy as np
    return [np.arange(min(args.online_ids, t.vocab_size)) for t in cfg.tables]


def probe_cat(args, cfg, hot) -> "np.ndarray":
    """One ``[online_ids, T, 1]`` batch over every table's hot ids (a
    table with fewer hot ids repeats them)."""
    import numpy as np
    n = args.online_ids
    return np.stack([h[np.arange(n) % len(h)] for h in hot],
                    axis=1)[:, :, None].astype(np.int32)


def striped_check(args, ps, ps2, cfg, dev, payload_dtype, total):
    """The same requests through the unstriped and the 2-way striped L1 on
    the one card: equal predictions and launches, a pooled read of the 26
    tables one K1 (f32) or K6 (int8) launch and bit-exact, the cache query
    (K5 / K6) bit-exact; then each kernel on the stripes' flat view against
    its plain version on the same card tensors."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_lookup import lookup_fwd_grouped_plain
    from repro_torch.kernels.hps_gather import (
        dequant_gather_grouped_plain, dequant_gather_rows_plain,
        gather_rows_plain)
    from repro_torch.launch.serve import build_server_from_config
    f32 = payload_dtype == "f32"
    pooled_k = "lookup_fwd" if f32 else "dequant_gather_rows"
    query_k = "gather_rows" if f32 else "dequant_gather_rows"
    flat, _ = build_server_from_config(ps, device=dev,
                                       payload_dtype=payload_dtype)
    striped, _ = build_server_from_config(ps2, device=dev,
                                          payload_dtype=payload_dtype)
    reqs = make_requests(args, cfg, args.warmup + 4, 3)
    try:
        check(all(c.shards == 2 for c in striped.hps.caches.values()),
              "the striped bundle did not stripe the L1")

        def serve():
            per_batch = []
            for dense, cat in reqs:
                (a, la), (b, lb) = [launches_of(lambda s=s: s.predict(
                    dense, cat)) for s in (flat, striped)]
                check(np.array_equal(a, b), f"{payload_dtype}: striped "
                      "predictions differ from the unstriped ones")
                check(la == lb, f"{payload_dtype}: a striped batch "
                      f"launched {lb}, the unstriped one {la}")
                per_batch.append(lb)
            cat = reqs[-1][1]
            ids = cat[:, 0, 0].astype(np.int64)
            out = []
            for s in (flat, striped):
                read, lr = launches_of(lambda: s.hps.lookup(cat))
                check(lr == {pooled_k: 1}, f"{payload_dtype}: one pooled "
                      f"read of 26 tables launched {lr}, want one "
                      f"{pooled_k}")
                rows, lq = launches_of(
                    lambda: s.hps.caches[cfg.tables[0].name].query(ids))
                check(lq == {query_k: 1}, f"{payload_dtype}: one cache "
                      f"query launched {lq}, want one {query_k}")
                out.append((read, rows))
            check(torch.equal(out[0][0], out[1][0]) and torch.equal(
                out[0][1], out[1][1]), f"{payload_dtype}: striped L1 reads "
                "are not bit-exact to the unstriped ones")
            return per_batch

        per_batch = counted(total, serve)
        # each kernel on the flat view against its plain version
        cat = reqs[-1][1]
        pays, slots = [], []
        for ti, t in enumerate(cfg.tables):
            cache = striped.hps.caches[t.name]
            plan = cache.probe(cat[:, ti, 0].astype(np.int64))
            snap = cache.commit(plan)
            pays.append(ops.striped_view(snap))
            slots.append(torch.from_numpy(ops.flatten_striped_slots(
                snap[0], plan.slots.astype(np.int32)).reshape(-1, 1)).to(
                    dev))
        got = ops.grouped_pooled_lookup(pays, slots)
        if f32:
            want = lookup_fwd_grouped_plain([p for p, _ in pays], slots)
            rows = ops.cache_gather(pays[0][0], slots[0].view(-1))
            want_rows = gather_rows_plain(pays[0][0], slots[0].view(-1))
        else:
            want = dequant_gather_grouped_plain(
                [p for p, _ in pays], [sc for _, sc in pays], slots)
            rows = ops.cache_gather(pays[0][0], slots[0].view(-1),
                                    scales=pays[0][1])
            want_rows = dequant_gather_rows_plain(
                pays[0][0], pays[0][1], slots[0].view(-1))
        check(torch.equal(got, want) and torch.equal(rows, want_rows),
              f"{payload_dtype}: a kernel on the striped flat view is not "
              "bit-exact to its plain version")
    finally:
        flat.close()
        striped.close()
    print(f"online striped {payload_dtype}: {len(reqs)} batches served from "
          "the unstriped and the 2-way striped L1 on one card: predictions "
          "equal, launches per batch equal "
          f"({per_batch[-1]}); one pooled read {{'{pooled_k}': 1}} and one "
          f"query {{'{query_k}': 1}} a read, bit-exact to the unstriped "
          "store; the kernels on the flat view bit-exact to their plain "
          "versions")


def online_phase(args, ps, cfg, pdb, params, dev, total):
    """DLRM's online path, served from its bundle at full width on the one
    card: the striped L1 against the unstriped one (f32 and int8); then,
    on a 2-way striped f32 L1 with a ``MessageBus``, ``submit`` traffic
    while a ``Producer`` publishes new rows for every table's hottest ids
    at versions 1..N: each version's publish -> visible lag, the ``predict``
    p50 with and without the update stream, the rows refreshed, the L1
    hit rate and ``refresh_step``'s host and device time with a full
    backlog; the served predictions against the plain path from the
    updated PDB; an int8 L1 on the same bus requantizes its refreshed rows
    from the f32 lower levels; and ``resize_caches`` to half the capacity
    keeps the hottest rows. Adds the launches of its served paths to
    ``total``."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core.hps.message_bus import MessageBus, Producer
    from repro_torch.launch.serve import build_server_from_config

    ps2 = striped_ps(ps, 2)
    for pd in ("f32", "int8"):
        striped_check(args, ps, ps2, cfg, dev, pd, total)

    bus = MessageBus()
    server, _ = build_server_from_config(ps2, device=dev, bus=bus)
    server8, _ = build_server_from_config(ps2, device=dev, bus=bus,
                                          payload_dtype="int8")
    hps = server.hps
    hot = hot_ids(args, cfg)
    probe = probe_cat(args, cfg, hot)
    reqs = make_requests(args, cfg, 16, 4)
    warm = make_requests(args, cfg, args.warmup, 1)
    rng = np.random.default_rng((args.seed, 21))
    published = []                   # per version: [rows of each table]
    lags = []
    records = []                     # (done time, latency ms)
    stop = threading.Event()
    errors = []

    def traffic():
        """Closed-loop requests through ``submit``: one in flight."""
        try:
            for dense, cat in itertools.cycle(reqs):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                out = server.submit(dense, cat).get(timeout=600)
                if isinstance(out, Exception):
                    raise out
                records.append((time.perf_counter(), 1e3 * (
                    time.perf_counter() - t0)))
        except Exception as exc:     # surfaced by the main thread
            errors.append(exc)

    def p50(t_lo, t_hi):
        ms = [m for t, m in records if t_lo <= t < t_hi]
        return (float(np.percentile(ms, 50)), len(ms)) if ms else \
            (float("nan"), 0)

    def hit_counts(h):
        c = [c.counters() for c in h.caches.values()]
        return sum(x["hits"] for x in c), sum(x["misses"] for x in c)

    def expected(version_rows):
        """The probe batch's rows of one version, ``[n, T, D]`` on the
        card."""
        n = args.online_ids
        return torch.from_numpy(np.stack(
            [r[np.arange(n) % len(r)] for r in version_rows],
            axis=1)).to(dev)

    try:
        # both windows below see the same warm L1: the traffic's requests
        # and every hot id are resident before the first measured request
        for s in (server, server8):
            for dense, cat in warm + reqs:
                s.predict(dense, cat)
            s.hps.lookup(probe)
        resident = sum(int(np.isin(h, hps.caches[t.name].resident_ids())
                           .sum()) for h, t in zip(hot, cfg.tables))

        def updates():
            server.start()
            worker = threading.Thread(target=traffic, daemon=True)
            worker.start()
            h0 = hit_counts(hps)
            t_quiet = time.perf_counter()
            while len(records) < args.online_quiet and not errors and \
                    worker.is_alive():
                time.sleep(0.005)
            t_upd = time.perf_counter()
            h1 = hit_counts(hps)
            prod = Producer(bus, cfg.name, max_batch_rows=1 << 30)
            for v in range(1, args.online_versions + 1):
                rows = [(rng.standard_normal((len(h), cfg.embedding_dim))
                         * 0.3).astype(np.float32) for h in hot]
                want = expected(rows)
                for t, h, r in zip(cfg.tables, hot, rows):
                    prod.send(t.name, h, r)
                t_pub = time.perf_counter()
                prod.flush(version=v)
                t_applied = None
                # cheap polls (versions, backlog) until the loop has
                # drained the version, then a probe read to confirm: the
                # lag runs to the end of the first probe that matches
                while not errors:
                    check(time.perf_counter() - t_pub < 300, f"update "
                          f"version {v} not visible within 300 s")
                    seen = server.update_versions()
                    if t_applied is None and all(
                            seen.get(t.name, 0) >= v for t in cfg.tables):
                        t_applied = time.perf_counter()
                    if t_applied is not None and \
                            not hps.refresh_backlog() and \
                            torch.equal(hps.lookup(probe), want):
                        break
                    time.sleep(0.001)
                lags.append((1e3 * (t_applied - t_pub),
                             1e3 * (time.perf_counter() - t_pub)))
                published.append(rows)
            t_done = time.perf_counter()
            n_done = len(records)
            while len(records) < n_done + 4 and not errors and \
                    worker.is_alive():
                time.sleep(0.005)       # a few requests after convergence
            stop.set()
            worker.join(timeout=600)
            server.stop()
            check(not errors, f"online traffic failed: {errors[:1]}")
            check(not worker.is_alive(), "online traffic did not stop")
            return h0, h1, t_quiet, t_upd, t_done

        h0, h1, t_quiet, t_upd, t_done = counted(total, updates)
        quiet, n_quiet = p50(t_quiet, t_upd)
        busy, n_busy = p50(t_upd, t_done)
        counters = server.counters()
        # the quiet window's traffic alone (the probes of the update
        # window read hot rows)
        hit = (h1[0] - h0[0]) / max(1, (h1[0] - h0[0]) + (h1[1] - h0[1]))

        # refresh_step with a full backlog: host wall and device time
        def step():
            hps.refresh_step(server.refresh_budget)
            torch.cuda.synchronize()

        hps.schedule_refresh()
        step_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        profile(f"dlrm-criteo refresh_step ({len(cfg.tables)} x "
                f"{server.refresh_budget} rows, full backlog)", step)

        # the updated PDB is the reference now
        for t, h, r in zip(cfg.tables, hot, published[-1]):
            check(np.array_equal(pdb.fetch(cfg.name, t.name, h), r),
                  f"{t.name}: the PDB does not hold the last update")
        check(torch.equal(hps.lookup(probe), expected(published[-1])),
              "the f32 L1 does not hold the last update")
        err = max(float(np.abs(server.predict(d, c) - plain_predict(
            cfg, pdb, params, dev, d, c)[0]).max()) for d, c in reqs[:4])
        check(err <= SERVE_TOL["f32"], f"online f32: served predictions "
              f"deviate {err} from the plain path on the updated PDB "
              f"(bound {SERVE_TOL['f32']})")

        # the int8 L1 on the same bus: its loop applies every version and
        # requantizes the refreshed rows from the f32 lower levels
        def int8_catch_up():
            server8.start()
            t0 = time.perf_counter()
            for dense, cat in itertools.cycle(reqs):
                out = server8.submit(dense, cat).get(timeout=600)
                if isinstance(out, Exception):
                    raise out
                seen = server8.update_versions()
                if all(seen.get(t.name, 0) >= args.online_versions
                       for t in cfg.tables) and \
                        not server8.hps.refresh_backlog():
                    break
                check(time.perf_counter() - t0 < 300, "the int8 L1 did "
                      "not catch up within 300 s")
            server8.stop()
            return 1e3 * (time.perf_counter() - t0)

        ms8 = counted(total, int8_catch_up)
        want = expected(published[-1])
        got8 = server8.hps.lookup(probe)
        step8 = want.abs().amax(dim=2, keepdim=True) / 127.0
        check(bool(((got8 - want).abs() <= step8 / 2 + 1e-6).all()),
              "online int8: refreshed rows exceed half a quantization step "
              "of the published f32 rows")
        err8 = max(float(np.abs(server8.predict(d, c) - plain_predict(
            cfg, pdb, params, dev, d, c)[0]).max()) for d, c in reqs[:4])
        check(err8 <= SERVE_TOL["int8"], f"online int8: served predictions "
              f"deviate {err8} from the plain path on the updated PDB "
              f"(bound {SERVE_TOL['int8']})")
        counters8 = server8.counters()

        # resize to half the capacity: the hottest rows stay
        half = args.cache_capacity // 2
        occupied = [len(hps.caches[t.name].resident_ids())
                    for t in cfg.tables]
        kept = hps.resize_caches(half)
        want_kept = sum(min(o, half) for o in occupied)
        check(kept == want_kept, f"resize kept {kept} rows, want "
              f"{want_kept}")
        check(all(np.isin(h, hps.caches[t.name].resident_ids()).all()
                  for h, t in zip(hot, cfg.tables)),
              "resize evicted one of the hottest rows")

        def after_resize():
            return [server.predict(d, c) for d, c in reqs[:4]]

        preds = counted(total, after_resize)
        err_r = max(float(np.abs(p - plain_predict(
            cfg, pdb, params, dev, d, c)[0]).max())
            for p, (d, c) in zip(preds, reqs[:4]))
        check(err_r <= SERVE_TOL["f32"], f"after resize: served predictions "
              f"deviate {err_r} from the plain path (bound "
              f"{SERVE_TOL['f32']})")
    finally:
        stop.set()
        server.close()
        server8.close()
    print(f"online dlrm-criteo on {torch.cuda.get_device_name(0)}: 2-way "
          f"striped f32 L1, refresh_budget {server.refresh_budget}; "
          f"{args.online_versions} versions of {args.online_ids} hottest "
          f"ids x {len(cfg.tables)} tables ({resident} of "
          f"{sum(len(h) for h in hot)} resident) under closed-loop submit "
          "traffic; publish -> applied / visible ms: "
          + ", ".join(f"v{i + 1} {a:.1f} / {b:.1f}"
                      for i, (a, b) in enumerate(lags))
          + f"; request p50 through submit (one in flight) {quiet:.2f} ms "
          f"quiet ({n_quiet} requests), {busy:.2f} ms under updates "
          f"({n_busy}); rows refreshed "
          f"{counters['rows_refreshed']}, updates applied "
          f"{counters['updates_applied']}; L1 hit rate {hit:.4f} (quiet "
          "window); "
          f"refresh_step host wall ms (full backlog, {len(cfg.tables)} "
          f"x {server.refresh_budget} rows): "
          + ", ".join(f"{m:.2f}" for m in step_ms)
          + f"; max |p - plain| on the updated PDB {err:.3g} (bound "
          f"{SERVE_TOL['f32']}); int8 L1 caught up in {ms8:.0f} ms, "
          f"{counters8['rows_refreshed']} rows requantized, max |p - plain| "
          f"{err8:.3g} (bound {SERVE_TOL['int8']}); resize to {half}: kept "
          f"{kept} rows, every hot id resident, max |p - plain| "
          f"{err_r:.3g}")


def online_fanout(args, ps, cfg, pdb, params, dev, total):
    """One update version on a bundle served by several HPSes (a wide
    model's two, an N-group model's one a group): new rows for the
    ``args.online_ids`` hottest ids of every table, published on a
    ``MessageBus`` while the server's loop runs. Each HPS's consumer
    writes EVERY message to its L2/L3 and marks only its own L1, as the
    reference's does, so ``updates_applied`` is messages x HPSes; every
    HPS's f32 L1 then reads the published rows of its own tables bit for
    bit."""
    import numpy as np
    import torch
    from repro_torch.core.hps.message_bus import MessageBus, Producer
    from repro_torch.launch.serve import build_server_from_config
    bus = MessageBus()
    server, _ = build_server_from_config(ps, device=dev, bus=bus)
    hpses = server._hpses()
    sets = table_sets(cfg)
    n = args.online_ids
    cols = cfg.all_tables
    probe = np.stack([np.arange(n) % min(n, t.vocab_size) for t in cols],
                     axis=1)[:, :, None].astype(np.int32)
    rng = np.random.default_rng((args.seed, 22))
    rows = {t.name: (rng.standard_normal((min(n, t.vocab_size), t.dim))
                     * 0.3).astype(np.float32)
            for _, ts, _ in sets for t in ts}
    try:
        for dense, cat in make_requests(args, cfg, args.warmup, 1):
            server.predict(dense, cat)
        prod = Producer(bus, cfg.name, max_batch_rows=1 << 30)
        for name, r in rows.items():
            prod.send(name, np.arange(len(r)), r)

        def run():
            server.start()
            t0 = time.perf_counter()
            prod.flush(version=1)
            while True:
                seen = server.update_versions()
                if all(seen.get(k, 0) >= 1 for k in rows) and not any(
                        h.refresh_backlog() for _, h in hpses):
                    break
                check(time.perf_counter() - t0 < 300, f"{cfg.name}: the "
                      "update was not applied within 300 s")
                time.sleep(0.002)
            server.stop()
            return 1e3 * (time.perf_counter() - t0)

        ms = counted(total, run)
        counters = server.counters()
        want_applied = len(rows) * len(hpses)
        check(counters["updates_applied"] == want_applied,
              f"{cfg.name}: {counters['updates_applied']} updates applied, "
              f"want {want_applied} ({len(rows)} messages x {len(hpses)} "
              "HPSes)")
        for (key, h), (_, ts, (lo, _)) in zip(hpses, sets):
            got = h.lookup(server._group_cat(probe, key))
            want = np.stack([rows[t.name][probe[:, lo + i, 0]]
                             for i, t in enumerate(ts)], axis=1)
            check(torch.equal(got, torch.from_numpy(want).to(dev)),
                  f"{cfg.name}: the f32 L1 of the {len(ts)} x D "
                  f"{ts[0].dim} HPS does not read the published rows")
    finally:
        server.close()
    print(f"online fan-out {cfg.name}: {len(rows)} messages (one version, "
          f"the {n} hottest ids of every table) through {len(hpses)} "
          f"HPSes: updates applied {counters['updates_applied']} (= "
          f"messages x HPSes: each HPS writes every table to its L2/L3, as "
          f"the reference's), rows refreshed {counters['rows_refreshed']}, "
          f"applied and refreshed in {ms:.0f} ms under the serving loop; "
          "every HPS's f32 L1 bit-exact to the published rows")


# ---------------------------------------------------------------------------
# phase 6c: the rest of the serving engine on DLRM's and DCN's bundles
# ---------------------------------------------------------------------------

def burst(submit, reqs):
    """Submit every request at once, then collect the handles in order:
    ``(outputs, delivered ms of each)``; a handle's delivery is read when
    its ``get`` returns (the handles resolve in order)."""
    sent = [(time.perf_counter(), submit(d, c)) for d, c in reqs]
    outs, ms = [], []
    for t0, h in sent:
        outs.append(h.get(timeout=600))
        ms.append(1e3 * (time.perf_counter() - t0))
    return outs, ms


def closed_loop(submit, reqs):
    """One request in flight: ``(outputs, ms of each)``; raises the first
    failed request's error."""
    outs, ms = [], []
    for d, c in reqs:
        t0 = time.perf_counter()
        out = submit(d, c).get(timeout=600)
        ms.append(1e3 * (time.perf_counter() - t0))
        if isinstance(out, BaseException):
            raise out
        outs.append(out)
    return outs, ms


def pct(ms, q) -> float:
    import numpy as np
    return float(np.percentile(ms, q)) if ms else float("nan")


def sync_window(fn):
    """``fn()`` with the hot-path twin armed and
    ``torch.cuda.set_sync_debug_mode("warn")`` on over the same window ->
    ``(output, twin summary, the syncs the debug mode reported, where)``."""
    import collections
    import warnings
    import torch
    from repro_torch.analysis import HotPathMonitor
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with HotPathMonitor() as mon:
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    where = collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:"
                                f"{w.lineno}" for w in syncs)
    return out, mon.summary(), len(syncs), dict(where)


def serving_engine_phase(args, dev, dlrm, dcn, total):
    """The rest of the serving engine, at full width on the one card: (a)
    DLRM through the ``stream``, ``sync`` and ``stage_sync`` engines (a
    burst of the measured requests after warm-up, then the same requests
    closed-loop; predictions equal bit for bit); (b) admission control under a burst of 64 (every handle
    resolves; delivered + shed + expired = 64), deadline batching against
    the fixed-batch arm; (c) ``deploy_ensemble([DLRM, DCN])`` rebuilt from
    its ``ps.json`` alone: members equal to their single-model servers,
    one K1 launch a batch, each member's p50 and hit rate, then traffic
    skewed to DLRM and ``rebalance_now()`` (predictions unchanged across
    the resize); (d) the hot-path twin and the sync debug mode over 16
    stream groups, DLRM alone and an ensemble member with admission on.
    ``dlrm`` / ``dcn`` are the trained ``api.Model``s, each deployed here
    to a single-model bundle of its trained tables (DLRM's first bundle
    took the online phase's updates). Adds the served paths' launches to
    ``total``. Returns what phase 6e serves: the ensemble's and DLRM's
    single-model ``ps.json``, the members' names and C, the rows/s of the
    stream engine's closed-loop run."""
    import numpy as np
    import torch
    from repro_torch.api import deploy_ensemble
    from repro_torch.launch.serve import build_server_from_config
    from repro_torch.serve.server import ENGINES, InferenceServer

    name = torch.cuda.get_device_name(0)
    cfg = dlrm.cfg
    single_ps = {}
    for m in (dlrm, dcn):
        d = os.path.join(ROOT, "_smoke_bundle", f"{m.name}-single")
        shutil.rmtree(d, ignore_errors=True)
        m.deploy(d, cache_capacity=args.cache_capacity,
                 max_batch=args.batch).close()
        single_ps[m.name] = os.path.join(d, "ps.json")
    dlrm_ps, dcn_ps = single_ps[dlrm.name], single_ps[dcn.name]
    warm = make_requests(args, cfg, args.warmup, 1)
    reqs = make_requests(args, cfg, args.requests, 2)

    def fresh(ps, engine="stream"):
        base, _ = build_server_from_config(ps, device=dev)
        return InferenceServer(base.model, base.dense_params, base.hps,
                               max_batch=args.batch, engine=engine)

    def release(*servers):
        for s in servers:
            s.close()
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the three engines
    eng = {}
    for engine in ENGINES:
        server = fresh(dlrm_ps, engine)
        try:
            server.start()
            closed_loop(server.submit, warm)
            server.reset_serving_stats()
            t0 = time.perf_counter()
            outs, ms = counted(total, lambda: burst(server.submit, reqs))
            wall = time.perf_counter() - t0
            check(all(isinstance(o, np.ndarray) for o in outs),
                  f"engine {engine}: a request failed: "
                  f"{[o for o in outs if not isinstance(o, np.ndarray)][:1]}")
            groups = server.latency_percentiles()
            again, one = counted(total, lambda: closed_loop(server.submit,
                                                            reqs))
            server.stop()
            check(all(np.array_equal(a, b) for a, b in zip(again, outs)),
                  f"engine {engine}: a request served twice differs")
            eng[engine] = (outs, ms, wall, groups, one)
        finally:
            release(server)
    for engine in ENGINES[1:]:
        check(all(np.array_equal(a, b) for a, b in
                  zip(eng[engine][0], eng["stream"][0])),
              f"engine {engine}: predictions differ from the stream "
              "engine's")
    rows = args.requests * args.batch
    print(f"engines dlrm-criteo f32 on {name}: a burst of {args.requests} "
          f"requests x {args.batch} rows after {args.warmup} warm-up, then "
          "the same requests closed-loop (one in flight, L1 warm), "
          "predictions equal bit for bit across engines; " + "; ".join(
              f"{e}: burst delivered p50 {pct(ms, 50):.2f} ms p99 "
              f"{pct(ms, 99):.2f} ms, per-group p50 {g['p50']:.2f} ms (from "
              f"the group's entry into the pipeline), {rows / wall:.0f} "
              f"rows/s; closed-loop p50 {pct(one, 50):.2f} ms p99 "
              f"{pct(one, 99):.2f} ms"
              for e, (_, ms, wall, g, one) in eng.items()))

    # (b) admission control under a burst of 64
    slo = 2 * pct(eng["stream"][4], 50)
    burst_reqs = [reqs[i % len(reqs)] for i in range(64)]
    server = fresh(dlrm_ps)
    arms = {}
    try:
        for deadline in (True, False):
            server.set_admission(queue_depth=8, slo_ms=slo,
                                 deadline_batching=deadline)
            server.start()
            closed_loop(server.submit, warm + reqs)    # both arms warm
            server.reset_serving_stats()
            outs, ms = counted(total, lambda: burst(server.submit,
                                                          burst_reqs))
            server.stop()
            c = server.counters()
            kinds = [type(o).__name__ for o in outs]
            delivered = [m for o, m in zip(outs, ms)
                         if isinstance(o, np.ndarray)]
            check(all(isinstance(o, (np.ndarray, Exception)) for o in outs),
                  "admission: a handle did not resolve")
            check(c["requests_delivered"] + c["requests_shed"]
                  + c["requests_expired"] == len(burst_reqs),
                  f"admission: delivered + shed + expired != "
                  f"{len(burst_reqs)} ({c})")
            check(kinds.count("ndarray") == c["requests_delivered"] and
                  kinds.count("ServerOverloaded") == c["requests_shed"]
                  + c["requests_expired"],
                  f"admission: handles {sorted(set(kinds))} disagree with "
                  f"the counters {c}")
            arms["deadline" if deadline else "fixed"] = (c, delivered)
    finally:
        release(server)
    print(f"admission dlrm-criteo on {name}: queue_depth 8, slo_ms "
          f"{slo:.2f} (2 x the stream engine's closed-loop p50), L1 warm "
          f"with the burst's {len(reqs)} distinct requests, a burst of "
          f"{len(burst_reqs)} requests x {args.batch} rows, every handle "
          "resolved; " + "; ".join(
              f"{arm}: delivered {c['requests_delivered']}, shed "
              f"{c['requests_shed']}, expired {c['requests_expired']}, SLO "
              f"violations {c['slo_violations']}, delivered p50 "
              f"{pct(d, 50):.2f} ms p99 {pct(d, 99):.2f} ms"
              for arm, (c, d) in arms.items()))

    # (c) the ensemble: deploy, rebuild from ps.json alone, rebalance
    ens_dir = os.path.join(ROOT, "_smoke_bundle", "ensemble")
    shutil.rmtree(ens_dir, ignore_errors=True)
    t0 = time.perf_counter()
    release(deploy_ensemble([dlrm, dcn], ens_dir,
                            cache_budget=2 * args.cache_capacity,
                            max_batch=args.batch))
    t_deploy = time.perf_counter() - t0
    ens, graphs = build_server_from_config(os.path.join(ens_dir, "ps.json"),
                                           device=dev,
                                           cache_budget=2 * args.cache_capacity)
    members = {dlrm.name: (dlrm_ps, warm, reqs),
               dcn.name: (dcn_ps, make_requests(args, dcn.cfg, args.warmup,
                                                1),
                          make_requests(args, dcn.cfg, args.requests, 2))}
    check(sorted(ens.models) == sorted(members) == sorted(graphs),
          f"ensemble members {ens.models}")
    try:
        single = {}
        for mname, (ps, mwarm, mreqs) in members.items():
            solo = fresh(ps)
            try:
                solo.start()
                closed_loop(solo.submit, mwarm)
                outs, ms = counted(total, lambda: closed_loop(solo.submit,
                                                              mreqs))
                solo.stop()
                single[mname] = (outs, ms)
            finally:
                release(solo)
        for mname, (_, mwarm, _) in members.items():
            for d, c in mwarm:
                ens.predict(mname, d, c)
        ens.rebalance_now()              # absorb the warm-up misses
        caps0 = ens.rebalance_stats()["capacities"]
        ens.start()
        member = {}
        for mname, (_, _, mreqs) in members.items():
            s = ens[mname]
            h0 = [c.counters() for c in s.hps.caches.values()]
            outs, ms = counted(total, lambda: closed_loop(
                lambda d, c: ens.submit(mname, d, c), mreqs))
            h1 = [c.counters() for c in s.hps.caches.values()]
            hits = sum(b["hits"] - a["hits"] for a, b in zip(h0, h1))
            miss = sum(b["misses"] - a["misses"] for a, b in zip(h0, h1))
            member[mname] = (outs, ms, hits / max(1, hits + miss))
            check(all(np.array_equal(a, b) for a, b in
                      zip(outs, single[mname][0])),
                  f"ensemble member {mname}: predictions differ from its "
                  "single-model server's")
        ens.stop()
        for mname, (_, _, mreqs) in members.items():
            want = {"lookup_fwd": 1}
            if mname == dlrm.name:
                want["interaction_fwd"] = 1
            _, got = launches_of(lambda: ens.predict(mname, *mreqs[0]))
            check(got == want, f"ensemble member {mname}: one batch "
                  f"launched {got}, want {want}")
        before = {m: [ens.predict(m, d, c) for d, c in mreqs[:4]]
                  for m, (_, _, mreqs) in members.items()}
        skew = make_requests(args, cfg, args.requests, 5)
        ens.start()
        counted(total, lambda: closed_loop(
            lambda d, c: ens.submit(dlrm.name, d, c), skew))
        ens.stop()
        t0 = time.perf_counter()
        caps1 = ens.rebalance_now()
        t_rebalance = time.perf_counter() - t0
        check(caps1[dlrm.name] > caps0[dlrm.name] and
              caps1[dcn.name] < caps0[dcn.name],
              f"rebalance toward DLRM: {caps0} -> {caps1}")

        def after_resize():
            return {m: [ens.predict(m, d, c) for d, c in mreqs[:4]]
                    for m, (_, _, mreqs) in members.items()}

        after = counted(total, after_resize)
        for m in members:
            check(all(np.array_equal(a, b) for a, b in
                      zip(after[m], before[m])),
                  f"ensemble member {m}: predictions changed across the "
                  "rebalance's resize")
        print(f"ensemble dlrm-criteo + dcn-criteo on {name}: "
              f"deploy_ensemble (cache_budget {2 * args.cache_capacity}) "
              f"wrote the bundle in {t_deploy:.1f} s, rebuilt from ps.json "
              "alone; members equal their single-model servers bit for bit,"
              " one K1 launch a batch; closed-loop submit p50 / p99 ms, "
              "member against single-model: " + "; ".join(
                  f"{m} {pct(member[m][1], 50):.2f} / "
                  f"{pct(member[m][1], 99):.2f} against "
                  f"{pct(single[m][1], 50):.2f} / "
                  f"{pct(single[m][1], 99):.2f}, L1 hit rate "
                  f"{member[m][2]:.4f}" for m in members)
              + f"; {len(skew)} requests to {dlrm.name} alone, then "
              f"rebalance_now() in {1e3 * t_rebalance:.0f} ms: capacities "
              f"{caps0} -> {caps1}; predictions after the resize equal "
              "those before bit for bit")

        # (d) the twin over 16 stream groups: DLRM alone, then the
        # ensemble's DLRM member with admission on
        runs = {}
        solo = fresh(dlrm_ps)
        try:
            solo.start()
            closed_loop(solo.submit, warm)
            runs["dlrm-criteo alone"] = counted(total, lambda: sync_window(
                lambda: closed_loop(solo.submit, reqs[:16])))
            solo.stop()
        finally:
            release(solo)
        s = ens[dlrm.name]
        s.set_admission(queue_depth=64, slo_ms=60_000.0)
        s.start()
        closed_loop(s.submit, warm)
        s.reset_serving_stats()
        runs["ensemble member dlrm-criteo, admission on"] = counted(
            total, lambda: sync_window(lambda: closed_loop(s.submit,
                                                           reqs[:16])))
        s.stop()
    finally:
        release(ens)
    groups = min(16, len(reqs))
    for label, (_, summ, debug, where) in runs.items():
        check(summ["syncs"] == groups and summ["compiles"] == 0,
              f"sanitizer, {label}: {summ} over {groups} groups")
        check(debug == groups, f"sanitizer, {label}: the sync debug mode "
              f"saw {debug} syncs over {groups} groups, at {where}")
    print(f"sanitizer on {name}: {groups} stream groups after warm-up; " +
          "; ".join(f"{label}: twin syncs {summ['syncs']} (d2h "
                    f"{summ['d2h']}, block {summ['block']}), fresh kernel "
                    f"builds {summ['compiles']}, set_sync_debug_mode syncs "
                    f"{debug} at {where}"
                    for label, (_, summ, debug, where) in runs.items()))
    one = eng["stream"][4]
    return {"ensemble": os.path.join(ens_dir, "ps.json"), "dlrm": dlrm_ps,
            "names": (dlrm.name, dcn.name),
            "rows_per_s": rows / (1e-3 * sum(one))}


# ---------------------------------------------------------------------------
# phase 6e: the launchers (front doors)
# ---------------------------------------------------------------------------

#: phase 6e's open-loop load test of 6c's ensemble: rows a request and
#: requests a coalesced group (max_batch 1024, the batch served so far);
#: the steady and the overload rate as shares of C, the stream engine's
#: closed-loop rows/s in 6c, and their seconds; the SLO, the admission
#: queue, the arrival seed, the Zipf exponent, the DLRM:DCN mix and the
#: drift run's hot-set shift a second. Fixed before the first run.
LOADTEST = types.SimpleNamespace(rows=256, max_coalesce=4, steady_share=0.1,
                                 steady_s=5.0, overload_share=4.0,
                                 overload_s=2.0, slo_ms=100.0,
                                 queue_depth=64, seed=7, zipf_a=1.2,
                                 mix=(3, 1), drift_per_s=0.02)


def loadtest_summary(result) -> str:
    """One clause a phase and member of a load test's result: delivered,
    shed (client / server), expired, lost, client p50 / p99 / p999, the
    peak delivered qps, and the phase's largest submit lag."""
    out = []
    for phase, r in result["phases"].items():
        client, server = r["client"], r["server"]
        members = []
        for n, m in client["models"].items():
            lat, s = m["latency_ms"], server[n]
            peak = max((q for _, q in m["delivered_qps"]), default=0.0)
            members.append(
                f"{n}: scheduled {m['scheduled']}, delivered "
                f"{m['delivered']}, shed {m['shed_observed']} (server "
                f"{s['requests_shed']}), expired {s['requests_expired']}, "
                f"lost {m['lost']}, p50 / p99 / p999 {lat['p50']:.2f} / "
                f"{lat['p99']:.2f} / {lat['p999']:.2f} ms, peak "
                f"{peak:.1f} qps, groups {s['groups_served']}")
        out.append(f"{phase} ({client['scheduled']} in "
                   f"{client['elapsed_s']:.2f} s, max submit lag "
                   f"{client['max_submit_lag_ms']:.2f} ms): "
                   + "; ".join(members))
    return " | ".join(out)


def front_doors_phase(args, dev, served, total):
    """Phase 6e (a)-(c): the launchers' ``main`` in process on the card.
    (a) ``launch.loadtest`` on 6c's ensemble bundle (full-width DLRM + DCN,
    vocabularies capped), open loop at 10% of C then 4 x C, with its smoke
    assertions; (b) DLRM alone with hot-set drift, the steady phase from
    its recorded trace; (c) ``launch.serve --sanitize`` on DLRM's
    single-model bundle, f32 then int8. ``served`` is what
    :func:`serving_engine_phase` returns. Adds the launches to ``total``."""
    import torch
    from repro_torch.launch import loadtest, serve
    from repro_torch.loadgen.workload import replay_trace

    name = torch.cuda.get_device_name(0)
    lt = LOADTEST
    c = served["rows_per_s"]
    dlrm, dcn = served["names"]
    base = os.path.join(ROOT, "_smoke_bundle")
    steady_qps = lt.steady_share * c / lt.rows
    common = ["--config", served["ensemble"], "--device", dev.type,
              "--rows", str(lt.rows), "--max-coalesce", str(lt.max_coalesce),
              "--arrival", "poisson", "--seed", str(lt.seed),
              "--zipf-a", str(lt.zipf_a), "--queue-depth",
              str(lt.queue_depth), "--slo-ms", str(lt.slo_ms),
              "--qps", repr(steady_qps), "--duration", str(lt.steady_s)]

    # (a) open loop on the ensemble, steady then overloaded
    art = os.path.join(base, "loadtest_ensemble.json")

    def ensemble_run():
        try:
            return loadtest.main([
                *common, "--drift-per-s", "0",
                "--mix", f"{dlrm}={lt.mix[0]},{dcn}={lt.mix[1]}",
                "--overload-qps", repr(lt.overload_share * c / lt.rows),
                "--overload-duration", str(lt.overload_s),
                "--artifacts", art, "--smoke-assert"]), None
        except SystemExit as exc:
            # the launcher writes the artifact before its assertions; the
            # counts read below say which of them failed
            check(os.path.exists(art), f"loadtest: {exc}; {art} not "
                  "written")
            with open(art) as f:
                return json.load(f), exc

    try:
        t0 = time.perf_counter()
        result, failed = counted(total, ensemble_run)
        wall = time.perf_counter() - t0
        # (b) DLRM alone with hot-set drift, driven from its trace
        trace = os.path.join(base, "drift_trace.jsonl")
        t0 = time.perf_counter()
        drift = counted(total, lambda: loadtest.main([
            *common, "--drift-per-s", str(lt.drift_per_s),
            "--mix", f"{dlrm}=1", "--trace-out", trace,
            "--artifacts", os.path.join(base, "loadtest_drift.json")]))
        wall_b = time.perf_counter() - t0
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    check(os.path.exists(art), f"loadtest: {art} not written")
    phases = result["phases"]
    for phase in ("steady", "overload"):
        for n, m in phases[phase]["client"]["models"].items():
            check(m["lost"] == 0, f"loadtest {phase}: {n} lost {m['lost']}")
    for n, m in phases["steady"]["client"]["models"].items():
        check(m["delivered"] > 0 and m["latency_ms"]["p99"] > 0,
              f"loadtest steady: {n} delivered {m['delivered']}, p99 "
              f"{m['latency_ms']['p99']}")
    check(sum(s["requests_shed"] + s["requests_expired"]
              for s in phases["overload"]["server"].values()) > 0,
          "loadtest overload: nothing shed")
    # every smoke assertion but one is held above; the one left, no shed
    # at steady load, fails on the card (ROADMAP queue 3: the steady rate,
    # fixed as a share of C before the first run, is above this traffic's
    # capacity) and is printed as that fault's measurement
    steady_shed = {n: s["requests_shed"] + s["requests_expired"]
                   for n, s in phases["steady"]["server"].items()}
    check(failed is None or any(steady_shed.values()),
          f"loadtest: the smoke assertions failed ({failed}) with nothing "
          "shed at steady load")
    print(f"loadtest {dlrm} + {dcn} ensemble on {name}: C {c:.0f} rows/s "
          f"(6c's stream closed loop), requests of {lt.rows} rows, "
          f"max_batch {lt.rows * lt.max_coalesce}, poisson, Zipf "
          f"{lt.zipf_a}, mix {lt.mix[0]}:{lt.mix[1]}, queue_depth "
          f"{lt.queue_depth}, SLO {lt.slo_ms:.0f} ms; steady "
          f"{steady_qps:.2f} qps ({lt.steady_share:.0%} of C) for "
          f"{lt.steady_s:.0f} s, overload "
          f"{lt.overload_share * c / lt.rows:.2f} qps ({lt.overload_share:.0f}"
          f" x C) for {lt.overload_s:.0f} s; "
          + ("smoke assertions held; " if not any(steady_shed.values())
             else "every smoke assertion held but no shed at steady load, "
             "ROADMAP queue 3's open fault: shed or expired at steady "
             + ", ".join(f"{n} {k}" for n, k in steady_shed.items())
             + "; ") +
          f"{wall:.1f} s in all; " + loadtest_summary(result))
    recorded = sum(1 for _ in replay_trace(trace))
    scheduled = drift["phases"]["steady"]["client"]["scheduled"]
    check(recorded == scheduled, f"loadtest drift: the trace holds "
          f"{recorded} requests, the replay scheduled {scheduled}")
    print(f"loadtest drift {dlrm} on {name}: drift {lt.drift_per_s} of the "
          f"vocabulary a second, steady {steady_qps:.2f} qps for "
          f"{lt.steady_s:.0f} s, recorded to a trace of {recorded} requests "
          f"({os.path.getsize(trace) / 1e6:.1f} MB) and driven from its "
          f"replay ({scheduled} scheduled); {wall_b:.1f} s in all; "
          + loadtest_summary(drift))

    # (c) launch.serve on DLRM's single-model bundle, f32 then int8
    reps = {}
    for payload in ("f32", "int8"):
        argv = ["--config", served["dlrm"], "--device", dev.type,
                "--requests", "16", "--batch", str(args.batch), "--sanitize"]
        if payload != "f32":
            argv += ["--payload-dtype", payload]
        reps[payload] = counted(total, lambda: serve.main(argv))
    clauses = []
    for payload, rep in reps.items():
        (m,) = rep["models"].values()
        lat, san = m["latency_ms"], rep["sanitizer"]
        int8_dev = rep["payload_dev"]
        clauses.append(
            f"{payload}: {m['responses']} responses of {args.batch} rows, "
            f"p50 / p95 / p99 {lat['p50']:.2f} / {lat['p95']:.2f} / "
            f"{lat['p99']:.2f} ms, L1 hit rate {m['l1_hit_rate']:.4f}, "
            f"{san['syncs']} syncs over {san['groups']} groups, "
            f"{san['compiles']} kernel-library loads"
            + (f", max |int8 - f32 rebuild| {max(int8_dev.values()):.5f} "
               f"(tolerance 0.1)" if int8_dev else ""))
    print(f"serve {dlrm} on {name} (launch.serve --sanitize, 16 requests): "
          + "; ".join(clauses))


def train_launcher_phase(args, dev, total):
    """Phase 6e (d): ``launch.train`` of full-width ``wdl-criteo`` (full
    vocabulary) at ``RUN.train_batch``: 6 steps with ``--ckpt-interval 6``
    under ``_smoke_bundle/`` (the trainer saves at step 0 and at the end
    of the run, as the reference's does), then ``--steps 10`` resumes at
    step 6 and runs 4 (saving at step 6 and at the end); a third run of
    10 steps without checkpoints gives the losses an uninterrupted run has
    at steps 6-9, which the resumed ones must match within
    ``RESUME_TOL``: steps 7-9 hold the restored optimizer state too. Adds the launches to ``total`` and frees
    every model before returning."""
    import contextlib
    import io
    import numpy as np
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ck

    name = torch.cuda.get_device_name(0)
    ckdir = os.path.join(ROOT, "_smoke_bundle", "ckpt_wdl")
    shutil.rmtree(ckdir, ignore_errors=True)
    writes = []
    save = ck.save

    def timed_save(*a, **k):         # the AsyncSaver's writer thread
        t0 = time.perf_counter()
        out = save(*a, **k)
        writes.append(time.perf_counter() - t0)
        return out

    def run(steps, checkpoint=True):
        argv = ["--arch", "wdl-criteo", "--steps", str(steps), "--batch",
                str(args.train_batch), "--device", dev.type]
        if checkpoint:
            argv += ["--ckpt-dir", ckdir, "--ckpt-interval", "6"]
        buf = io.StringIO()

        def go():
            with contextlib.redirect_stdout(buf):
                hist = launch_train.main(argv)
            torch.cuda.synchronize()
            return hist, LAUNCHES.snapshot()

        t0 = time.perf_counter()
        hist, launches = counted(total, go)
        wall = time.perf_counter() - t0
        sys.stdout.write(buf.getvalue())
        gc.collect()
        torch.cuda.empty_cache()
        return hist, launches, wall, buf.getvalue()

    ck.save = timed_save
    try:
        torch.cuda.reset_peak_memory_stats()
        first, l1, w1, out = run(6)
        kept = ck.list_checkpoints(ckdir)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(ckdir) for f in fs) / len(kept)
        second, l2, w2, _ = run(10)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        ck.save = save
    shutil.rmtree(ckdir, ignore_errors=True)
    straight, _, w3, _ = run(10, checkpoint=False)
    check([h["step"] for h in first] == list(range(6)),
          f"train launcher: first run steps {[h['step'] for h in first]}")
    check([h["step"] for h in second] == list(range(6, 10)),
          f"train launcher: the resumed run's steps "
          f"{[h['step'] for h in second]}, want 6..9")
    losses = [h["loss"] for h in first + second + straight]
    check(bool(np.isfinite(losses).all()),
          f"train launcher: a loss is not finite: {losses}")
    resumed = [h["loss"] for h in second]
    want = [h["loss"] for h in straight[6:]]
    diff = max(abs(a - b) for a, b in zip(resumed, want))
    check(len(want) == len(resumed) and diff <= RESUME_TOL,
          f"train launcher: the resumed losses of steps 6-9 {resumed} "
          f"against {want} uninterrupted (bound {RESUME_TOL})")
    times = [h["time"] for h in first[1:] + second[1:]]
    p50 = 1e3 * float(np.median(times))
    clean = 1e3 * float(np.median([h["time"] for h in straight[1:]]))
    per_step = {k: n / (len(first) + len(second))
                for k, n in sorted(((k, l1.get(k, 0) + l2.get(k, 0))
                                    for k in ("lookup_fwd", "lookup_bwd")))}
    print(f"train launcher wdl-criteo on {name}: full width and vocabulary "
          f"(launch.train --batch {args.train_batch}, AdamW + row-wise "
          f"AdaGrad); summary: {out.splitlines()[0]}; 6 steps with "
          f"--ckpt-interval 6 in {w1:.1f} s, then --steps 10 resumed at step "
          f"{second[0]['step']} and ran {len(second)} in {w2:.1f} s, 10 "
          f"steps uninterrupted in {w3:.1f} s; losses of steps 6-9 resumed "
          f"{', '.join(f'{x:.6f}' for x in resumed)}, max |diff| from the "
          f"uninterrupted run {diff:.2e} (tolerance {RESUME_TOL}); step p50 "
          f"{p50:.2f} ms with a checkpoint write in flight "
          f"({args.train_batch / p50 * 1e3:.0f} samples/s), {clean:.2f} ms "
          f"without ({args.train_batch / clean * 1e3:.0f} samples/s); peak "
          f"{peak:.2f} GiB; {len(writes)} checkpoint writes of "
          f"{size / 1e9:.2f} GB each, in "
          f"{', '.join(f'{w:.2f}' for w in writes)} s; launches a step "
          f"K1 {per_step['lookup_fwd']:.2f}, K3 {per_step['lookup_bwd']:.2f}")


# ---------------------------------------------------------------------------
# phase 7: serve full-width minitron-4b: prefill, then KV-cache decode
# ---------------------------------------------------------------------------

def etc_phase(args, dev, trained, total):
    """Phase 6d: ETC-staged training and the train-while-serving loop at
    full width on the one card, on ``trained``'s config (capped
    ``dlrm-criteo``). (i) A full-coverage ETC fit (``cache_rows``
    ``args.etc_cache_rows``, ``StagedPS``, ``args.etc_passes`` passes)
    from phase 4's initial weights over phase 4's batches: every step one
    K1 and one K3 launch over the ``[T * C, D]`` cache and one K2 and one
    K4, no eviction, losses within ``TRAIN_TOL`` of phase 4's in-memory
    fit and of the plain versions' first steps; the step's host
    ``prepare`` and the rest, against the in-memory step, and a profiled
    ETC step. (ii) An evicting fit (``args.etc_evict_rows`` rows,
    ``CachedPS`` under the smoke's scratch, 1 pass): it evicts, its loss
    falls, and after the flush every resident row of the PS equals its
    cache row bit for bit. (iii) ``trained`` deployed live (an external
    VolatileDB and MessageBus, an f32 L1, the stream engine) while an
    ``OnlineTrainer`` with an ``UpdatePublisher`` runs
    ``args.etc_passes`` passes of ``args.etc_online_steps`` steps: each
    version visible (``wait_visible``) with one host sync a served group
    by the hot-path twin while the consumer applies it, then the probe
    converges onto the oracle (trained rows under the deployed dense net)
    within ``SERVE_TOL["f32"]``. Adds every run's launches to ``total``."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.analysis import HotPathMonitor
    from repro_torch.configs.base import ETCParams
    from repro_torch.core.hps.message_bus import MessageBus
    from repro_torch.core.hps.volatile_db import VolatileDB
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.online import (OnlineTrainer, UpdatePublisher,
                                    probe_prediction, wait_visible)
    from repro_torch.train.trainer import put_batch

    name = torch.cuda.get_device_name(0)
    cfg = trained.cfg
    reader = SyntheticCTR(cfg, args.train_batch, seed=args.seed)
    steps = args.warm_steps + args.timed_steps
    mem = FIT_HISTORY[cfg.name]
    t_, d_ = len(cfg.tables), cfg.embedding_dim

    def gb(rows):
        return t_ * rows * d_ * 4 / 1e9

    # (i) full coverage, from phase 4's init over its batches
    calls = []

    def data_fn(step):              # launch counts as each call begins,
        snap = LAUNCHES.snapshot()  # and the reader's host time
        t0 = time.perf_counter()
        batch = reader.batch(step)
        calls.append((step, snap, time.perf_counter() - t0))
        return batch

    m = declare(args, cfg, etc=ETCParams(
        cache_rows=args.etc_cache_rows, passes=args.etc_passes)
    ).compile(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings():      # the small tables fit whole
        warnings.simplefilter("ignore", RuntimeWarning)
        hist = counted(total, lambda: m.fit(data_fn, steps=steps))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    end = LAUNCHES.snapshot()
    ot = m._online
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and np.isfinite(losses).all(),
          f"etc fit: {len(hist)} steps, losses {losses}")
    check(ot.etc.evictions == 0, f"etc fit: {ot.etc.evictions} evictions "
          "in a cache that holds every id the run touches")
    err = max(abs(a - b) for a, b in zip(losses, mem["losses"]))
    check(err <= TRAIN_TOL, f"etc fit: losses {losses} against the "
          f"in-memory {mem['losses']} (bound {TRAIN_TOL})")
    # the training call of step s is its last; its launches run up to the
    # next call (the next step's, or the next pass's staging after this
    # pass's flush, which launches K5 only)
    last = {s: i for i, (s, _, _) in enumerate(calls)}
    snaps = [snap for _, snap, _ in calls] + [end]
    want = {"lookup_fwd": 1, "lookup_bwd": 1, "interaction_fwd": 1,
            "interaction_bwd": 1}
    for s in range(steps):
        a, b = snaps[last[s]], snaps[last[s] + 1]
        d = {k: b.get(k, 0) - a.get(k, 0) for k in want}
        check(d == want, f"etc fit step {s}: launches {d}, want {want} "
              "(one K1 and one K3 over the flattened cache, K2 and K4)")
    timed = range(args.warm_steps, steps)
    read = [calls[last[s]][2] * 1e3 for s in timed]
    prep = [hist[s]["prepare_s"] * 1e3 for s in timed]
    rest = [hist[s]["step_s"] * 1e3 for s in timed]
    tot = [a + b + c for a, b, c in zip(read, prep, rest)]
    p50 = float(np.median(tot))
    print(f"etc fit {cfg.name} on {name}: cache [{t_}, "
          f"{ot.etc.capacity}, {d_}] f32 ({gb(ot.etc.capacity):.2f} GB) "
          f"+ acc, StagedPS, {args.etc_passes} passes, {steps} steps at "
          f"batch {args.train_batch} ({args.warm_steps} warm-up) in "
          f"{wall:.1f} s with the PS seed, staging and export; {ot.etc.pulls}"
          f" pulls, 0 evictions; step p50 {p50:.2f} ms = reader "
          f"{float(np.median(read)):.2f} + host prepare "
          f"{float(np.median(prep)):.2f} + step to the loss's read "
          f"{float(np.median(rest)):.2f} ms; in-memory step p50 "
          f"{mem['p50']:.2f} ms (phase 4): ratio {p50 / mem['p50']:.2f}; "
          f"losses within {err:.3g} of the in-memory fit (bound "
          f"{TRAIN_TOL}); peak memory {peak:.2f} GiB (phase 4's trained "
          f"model held too); launches a step "
          f"{want}; pass flushes "
          + ", ".join(f"{p['flush_s']:.2f} s" for p in ot.pass_log)
          + f"; launches {end}")
    # one more step, profiled (its prepare on the host first, not kept)
    batch = reader.batch(steps)
    ot._cache_params, rem = ot.etc.prepare(ot._cache_params, batch["cat"])
    xb = put_batch({"dense": batch["dense"], "label": batch["label"],
                    "cat": rem}, dev)
    profile(f"{cfg.name} ETC step", lambda: ot._step_fn(
        ot._dense, ot._dstate, ot._cache_params, xb["dense"], xb["label"],
        xb["cat"]))
    del m, ot, xb
    gc.collect()
    torch.cuda.empty_cache()
    plain = declare(args, cfg, etc=ETCParams(
        cache_rows=args.etc_cache_rows, passes=args.etc_passes)
    ).compile(device=dev, use_kernels=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ph = plain.fit(reader.batch, steps=args.plain_steps)
    perr = max(abs(a["loss"] - b) for a, b in zip(ph, losses))
    check(perr <= TRAIN_TOL, f"etc fit plain versions: losses "
          f"{[h['loss'] for h in ph]} vs {losses[:args.plain_steps]}")
    print(f"etc fit plain versions: first {args.plain_steps} losses within "
          f"{perr:.3g} of the kernel path (bound {TRAIN_TOL})")
    del plain, ph
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) an evicting cache over the disk tier
    root = os.path.join(ROOT, "_smoke_bundle", "etc_ps")
    shutil.rmtree(root, ignore_errors=True)
    m = declare(args, cfg, etc=ETCParams(
        cache_rows=args.etc_evict_rows, ps="cached", ps_root=root,
        passes=1)).compile(device=dev)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        h2 = counted(total, lambda: m.fit(reader.batch,
                                          steps=args.timed_steps))
    wall = time.perf_counter() - t0
    ot = m._online
    l2 = [h["loss"] for h in h2]
    check(ot.etc.evictions > 0, "etc evicting fit: no eviction")
    check(np.isfinite(l2).all() and l2[-1] < l2[0],
          f"etc evicting fit: loss did not fall: {l2}")
    resident = 0
    for ti, t in enumerate(cfg.tables):
        ids, rows = ot.etc.dirty_rows(ot._cache_params, ti)
        check(np.array_equal(ot.ps.pull(t.name, ids), rows),
              f"etc evicting fit: table {t.name}: PS rows differ from the "
              "flushed cache rows")
        resident += ids.size
    prep = [h["prepare_s"] * 1e3 for h in h2]
    print(f"etc evicting fit {cfg.name}: cache [{t_}, {ot.etc.capacity}, "
          f"{d_}] f32 ({gb(ot.etc.capacity):.3f} GB), CachedPS memmaps "
          f"({gb(max(t.vocab_size for t in cfg.tables)) / t_:.2f} GB the "
          f"largest table), 1 pass of {args.timed_steps} steps in "
          f"{wall:.1f} s with the PS set-up; {ot.etc.pulls} pulls, "
          f"{ot.etc.evictions} evictions; host prepare p50 "
          f"{float(np.median(prep)):.2f} ms (max {max(prep):.2f}); loss "
          f"{l2[0]:.4f} -> {l2[-1]:.4f}; flush + fsync "
          f"{ot.pass_log[-1]['flush_s']:.2f} s; {resident} resident rows "
          "equal in the PS bit for bit")
    del m, ot
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (iii) the train-while-serving loop on the deployed model
    live = os.path.join(ROOT, "_smoke_bundle", f"{cfg.name}-live")
    shutil.rmtree(live, ignore_errors=True)
    vdb, bus = VolatileDB(), MessageBus()
    server = trained.deploy(live, cache_capacity=args.cache_capacity,
                            max_batch=args.batch, vdb=vdb, bus=bus)
    deployed = trained.dense_params()
    dense, cat = make_requests(args, cfg, 1, 7)[0]
    names = [t.name for t in cfg.tables]
    seen = []

    class VisiblePublisher(UpdatePublisher):
        """Waits, as each version goes out, until the live server shows
        it, with the hot-path twin armed over the wait (the trainer is
        paused, so every sync counted is the server's)."""

        def publish(self, updates):
            v = super().publish(updates)
            g0 = server.counters()["groups_served"]
            with HotPathMonitor("etc-freshness") as mon:
                res = wait_visible(server, self, v, dense, cat,
                                   baseline=seen[-1], tables=names,
                                   timeout_s=300)
            groups = server.counters()["groups_served"] - g0
            summ = mon.summary()
            check(summ["syncs"] == groups and summ["compiles"] == 0,
                  f"etc freshness v{v}: {summ['syncs']} host syncs over "
                  f"{groups} served groups, {summ['compiles']} builds")
            seen.append(res["prediction"])
            rec = self.history()[-1]
            lags.append(f"v{v} {rec['rows']} rows visible in "
                        f"{res['lag_s'] * 1e3:.1f} ms ({res['polls']} "
                        f"probes, {summ['syncs']} syncs over {groups} "
                        "groups)")
            return v

    lags = []

    def loop():
        server.start()
        closed_loop(server.submit, make_requests(args, cfg, args.warmup, 1))
        seen.append(probe_prediction(server, dense, cat, timeout_s=300))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ot = OnlineTrainer(trained, ETCParams(
                cache_rows=args.etc_cache_rows, passes=args.etc_passes),
                publisher=VisiblePublisher(bus, trained.name))
            oh = ot.fit(lambda s: reader.batch(1000 + s),
                        args.etc_passes * args.etc_online_steps)
        new = ot.export_params()
        with torch.no_grad():
            oracle = torch.sigmoid(trained.model.apply(
                {**deployed, "embedding": new["embedding"]},
                put_batch({"dense": dense, "cat": cat}, dev))).cpu().numpy()
        final, probes = seen[-1], 0
        deadline = time.monotonic() + 300
        while np.abs(final - oracle).max() > SERVE_TOL["f32"]:
            check(time.monotonic() < deadline, "etc freshness: live "
                  f"predictions stuck {np.abs(final - oracle).max():.2e} "
                  f"from the oracle (bound {SERVE_TOL['f32']})")
            final = probe_prediction(server, dense, cat, timeout_s=300)
            probes += 1
        return oh, ot, oracle, final, probes

    try:
        oh, ot, oracle, final, probes = counted(total, loop)
        counters = server.counters()
    finally:
        server.close()
    d_base = float(np.abs(seen[0] - oracle).max())
    d_final = float(np.abs(final - oracle).max())
    check(d_final < d_base, f"etc freshness: the probe did not move toward "
          f"the oracle ({d_base:.3g} -> {d_final:.3g})")
    check(len(lags) == args.etc_passes, f"etc freshness: {len(lags)} "
          f"versions visible, want {args.etc_passes}")
    print(f"etc freshness {cfg.name} on {name}: live f32 L1 of "
          f"{args.cache_capacity} rows a table, stream engine, batch "
          f"{args.batch}; OnlineTrainer {args.etc_passes} passes x "
          f"{args.etc_online_steps} steps (cache {args.etc_cache_rows} rows "
          f"a table, StagedPS seeded from the trained tables), losses "
          f"{oh[0]['loss']:.4f} -> {oh[-1]['loss']:.4f}; " + "; ".join(lags)
          + f"; probe to oracle {d_base:.3g} -> {d_final:.3g} (bound "
          f"{SERVE_TOL['f32']}, {probes} more probes); "
          f"{counters['updates_applied']} update messages applied, "
          f"{counters['rows_refreshed']} L1 rows refreshed; {ot.etc.pulls} "
          f"pulls, {ot.etc.evictions} evictions; pass flushes "
          + ", ".join(f"{p['flush_s']:.2f} s" for p in ot.pass_log))
    del ot
    shutil.rmtree(live, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


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


def token_tables(model) -> int:
    """Token tables of ``model``, each one K1 launch in a forward pass and
    one K3 in backward: two for the hybrid embedding, else one."""
    return 2 if model.embed_mode == "hybrid" else 1


@contextlib.contextmanager
def moe_routing():
    """While open, records each MoE layer call of the port: its experts
    ``sel`` and its dropped and routed assignments (``moe._top_k`` and
    ``moe._bucket`` wrapped; ``moe_apply`` calls both through the module).
    Reads the drop count to the host each call: for untimed runs."""
    from repro_torch.models.lm import moe
    rec = types.SimpleNamespace(sel=[], dropped=0, routed=0, capacity=set())
    top_k, bucket = moe._top_k, moe._bucket

    def rec_top_k(logits, k):
        vals, sel = top_k(logits, k)
        rec.sel.append(sel)
        return vals, sel

    def rec_bucket(owner, n_buckets, capacity):
        slot = bucket(owner, n_buckets, capacity)
        rec.dropped += int((slot >= n_buckets * capacity).sum())
        rec.routed += slot.numel()
        rec.capacity.add(capacity)
        return slot

    moe._top_k, moe._bucket = rec_top_k, rec_bucket
    try:
        yield rec
    finally:
        moe._top_k, moe._bucket = top_k, bucket


def routing_flips(a, b) -> tuple:
    """``(tokens x layers whose expert sets differ, tokens x layers)``
    between two :func:`moe_routing` records of the same input."""
    import torch
    flips = sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values)
                    .any(-1).sum()) for x, y in zip(a.sel, b.sel))
    return flips, sum(x[..., 0].numel() for x in a.sel)


def no_drop(cfg):
    """``cfg`` with a capacity factor of ``num_experts / top_k``: every
    expert's bucket then holds all the tokens, and nothing drops."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


def attn_layers(model) -> int:
    """Attention launches of ``model`` in one forward pass (K7 in prefill
    and training, K8 in backward): its ``attn`` and ``local_attn`` layers,
    and an encoder-decoder's encoder layers and cross-attentions (one a
    decoder layer)."""
    cfg = model.cfg
    return sum(n for _, kind, n in model._group_keys()
               if kind in ("attn", "local_attn")) + (
        cfg.encoder_layers + cfg.num_layers if cfg.encoder_layers else 0)


def f32_decode_check(dev, cfg, params, prompt) -> str:
    """``prompt`` replayed through ``decode_step`` of ``cfg`` in f32 on the
    plain path, held against its f32 prefill within ``DECODE_F32_TOL`` of
    the largest |logit|; returns what was checked."""
    import torch
    from repro_torch.models.lm.backbone import LMModel
    model = LMModel(dataclasses.replace(cfg, dtype="f32"), device=dev,
                    use_kernels=False)
    b, p = prompt.shape
    cache = model.init_cache(b, p)
    for i in range(p):
        step, cache = model.decode_step(params, prompt[:, i:i + 1], cache,
                                        torch.full((b,), i, device=dev))
    want = model.prefill(params, {"tokens": prompt})
    err = (step - want).abs().max().item()
    top = want.abs().max().item()
    check(err <= DECODE_F32_TOL * top, f"f32 decode after {p} tokens vs "
          f"prefill: max abs {err} (bound {DECODE_F32_TOL} x {top})")
    return (f"in f32 on the plain path max abs {err:.3g} (bound "
            f"{DECODE_F32_TOL} x max |logit| {top:.4g})")


def decode_depths(args, dev, cfg, depths) -> None:
    """bf16 decode drift by depth: full-width copies of ``cfg`` cut to each
    of ``depths`` layers (random seed weights) replay the first
    ``args.prompt`` tokens of :func:`lm_phase`'s batch through
    ``decode_step``, on the kernels and on the plain path, each held
    against its own path's prefill of the same tokens. The shallowest
    copy is held to the reference's bound (``DECODE_TOL``, which the
    reference sets for a 5-layer model); every depth prints its max abs
    error and correlation."""
    import numpy as np
    import torch
    from repro_torch.models.lm.backbone import LMModel
    b, s, p = args.lm_batch, args.lm_seq, args.prompt
    rng = np.random.default_rng((args.seed, 7))
    prompt = torch.from_numpy(zipf_ids(rng, cfg.vocab_size, (b, s),
                                       a=1.2)[:, :p].copy()).to(dev)
    v = cfg.vocab_size
    parts = []
    for depth in depths:
        small = dataclasses.replace(cfg, num_layers=depth)
        params = None
        for kernels in (True, False):
            model = LMModel(small, device=dev, use_kernels=kernels)
            if params is None:
                params = model.init(torch.Generator(device=dev).manual_seed(
                    args.seed))
            with torch.inference_mode():
                cache = model.init_cache(b, s)
                for i in range(p):
                    step, cache = model.decode_step(
                        params, prompt[:, i:i + 1], cache,
                        torch.full((b,), i, device=dev))
                want = model.prefill(params, {"tokens": prompt})
            got = step[:, :v].float().cpu().numpy()
            ref = want[:, :v].float().cpu().numpy()
            dmax = float(np.abs(got - ref).max())
            corr = float(np.corrcoef(got.ravel(), ref.ravel())[0, 1])
            close = bool(np.allclose(got, ref, rtol=DECODE_TOL.rtol,
                                     atol=DECODE_TOL.atol))
            path = "kernels" if kernels else "plain"
            if depth == depths[0]:
                check(close and corr > DECODE_TOL.corr, f"bf16 decode of "
                      f"{cfg.name} cut to {depth} layers on the {path} "
                      f"path after {p} tokens vs prefill: max abs {dmax}, "
                      f"correlation {corr}")
            parts.append(f"{depth} layers {path} {dmax:.4g} / {corr:.6f}"
                         + (" (bound held)" if close else ""))
            del cache, step, want, model
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"decode drift {cfg.name} by depth on "
          f"{torch.cuda.get_device_name(0)}: full-width copies, random "
          f"weights (seed {args.seed}), bf16 compute, a {p}-token prompt "
          f"replayed into a {s}-entry cache against the same path's "
          "prefill, max abs / correlation: " + "; ".join(parts)
          + f"; {depths[0]} layers held to rtol {DECODE_TOL.rtol}, atol "
          f"{DECODE_TOL.atol}, corr > {DECODE_TOL.corr} on both paths")


def lm_phase(args, dev, cfg, f32_replay: bool = False, cut: str = "",
             profile_seq=None):
    """Prefill and decode ``cfg`` at full width and depth with random
    weights; returns the launch counts of the kernel path's run. With
    ``f32_replay`` (a model deeper than the bf16 decode bound was set
    for) the bf16 replay is held by its correlation and the decode state
    by :func:`f32_decode_check`; :func:`decode_depths` holds the same
    model cut to 5 layers to the bf16 bound. An MoE model replays the
    prompt on its :func:`no_drop` copy (at the published factor decode
    drops what prefill keeps: a step routes only the batch's tokens) and
    prints the routing: the assignments dropped in prefill and in a
    decode step, and the tokens whose experts differ between the kernels
    and the plain path. ``cut`` says why the sequence is shorter than
    ``prefill_32k``'s beyond the smoke's time; ``profile_seq`` cuts the
    profiled prefill's tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.base import LM_SHAPE_BY_NAME
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.lm.backbone import LMModel
    from repro_torch.tree import flatten, leaves

    full = LM_SHAPE_BY_NAME["prefill_32k"]
    b, s = args.lm_batch, args.lm_seq
    print(f"reduced: {cfg.name} prefill at batch {b} x seq {s} instead of "
          f"prefill_32k's {full.global_batch} x {full.seq_len}, to fit the "
          f"smoke's time{cut}; widths, {cfg.num_layers} layers "
          f"and the {cfg.vocab_size}-token vocabulary as published; random "
          f"weights (seed {args.seed})")
    model = LMModel(cfg, device=dev)
    n_attn, n_tables = attn_layers(model), token_tables(model)
    plain = LMModel(cfg, device=dev, use_kernels=False)
    routing = moe_routing if cfg.moe is not None else contextlib.nullcontext
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
        with routing() as k_routes:
            logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        first = LAUNCHES.snapshot()
        check(first.get("flash_fwd", 0) == n_attn
              and first.get("lookup_fwd", 0) == n_tables,
              f"prefill launches {first}: want K7 {n_attn} times "
              f"and K1 {n_tables}")
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
        with routing() as p_routes:
            want = plain.prefill(params, batch)
        err = (logits - want).abs().max().item()
        top = want.abs().max().item()
        moe_line = ""
        if cfg.moe is not None:
            flips, decisions = routing_flips(k_routes, p_routes)
            moe_line = (f"; routing: {k_routes.dropped} of "
                        f"{k_routes.routed} assignments dropped (capacity "
                        f"{sorted(k_routes.capacity)} a bucket, factor "
                        f"{cfg.moe.capacity_factor}), {flips} of "
                        f"{decisions} tokens x layers "
                        f"({100 * flips / decisions:.1f}%; "
                        f"{ROUTING_FLIPS_MMA_SYNC}% with K7 on mma.sync) with "
                        "other experts on the kernels than on the plain "
                        "path")
            del k_routes, p_routes
        check(err <= LM_LOGIT_TOL * top, f"prefill logits deviate {err} "
              f"from the plain path (bound {LM_LOGIT_TOL} x {top})"
              + moe_line)
        del want
        p50 = float(np.median(ms))
        print(f"prefill {cfg.name} on {torch.cuda.get_device_name(0)}: {b} "
              f"x {s} tokens "
              f"({100 * hot:.1f}% hot) p50 {p50:.2f} ms (min {min(ms):.2f}, "
              f"max {max(ms):.2f}) over {args.lm_timed} calls, "
              f"{b * s / p50 * 1e3:.0f} tokens/s; peak memory {peak:.2f} GiB; "
              f"max |logit - plain| {err:.4g} (bound {LM_LOGIT_TOL} x max "
              f"|logit| {top:.4g}); {k1_line}; launches per prefill {first}"
              f"{moe_line}")
        ptoks = tokens[:, :profile_seq]
        profile(f"prefill {cfg.name} ({ptoks.shape[0]} x {ptoks.shape[1]} "
                "tokens)", lambda: model.prefill(params, {"tokens": ptoks}))

        # 2. decode: replay a prompt into the cache, hold the last step
        # against prefill of the same tokens, then greedy tokens
        p = args.prompt
        prompt = tokens[:, :p]
        replay = model if cfg.moe is None else LMModel(no_drop(cfg),
                                                       device=dev)
        cache = replay.init_cache(b, s)
        for i in range(p):
            step, cache = replay.decode_step(
                params, prompt[:, i:i + 1], cache,
                torch.full((b,), i, device=dev))
        full_logits = replay.prefill(params, {"tokens": prompt})
        v = cfg.vocab_size
        got, ref = step[:, :v].cpu().numpy(), full_logits[:, :v].cpu().numpy()
        dmax = float(np.abs(got - ref).max())
        corr = float(np.corrcoef(got.ravel(), ref.ravel())[0, 1])
        close = bool(np.allclose(got, ref, rtol=DECODE_TOL.rtol,
                                 atol=DECODE_TOL.atol))
        check((close or f32_replay) and corr > DECODE_TOL.corr,
              f"decode after {p} tokens vs prefill: max abs {dmax}, "
              f"correlation {corr}")
        notes = "" if replay is model else (
            f"; replayed on the copy with capacity factor "
            f"{replay.cfg.moe.capacity_factor}, which drops nothing")
        if f32_replay:
            notes = ("; bf16 bound held" if close else
                        "; bf16 bound not held (not checked at this "
                        "depth)") + "; " + f32_decode_check(
                            dev, replay.cfg, params, prompt) + notes
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
        if cfg.moe is not None:
            with moe_routing() as d_routes:
                model.decode_step(params, tok, cache, torch.full(
                    (b,), p + args.decode_steps, device=dev))
            notes += (f"; a decode step at the published factor drops "
                         f"{d_routes.dropped} of {d_routes.routed} "
                         f"assignments (capacity "
                         f"{sorted(d_routes.capacity)} a bucket)")
        dp50 = float(np.median(ms))
        # what the per-call f32 -> bf16 cast of the weights moves in a
        # step: every dense weight and the head read as f32, written bf16
        cast = sum(t.numel() for k, t in flatten(params)
                   if not k.startswith("embed"))
        cast_gb = cast * 6 / 1e9
        print(f"decode {cfg.name} on {torch.cuda.get_device_name(0)}: "
              f"{p}-token prompt "
              f"replayed into a {s}-entry cache, last logits vs prefill max "
              f"abs {dmax:.4g}, correlation {corr:.6f} (bounds rtol "
              f"{DECODE_TOL.rtol}, atol {DECODE_TOL.atol}, corr > "
              f"{DECODE_TOL.corr}{notes}); {args.decode_steps} greedy "
              f"steps at batch "
              f"{b}: step p50 {dp50:.2f} ms (min {min(ms):.2f}, max "
              f"{max(ms):.2f}), {b / dp50 * 1e3:.1f} tokens/s; the weights' "
              f"per-call cast moves {cast_gb:.1f} GB a step, "
              f"{cast_gb / HBM_BYTES_PER_S * 1e12:.2f} ms at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s")
        profile(f"decode step {cfg.name}", lambda: model.decode_step(
            params, tok, cache, torch.full((b,), p + args.decode_steps,
                                           device=dev)))
    return launches


def frontend_phase(args, dev, cfg):
    """Prefill and decode the encoder-decoder or vision-prefix ``cfg`` at
    full width and depth with random weights; returns the launch counts of
    the kernel path's run. The prefill batch (:func:`lm_batch`:
    ``args.lm_batch`` x ``args.lm_seq`` positions, frames through the
    encoder or patches ahead of the text) runs on the kernels, K7 once an
    attention launch (:func:`attn_layers`), and is held against the plain
    path. Decode never sees the frames or the patches, as in the
    reference, so a decode replay does not give prefill's logits: the
    prompt is replayed through ``decode_step`` on both paths, from their
    own empty caches (an encoder-decoder's cross cache the reference's
    zeros), the last logits held against each other, then greedy steps
    are timed."""
    import numpy as np
    import torch
    from repro_torch.configs.base import LM_SHAPE_BY_NAME
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.lm.backbone import LMModel
    from repro_torch.tree import leaves

    full = LM_SHAPE_BY_NAME["prefill_32k"]
    b, s = args.lm_batch, args.lm_seq
    print(f"reduced: {cfg.name} prefill at batch {b} x {s} positions "
          f"instead of prefill_32k's {full.global_batch} x {full.seq_len}, "
          f"to fit the smoke's time; widths, {cfg.num_layers} layers"
          + (f", {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
             else "")
          + f" and the {cfg.vocab_size}-token vocabulary as published; "
          f"random weights (seed {args.seed}) and frontend inputs")
    model = LMModel(cfg, device=dev)
    plain = LMModel(cfg, device=dev, use_kernels=False)
    n_attn, n_tables = attn_layers(model), token_tables(model)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in leaves(params))
    print(f"lm init: {n / 1e9:.3f} B f32 params ({n * 4 / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; embedding {model.embed_mode} "
          f"(hot {model.hot_rows} rows, cold {model.cold_rows})")
    batch = lm_batch(args, cfg, dev, b, s)
    tokens = batch["tokens"]
    with torch.inference_mode():
        k1_line = lm_embed_check(model, plain, params, tokens)
        torch.cuda.synchronize()
        LAUNCHES.reset()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        first = LAUNCHES.snapshot()
        check(first.get("flash_fwd", 0) == n_attn
              and first.get("lookup_fwd", 0) == n_tables,
              f"prefill launches {first}: want K7 {n_attn} times "
              f"and K1 {n_tables}")
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
        check(err <= LM_LOGIT_TOL * top, f"{cfg.name} prefill logits "
              f"deviate {err} from the plain path (bound {LM_LOGIT_TOL} x "
              f"{top})")
        del want
        p50 = float(np.median(ms))
        print(f"prefill {cfg.name} on {torch.cuda.get_device_name(0)}: {b} "
              f"x {s} {front_note(batch)}p50 {p50:.2f} ms (min "
              f"{min(ms):.2f}, max {max(ms):.2f}) over {args.lm_timed} "
              f"calls, {b * s / p50 * 1e3:.0f} positions/s; peak memory "
              f"{peak:.2f} GiB; max |logit - plain| {err:.4g} (bound "
              f"{LM_LOGIT_TOL} x max |logit| {top:.4g}); {k1_line}; "
              f"launches per prefill {first}")
        profile(f"prefill {cfg.name} ({b} x {s} positions)",
                lambda: model.prefill(params, batch))

        # decode: the prompt replayed on both paths, then greedy steps
        p = args.prompt
        prompt = tokens[:, :p]
        caches = [m.init_cache(b, s) for m in (model, plain)]
        steps = [None, None]
        for i in range(p):
            pos = torch.full((b,), i, device=dev)
            for j, m in enumerate((model, plain)):
                steps[j], caches[j] = m.decode_step(
                    params, prompt[:, i:i + 1], caches[j], pos)
        step, cache = steps[0], caches[0]
        dmax = (step - steps[1]).abs().max().item()
        dtop = steps[1].abs().max().item()
        check(dmax <= LM_LOGIT_TOL * dtop, f"{cfg.name} decode after {p} "
              f"tokens on the kernels vs the plain path: max abs {dmax} "
              f"(bound {LM_LOGIT_TOL} x {dtop})")
        del steps, caches
        cross = ""
        if cfg.encoder_layers:
            check(all(not bool(t.any()) for t in cache["cross"]),
                  f"{cfg.name} decode wrote into the cross cache")
            shape = list(cache["cross"][0].shape)
            cross = (f"; the cross caches {shape} left as init_cache made "
                     "them (zeros), as the reference's decode leaves them")
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
        print(f"decode {cfg.name} on {torch.cuda.get_device_name(0)}: "
              f"{p}-token prompt replayed into a {s}-entry cache on the "
              f"kernels and on the plain path, last logits max abs "
              f"{dmax:.4g} apart (bound {LM_LOGIT_TOL} x max |logit| "
              f"{dtop:.4g}; no frames or patches reach decode, so prefill's "
              f"logits are not its yardstick){cross}; {args.decode_steps} "
              f"greedy steps at batch {b}: step p50 {dp50:.2f} ms (min "
              f"{min(ms):.2f}, max {max(ms):.2f}), {b / dp50 * 1e3:.1f} "
              "tokens/s")
        profile(f"decode step {cfg.name}", lambda: model.decode_step(
            params, tok, cache, torch.full((b,), p + args.decode_steps,
                                           device=dev)))
    del params, cache
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


def lm_batch(args, cfg, dev, b: int, s: int) -> dict:
    """The batch of ``cfg`` over ``s`` positions, shaped as
    ``repro/launch/specs.py::lm_input_specs`` shapes it: tokens from
    :func:`lm_tokens`; a vision config's ``frontend_seq`` patch positions
    ahead of ``s - frontend_seq`` tokens, an audio config's ``max(s // 8,
    16)`` frames, each random bf16 ``[b, n, d_model]`` from the run's
    seed."""
    import torch
    s_text = s - (cfg.frontend_seq if cfg.frontend == "vision" else 0)
    batch = {"tokens": lm_tokens(args, cfg, dev, b, s_text)}
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    n = {"vision": cfg.frontend_seq, "audio": max(s // 8, 16)}
    if cfg.frontend in n:
        key = "patches" if cfg.frontend == "vision" else "frames"
        batch[key] = torch.randn((b, n[cfg.frontend], cfg.d_model),
                                 generator=g, device=dev).to(torch.bfloat16)
    return batch


def depth_cut(cfg, layers: int):
    """``cfg`` cut to ``layers`` decoder layers (and as many encoder
    layers, at most its own)."""
    return dataclasses.replace(
        cfg, num_layers=layers,
        encoder_layers=min(cfg.encoder_layers, layers))


def lm_grad_check(args, dev, cfg, layers: int):
    """The kernels (K1, K3, K7, K8) against the plain path on a copy of
    ``cfg`` cut to ``layers`` layers at full width (an encoder-decoder's
    encoder too): the loss and, per parameter, the gradients' relative L2
    error and cosine."""
    import torch
    from repro_torch.launch.train import lm_value_and_grad
    from repro_torch.models.lm.backbone import LMModel
    from repro_torch.tree import flatten
    small = depth_cut(cfg, layers)
    model = LMModel(small, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    batch = lm_batch(args, cfg, dev, args.lm_train_batch, args.lm_seq)
    tokens = batch["tokens"]
    loss, grads = lm_value_and_grad(model, params, batch)
    plain = LMModel(small, device=dev, use_kernels=False)
    ploss, pgrads = lm_value_and_grad(plain, params, batch)
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
        lines.append(f"{key.replace('groups/', '')} {rel:.2e}/{cos:.6f}")
    front = "".join(f", {k} {list(v.shape)}" for k, v in batch.items()
                    if k != "tokens")
    enc = (f" (and {small.encoder_layers} encoder layers)"
           if small.encoder_layers else "")
    print(f"lm grad check: {cfg.name} cut to {small.num_layers} layers{enc} "
          f"at full width, tokens [{tokens.shape[0]}, {tokens.shape[1]}]"
          f"{front}: loss "
          f"{float(loss):.6f} on the kernels, {float(ploss):.6f} on the plain "
          f"path (|diff| {dl:.3g}, bound {tol.loss_rel} relative); gradients "
          f"relative L2 error / cosine per parameter: {'; '.join(lines)}; "
          f"worst {worst_rel:.3g} / {worst_cos:.6f} (bounds {tol.rel}, "
          f"{tol.cos})")
    del grads, pgrads, params


def lm_k3_inputs(model, tokens) -> list:
    """K3's inputs at the LM's shapes: for each token table of ``model``
    (the hot and the cold one of a hybrid table, else its one table),
    ``(table shape, rows [N, 1], dpooled [N, d])``, a hybrid batch's rows
    masked to -1 where the other table holds the token, and one random
    ``dpooled`` shared by the tables."""
    import torch
    ids = tokens.reshape(-1, 1).to(torch.int32)
    g = torch.Generator(device=tokens.device).manual_seed(3)
    d = model.cfg.d_model
    dp = torch.randn((ids.shape[0], d), generator=g, device=tokens.device)
    if model.embed_mode != "hybrid":
        return [((model.vocab_pad, d), ids, dp)]
    hot = ids < model.hot_rows
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


def lm_train_phase(args, dev, cfg, depth_cut: str = "", cut: str = "",
                   profile_seq=None):
    """SGD steps of full-width ``cfg`` on one fixed batch; returns the
    launch counts of the counted run (warm-up and timed steps).
    ``depth_cut`` says why ``cfg`` runs at fewer layers than published,
    ``cut`` why the sequence is shorter than ``train_4k``'s beyond the
    card's memory; ``profile_seq`` cuts the profiled step's tokens."""
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
          f"activations){cut}; widths"
          + (f" and the {cfg.vocab_size}-token vocabulary as published, "
             f"{cfg.num_layers} layers ({depth_cut})" if depth_cut else
             f", {cfg.num_layers} layers and the {cfg.vocab_size}-token "
             "vocabulary as published")
          + f"; random weights (seed {args.seed}); SGD at lr "
          f"{args.lm_train_lr}, remat 'none'")
    model = LMModel(cfg, device=dev, remat="none")
    n_attn, n_tables = attn_layers(model), token_tables(model)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    batch = lm_batch(args, cfg, dev, b, s)
    tokens = batch["tokens"]
    print(lm_k3_check(model, tokens))
    want = {"lookup_fwd": n_tables, "lookup_bwd": n_tables,
            "flash_fwd": n_attn, "flash_bwd": 2 * n_attn}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    losses, ms = [], []
    for i in range(args.lm_train_warm + args.lm_train_timed):
        before = LAUNCHES.snapshot()
        t = time.perf_counter()
        loss = lm_sgd_step_(model, params, batch, args.lm_train_lr)
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
    LM_TRAIN_HISTORY[cfg.name] = {"losses": losses, "p50": p50,
                                  "launches": want, "layers": cfg.num_layers}
    print(f"lm train {cfg.name} on {torch.cuda.get_device_name(0)}: "
          f"{len(losses)} SGD "
          f"steps at {b} x {s} {front_note(batch)}({args.lm_train_warm} "
          f"warm-up): step "
          f"p50 {p50:.2f} ms (min {min(timed):.2f}, max {max(timed):.2f}), "
          f"{b * s / p50 * 1e3:.0f} positions/s; loss "
          + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; peak memory {peak:.2f} GiB; launches per step {want}")
    pbatch = {**batch, "tokens": tokens[:, :profile_seq]}
    ptoks = pbatch["tokens"]
    profile(f"lm train step {cfg.name} ({ptoks.shape[0]} x "
            f"{ptoks.shape[1]} tokens{front_note(batch, ', ')})",
            lambda: lm_sgd_step_(model, params, pbatch, args.lm_train_lr))
    del params
    return launches


#: each :func:`lm_train_phase` run by config name: its losses, step p50
#: (ms), launches a step and layer count, which phase 8c's steps on the
#: mesh are held against
LM_TRAIN_HISTORY = {}


def front_note(batch, sep: str = "") -> str:
    """What a batch holds besides its tokens, for a printed line: ``positions
    (text tokens [b, n], patches [...] bf16) `` or ``tokens ``; with
    ``sep``, ``sep`` and the frontend's input alone, or nothing."""
    extra = [f"{k} {list(v.shape)} bf16" for k, v in batch.items()
             if k != "tokens"]
    if sep:
        return sep + ", ".join(extra) if extra else ""
    if not extra:
        return "tokens "
    t = batch["tokens"]
    inner = ", ".join([f"text tokens [{t.shape[0]}, {t.shape[1]}]", *extra])
    return f"positions ({inner}) "


def remat_phase(args, dev, cfg):
    """One gradient of full-width ``cfg`` at ``args.lm_train_batch`` x
    ``args.lm_seq`` under each remat policy, from one set of weights: the
    peak memory and the time of each, then every policy's gradients
    against none's."""
    import torch
    from repro_torch.launch.train import lm_value_and_grad
    from repro_torch.models.lm.backbone import REMATS, LMModel
    from repro_torch.tree import flatten
    params = None
    tokens = lm_tokens(args, cfg, dev, args.lm_train_batch, args.lm_seq)
    rows = {}
    for remat in REMATS:
        model = LMModel(cfg, device=dev, remat=remat)
        if params is None:
            params = model.init(torch.Generator(device=dev).manual_seed(
                args.seed))
        lm_value_and_grad(model, params, tokens)          # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        loss, grads = lm_value_and_grad(model, params, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        rows[remat] = (float(loss), ms,
                       (torch.cuda.max_memory_allocated() - base) / 2**30,
                       torch.cuda.max_memory_allocated() / 2**30)
        del grads, loss
    # the gradients, once the peaks are read: none's held on the card,
    # each other policy's against them parameter by parameter
    ref = rows["none"][0]
    _, want = lm_value_and_grad(LMModel(cfg, device=dev, remat="none"),
                                params, tokens)
    want = flatten(want)
    worst = {}
    for remat in REMATS[1:]:
        loss, grads = lm_value_and_grad(LMModel(cfg, device=dev,
                                                remat=remat), params, tokens)
        check(abs(float(loss) - ref) <= REMAT_TOL * abs(ref), f"remat "
              f"{remat}: loss {float(loss)} against none's {ref} (bound "
              f"{REMAT_TOL} relative)")
        rel_max, diff_max = 0.0, 0.0
        for (key, g), (_, w) in zip(flatten(grads), want):
            diff = (g - w).float()          # f32 norms: one temporary
            d = diff.norm().item()
            rel = d / max(w.float().norm().item(), 1e-30)
            check(rel <= REMAT_TOL, f"remat {remat}: gradient {key} "
                  f"relative L2 error {rel} against none's (bound "
                  f"{REMAT_TOL})")
            rel_max = max(rel_max, rel)
            diff_max = max(diff_max, diff.abs().max().item())
            del diff
        worst[remat] = (rel_max, diff_max)
        del grads
    del want
    print(f"remat {cfg.name} on {torch.cuda.get_device_name(0)}: one "
          f"gradient at {args.lm_train_batch} x {args.lm_seq} tokens, full "
          "width and depth; per policy loss, gradient ms, peak GiB above "
          "the weights (peak GiB in all): "
          + "; ".join(f"{r} {loss:.6f}, {ms:.2f} ms, {extra:.2f} ({peak:.2f})"
                      f" GiB" for r, (loss, ms, extra, peak) in rows.items())
          + f"; against none's gradients ({len(flatten(params))} "
          "parameters), worst relative L2 error / max |diff|: "
          + "; ".join(f"{r} {rel:.3g} / {d:.3g}"
                      for r, (rel, d) in worst.items())
          + f" (bound {REMAT_TOL}; losses within {REMAT_TOL} relative)")
    del params


#: each example twin at its smallest setting on the card
TWINS = (("quickstart", ["--steps", "4"]),
         ("train_dlrm_e2e", ["--steps", "40", "--batch", "256",
                             "--vocab-cap", "2000", "--ckpt-interval",
                             "10"]),
         ("serve_online_updates", ["--windows", "1"]),
         ("loadtest_ensemble", ["--train-steps", "1", "--duration", "1",
                                "--overload-duration", "0.5"]),
         ("novel_archs", ["--steps", "3"]),
         ("etc_terabyte_training", ["--vocab", "20000", "--steps", "30"]),
         ("lm_pretrain_smoke", ["--arch", "recurrentgemma-9b", "--steps",
                                "10"]))


def twins_phase(dev):
    """Each twin of ``examples/`` (``repro_torch.examples.<name>``) once
    through its ``main`` on the card at its smallest setting; each runs
    its own checks (a falling loss, served predictions against the
    training forward pass, ...) and raises if one fails. Returns the
    kernels' launches in the twins."""
    import importlib
    from repro_torch.kernels._build import LAUNCHES
    LAUNCHES.reset()
    walls = []
    for name, argv in TWINS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            mod.main(["--device", dev.type, *argv])
        walls.append(f"{name} {time.perf_counter() - t0:.1f} s")
    launches = LAUNCHES.snapshot()
    print("example twins on the card (python -m repro_torch.examples.<name> "
          f"--device {dev.type} at the smallest settings, each with its own "
          "checks): " + ", ".join(walls) + f"; launches {launches}")
    return launches


def recipe_run(args, dev, cfg, timed_steps, payloads, submit, total,
               online=None, keep=False):
    """Train ``cfg`` (:func:`train_phase`), deploy it, rebuild the server
    from ``ps.json`` and serve it with each L1 payload type of
    ``payloads``, then run ``online`` (:func:`online_phase` or
    :func:`online_fanout`) on the same bundle; adds the main paths' launch
    counts to ``total``. With ``keep`` the trained ``api.Model`` stays for
    a later phase and is returned."""
    import torch
    bundle_dir = os.path.join(ROOT, "_smoke_bundle", cfg.name)
    shutil.rmtree(bundle_dir, ignore_errors=True)
    try:
        model, launches = train_phase(args, dev, cfg, timed_steps)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        cfg, pdb, params = deploy_phase(args, model, bundle_dir)
        ps = os.path.join(bundle_dir, "ps.json")
        for pd in payloads:
            launches, _ = serve_phase(args, ps, cfg, pdb, params, dev, pd,
                                      trained=model, submit=submit)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        if online is not None:
            online(args, ps, cfg, pdb, params, dev, total)
    finally:
        shutil.rmtree(bundle_dir, ignore_errors=True)
    if keep:
        return model
    del model, params, pdb
    gc.collect()
    torch.cuda.empty_cache()
    return None


def reduced_line(args, cfg, full) -> str:
    rows = sum(t.vocab_size for t in cfg.all_tables)
    full_rows = sum(t.vocab_size for t in full.all_tables)
    gb = sum(t.vocab_size * t.dim for t in cfg.all_tables) * 4 / 1e9
    full_gb = sum(t.vocab_size * t.dim for t in full.all_tables) * 4 / 1e9
    return (f"reduced: {cfg.name} vocabulary capped at {args.vocab_cap} "
            f"rows per table: {rows} rows ({gb:.2f} GB f32) instead of "
            f"{full_rows} ({full_gb:.2f} GB), to keep the smoke's time; "
            f"widths, {len(cfg.all_tables)} tables, hotness and the dense "
            "layers as published")


def full_line(cfg) -> str:
    """What a run at the full vocabulary holds, by table set."""
    from repro_torch.models.recsys.model import has_wide, wide_tables
    sets = [("", cfg.tables)] + [(f"{g.name} ", g.tables)
                                 for g in cfg.extra_groups]
    if has_wide(cfg):
        sets.append(("wide ", wide_tables(cfg)))
    return f"{cfg.name} at full width and vocabulary, no cut: " + "; ".join(
        f"{label}{len(ts)} tables at D {ts[0].dim} over "
        f"{sum(t.vocab_size for t in ts)} rows "
        f"({sum(t.vocab_size * t.dim for t in ts) * 4 / 1e9:.3f} GB f32)"
        for label, ts in sets)


# ---------------------------------------------------------------------------
# 8b. the model-parallel path on a torch.distributed mesh
# ---------------------------------------------------------------------------

def mesh_shape_for(world: int) -> tuple:
    """The mesh of ``world`` ranks: ``(world // 2, 2)``, or ``(1, world)``
    for an odd count."""
    return (world // 2, 2) if world % 2 == 0 else (1, world)


def loc_config(args, cfg):
    """``cfg`` with every table pinned localized (a graph group has one
    strategy), each vocabulary capped at ``RUN.loc_vocab`` rows."""
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, strategy="localized",
                            vocab_size=min(t.vocab_size, args.loc_vocab))
        for t in cfg.tables))


def mesh_model(args, cfg, mesh, dev, logical, *, comm="auto", mode="gspmd",
               ar="f32", sparse="rowwise_adagrad"):
    """The graph of ``cfg`` (its pinned strategies kept: ``recipe_graph``)
    compiled on ``mesh`` (None: one device) by ``Model.compile``, its
    weights ``logical`` (a logical param tree) imported onto the mesh."""
    from repro_torch.api import CreateSolver, DataReaderParams, recipe_graph
    from repro_torch.models.recsys.model import import_logical_params
    m = recipe_graph(cfg, solver=CreateSolver(
        batch_size=args.train_batch, lr=args.lr, seed=args.seed, comm=comm,
        mode=mode, grad_allreduce_dtype=ar, sparse_optimizer=sparse),
        reader=DataReaderParams(num_dense_features=cfg.num_dense_features,
                                seed=args.seed))
    m.compile(device=dev, mesh=mesh)
    m._params = import_logical_params(m.model, logical)
    return m


def mesh_fit(args, m, label, lead):
    """``m.fit`` over phase 4's batches; its losses, step p50 and the
    kernels' launches in it (the counts set to 0 just before)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.kernels._build import LAUNCHES
    reader = SyntheticCTR(m.cfg, args.train_batch, seed=args.seed)
    steps = args.warm_steps + args.timed_steps
    torch.cuda.synchronize()
    LAUNCHES.reset()
    hist = m.fit(reader.batch, steps=steps)
    torch.cuda.synchronize()
    launches = LAUNCHES.snapshot()
    losses = [h["loss"] for h in hist]
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"mesh {label}: losses {losses}")
    p50 = float(np.median([h["time"] * 1e3
                           for h in hist[args.warm_steps:]]))
    return {"losses": losses, "p50": p50, "launches": launches,
            "groups": {k: sorted(c.groups)
                       for k, c in m.model.collections().items()}}


def mesh_runs(args, dev, world: int, bundle: str) -> dict:
    """Every rank's part of phase 8b on its mesh (the process group is up):
    the four fits from one set of weights, the localized set's one-device
    fit (rank 0), the gspmd model deployed (rank 0 writes), the twin.
    Returns rank 0's results."""
    import torch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.recsys.model import (
        RecsysModel, export_logical_params)
    shape = mesh_shape_for(world)
    mesh = meshlib.make_test_mesh(shape)
    lead = meshlib.axis_index(mesh, meshlib.all_axes(mesh)) == 0
    cfg = capped_config(args)
    gen = torch.Generator().manual_seed(args.seed)
    one = RecsysModel(cfg, device=dev, global_batch=args.train_batch)
    logical = export_logical_params(one, one.init(gen))  # phase 4's init
    del one
    out = {"mesh": meshlib.mesh_shape(mesh), "runs": {}}
    for label, kw in (("gspmd allgather_rs", dict(comm="allgather_rs")),
                      ("gspmd all_to_all", dict(comm="all_to_all")),
                      ("manual bf16", dict(mode="manual", ar="bf16"))):
        m = mesh_model(args, cfg, mesh, dev, logical, **kw)
        out["runs"][label] = mesh_fit(args, m, label, lead)
        if label == "gspmd allgather_rs":
            dense, cat = make_requests(args, cfg, 1, 0)[0]
            req = {"dense": dense, "cat": cat}
            srv = m.deploy(bundle, cache_capacity=args.cache_capacity,
                           cache_shards=2, max_batch=args.batch)
            if srv is not None:             # rank 0's
                srv.close()
            out["predict"] = m.predict(req)
            out["request"] = req
        del m
        gc.collect()
        torch.cuda.empty_cache()
    del logical
    lcfg = loc_config(args, cfg)
    gen = torch.Generator().manual_seed(args.seed)
    one = RecsysModel(lcfg, device=dev, global_batch=args.train_batch)
    logical = export_logical_params(one, one.init(gen))
    del one
    n_dev = meshlib.mesh_size(mesh)
    if len(lcfg.tables) % n_dev:
        # the reference's compile-time refusal, before any device work
        from repro_torch.api import GraphError
        try:
            mesh_model(args, lcfg, mesh, dev, logical, sparse="sgd")
            refused = None
        except GraphError as e:
            refused = str(e)
        check(refused is not None and "localized" in refused,
              f"mesh: {len(lcfg.tables)} localized tables over {n_dev} "
              f"devices compiled (want a GraphError): {refused}")
        out["localized refused"] = refused
    else:
        m = mesh_model(args, lcfg, mesh, dev, logical, sparse="sgd")
        out["runs"]["localized gspmd"] = mesh_fit(args, m, "localized",
                                                  lead)
        del m
    gc.collect()
    torch.cuda.empty_cache()
    if lead and "localized refused" not in out:
        # the same config on one device
        m = mesh_model(args, lcfg, None, dev, logical, sparse="sgd")
        out["localized one device"] = mesh_fit(args, m, "localized 1-dev",
                                               lead)
        del m
    del logical
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.examples import mp_train_smoke
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        twin = mp_train_smoke.main([
            "--device", dev.type, "--mesh", f"{shape[0]}x{shape[1]}",
            "--steps", "4"])
    out["twin"] = twin
    return out if lead else {}


def mesh_rank(rank, world, store, bundle, result):
    """A spawned rank of phase 8b (more than one card)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = mesh_runs(RUN, torch.device("cuda", rank), world, bundle)
        if rank == 0:
            import pickle
            with open(result, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_phase(args, dev, total):
    """Phase 8b: the model-parallel path on ``torch.cuda.device_count()``
    ranks over NCCL, held against phase 4's one-device fit, then its
    bundle served over a cache mesh. Adds the mesh steps' launches to
    ``total``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cache_mesh
    from repro_torch.launch.serve import build_server_from_config
    world = torch.cuda.device_count()
    root = os.path.join(ROOT, "_smoke_bundle", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    bundle, store = os.path.join(root, "bundle"), os.path.join(root, "store")
    cfg = capped_config(args)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    if world == 1:
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.FileStore(store, 1),
                                rank=0, world_size=1)
        check(dist.is_initialized() and dist.get_backend() == "nccl",
              "mesh: the NCCL process group did not start")
        try:
            out = mesh_runs(args, dev, 1, bundle)
        finally:
            dist.destroy_process_group()
    else:
        import multiprocessing as mp
        import pickle
        result = os.path.join(root, "result.pkl")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, world, store, bundle, result))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        bad = [r for r, p in enumerate(procs)
               if p.is_alive() or p.exitcode != 0]
        for p in procs:
            if p.is_alive():
                p.terminate()
        check(not bad, f"mesh: ranks {bad} failed or hung")
        with open(result, "rb") as f:
            out = pickle.load(f)
    print(f"mesh on {smi}: {world} rank(s) over NCCL on the mesh "
          f"{out['mesh']}; phase {time.perf_counter() - t0:.1f} s")
    ref = FIT_HISTORY[cfg.name]
    for label, run in out["runs"].items():
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
        if label.startswith("localized"):
            base = out.get("localized one device", run)
            want, tol, what = base["losses"], TRAIN_TOL, \
                "the same config's one-device fit"
        else:
            want, tol, what = ref["losses"], (
                MANUAL_TOL if label.startswith("manual") else TRAIN_TOL), \
                "phase 4's one-device fit"
        err = max(abs(a - b) for a, b in zip(run["losses"], want))
        check(err <= tol, f"mesh {label}: losses {run['losses']} vs "
              f"{what} {want} (max dev {err}, bound {tol})")
        base_p50 = (out["localized one device"]["p50"]
                    if label.startswith("localized") else ref["p50"])
        print(f"mesh {label} on {smi}: groups {run['groups']}; step p50 "
              f"{run['p50']:.2f} ms against {base_p50:.2f} ms one-device "
              f"({run['p50'] / base_p50:.2f}x); losses within {err:.3g} of "
              f"{what} (bound {tol}); launches {run['launches']}")
    if "localized refused" in out:
        print(f"mesh localized on {smi}: compile refused the 26 localized "
              f"tables on the mesh {out['mesh']}: {out['localized refused']}")
    ag = out["runs"]["gspmd allgather_rs"]["launches"]
    a2a = out["runs"]["gspmd all_to_all"]["launches"]
    check(ag.get("lookup_fwd", 0) > 0 and ag.get("lookup_bwd", 0) > 0,
          f"mesh: K1 / K3 did not launch in the all-gather steps: {ag}")
    check(a2a.get("gather_rows", 0) > 0 and a2a.get("lookup_bwd", 0) > 0,
          f"mesh: K5 / K3 did not launch in the all-to-all steps: {a2a}")
    # the mesh-trained bundle, rebuilt from ps.json alone over cache meshes
    req = out["request"]
    ps = os.path.join(bundle, "ps.json")
    got, p50 = {}, {}
    timed = make_requests(args, cfg, args.warmup + args.requests, 3)
    for label, cmesh in (("one device", None),
                         ("make_cache_mesh(2)", make_cache_mesh(2)),
                         ("cache mesh [card, card]", [dev, dev])):
        srv, _ = build_server_from_config(ps, device=dev, cache_mesh=cmesh)
        try:
            got[label] = (counted(total, lambda: srv.predict(
                req["dense"], req["cat"])), srv.hps.cache_mesh)
            ms = []
            for k, (dense, cat) in enumerate(timed):
                t1 = time.perf_counter()
                srv.predict(dense, cat)
                if k >= args.warmup:
                    ms.append(1e3 * (time.perf_counter() - t1))
            p50[label] = float(np.percentile(ms, 50))
        finally:
            srv.close()
    one = got["one device"][0]
    for label, (pred, cm) in got.items():
        check(np.array_equal(pred, one), f"mesh serve {label}: predictions "
              "differ from the one-device server's")
    err = float(np.abs(one - out["predict"]).max())
    check(err <= SERVE_TOL["f32"], f"mesh serve: served predictions "
          f"{err} from the trained model's predict")
    print(f"mesh serve on {smi}: the gspmd bundle (cache_shards 2) rebuilt "
          "from ps.json on one device, over make_cache_mesh(2) (cache mesh "
          f"{got['make_cache_mesh(2)'][1]}) and over [{dev}, {dev}]: "
          f"{len(one)} predictions bit-equal across the three, within "
          f"{err:.3g} of the trained model's predict (bound "
          f"{SERVE_TOL['f32']})")
    print(f"mesh serve p50 on {smi}: predict p50 over {args.requests} "
          f"batch-{args.batch} requests after {args.warmup} warm-ups: "
          f"{p50['one device']:.2f} ms on one device, "
          f"{p50['cache mesh [card, card]']:.2f} ms over [{dev}, {dev}] "
          f"({p50['cache mesh [card, card]'] / p50['one device']:.2f}x), "
          f"{p50['make_cache_mesh(2)']:.2f} ms over make_cache_mesh(2)")
    twin = out["twin"]
    print(f"mesh twin mp_train_smoke on {smi}: losses "
          f"{twin['losses'][0]:.4f} -> {twin['losses'][-1]:.4f}, max dev "
          f"from the (1, 1) run {twin.get('loss_dev', float('nan')):.3g}, "
          f"served within {twin.get('serve_err', float('nan')):.3g}")
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 8c. the LM on a torch.distributed mesh
# ---------------------------------------------------------------------------

#: the K1 / K3 / K7 / K8 launches a step that phase 8c counts
LM_STEP_KERNELS = ("lookup_fwd", "lookup_bwd", "flash_fwd", "flash_bwd")


def lm_mesh_steps(args, dev, mesh, cfg) -> dict:
    """:func:`lm_train_phase`'s SGD steps of ``cfg`` (its seed-``args.seed``
    weights, batch, learning rate and step count) through ``LMModel(cfg,
    mesh)``: the token table striped over ``"model"``, the head and the
    loss vocab-parallel, the experts over ``"model"``. Returns the losses,
    the step p50 (ms), each step's K1 / K3 / K7 / K8 launches and what the
    rank holds."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.train import lm_sgd_step_
    from repro_torch.models.lm.backbone import LMModel
    model = LMModel(cfg, mesh, device=dev, remat="none")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    batch = {k: model.data_block(v) for k, v in lm_batch(
        args, cfg, dev, args.lm_train_batch, args.lm_seq).items()}
    table = params["embed" if "embed" in params else "embed_cold"]
    experts = (params["groups"]["0_attn"]["ffn"]["w1"].shape[1]
               if cfg.moe is not None else 0)
    torch.cuda.synchronize()
    LAUNCHES.reset()
    losses, ms, steps = [], [], []
    for _ in range(args.lm_train_warm + args.lm_train_timed):
        before = LAUNCHES.snapshot()
        t = time.perf_counter()
        losses.append(float(lm_sgd_step_(model, params, batch,
                                         args.lm_train_lr)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        after = LAUNCHES.snapshot()
        steps.append({k: after.get(k, 0) - before.get(k, 0)
                      for k in LM_STEP_KERNELS})
    launches = LAUNCHES.snapshot()
    profile(f"lm mesh step {cfg.name} ({args.lm_train_batch} x "
            f"{args.lm_seq} tokens, mesh {meshlib.mesh_shape(mesh)})",
            lambda: lm_sgd_step_(model, params, batch, args.lm_train_lr),
            host_top=8)
    del params
    return {"losses": losses, "p50": float(np.median(
        ms[args.lm_train_warm:])), "steps": steps, "launches": launches,
        "embed_mode": model.embed_mode, "stripe": list(table.shape),
        "vocab_parallel": model.vocab_parallel, "experts": experts,
        "attn_partition": model.attn_partition}


def lm_mesh_phase(args, dev, total):
    """Phase 8c: the LM on a (1, 1) mesh over a one-rank NCCL group on
    ``dev`` (phase 8b's layout on one card; on more cards still one rank:
    the LM across cards is held on the CPU by
    ``tests/test_torch_lm_mesh.py``): full-depth granite (phase 15's
    weights and steps) and the depth-5 recurrentgemma of phase 14, each
    held against its one-device steps within ``TRAIN_TOL``, then
    ``launch.train --mesh 1x1`` for granite under the same group. Adds the
    steps' launches to ``total``; tears the group down."""
    import io
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_lm_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    root = os.path.join(ROOT, "_smoke_bundle", "lm_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfgs = (get_lm_config(args.granite_arch),
            dataclasses.replace(get_lm_config(args.rg_arch),
                                num_layers=args.rg_train_layers))
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(root, "store"), 1), rank=0, world_size=1)
    check(dist.is_initialized() and dist.get_backend() == "nccl",
          "lm mesh: the NCCL process group did not start")
    try:
        mesh = meshlib.make_test_mesh((1, 1))
        runs = {}
        for cfg in cfgs:
            runs[cfg.name] = lm_mesh_steps(args, dev, mesh, cfg)
            gc.collect()
            torch.cuda.empty_cache()
        argv = ["--arch", args.granite_arch, "--mesh", "1x1", "--steps",
                "2", "--batch", str(args.lm_train_batch), "--seq",
                str(args.lm_seq), "--log-every", "1"]
        LAUNCHES.reset()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            launcher = launch_train.main(argv)
        torch.cuda.synchronize()
        launcher_launches = LAUNCHES.snapshot()
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    for cfg in cfgs:
        run, ref = runs[cfg.name], LM_TRAIN_HISTORY[cfg.name]
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
        err = max(abs(a - b) for a, b in zip(run["losses"], ref["losses"]))
        check(len(run["losses"]) == len(ref["losses"]) and
              np.isfinite(run["losses"]).all() and err <= TRAIN_TOL,
              f"lm mesh {cfg.name}: losses {run['losses']} vs the "
              f"one-device steps {ref['losses']} (max dev {err}, bound "
              f"{TRAIN_TOL})")
        check(all(step == ref["launches"] for step in run["steps"]),
              f"lm mesh {cfg.name}: launches a step {run['steps']}, want "
              f"{ref['launches']} (the one-device step's)")
        held = (f"{run['embed_mode']} token table, this rank's stripe "
                f"{run['stripe']}, the head and the loss "
                + ("vocab-parallel" if run["vocab_parallel"] else "whole")
                + (f", {run['experts']} experts a rank"
                   if run["experts"] else "")
                + f", attention '{run['attn_partition']}'")
        print(f"lm mesh {cfg.name} ({cfg.num_layers} layers) on {smi}: "
              f"mesh (1, 1) over NCCL; {held}; {len(run['losses'])} SGD "
              f"steps at {args.lm_train_batch} x {args.lm_seq}: step p50 "
              f"{run['p50']:.2f} ms against {ref['p50']:.2f} ms one-device "
              f"({run['p50'] / ref['p50']:.2f}x); losses "
              + " -> ".join(f"{x:.4f}" for x in run["losses"])
              + f", largest difference from the one-device steps {err:.3g} "
              f"(bound {TRAIN_TOL}); launches a step {run['steps'][0]}")
    for k, n in launcher_launches.items():
        total[k] = total.get(k, 0) + n
    check(len(launcher) == 2 and np.isfinite(launcher).all() and all(
        launcher_launches.get(k, 0) > 0 for k in LM_STEP_KERNELS),
        f"lm mesh launcher: losses {launcher}, launches "
        f"{launcher_launches}\n{log.getvalue()}")
    print(f"lm mesh launcher on {smi}: python -m repro_torch.launch.train "
          f"{' '.join(argv)} under the same group: losses "
          + " -> ".join(f"{x:.4f}" for x in launcher)
          + f"; launches {launcher_launches}; "
          + log.getvalue().strip().splitlines()[0])
    print(f"lm mesh phase: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 8d. sequence-parallel attention, replayed shard by shard
# ---------------------------------------------------------------------------

def seq_rule_mesh(model: int):
    """What ``LMModel`` reads of a mesh to pick its attention partition, for
    a ``(1, model)`` mesh this run has no ranks for: its axes, shape and
    device type."""
    import torch
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros((1, model)),
                                 device_type="cuda")


def seqpar_replay(args, dev, g, label, b, hq, hkv, d, backward) -> dict:
    """Each rank's part of ``seqpar_attention`` over a model axis of
    ``args.seq_shards`` (``transformer.seqpar_shard``: rank ``i``'s query
    rows against the whole K/V, K7 / K8 at ``q_pos0`` its first row), for
    every ``i`` in turn at q ``[b, S, hq, d]``, k/v ``[b, S, hkv, d]``
    bf16 (with ``backward``, each shard's gradient too, from random
    ``do``), against the whole sequence's one K7 launch (and K8 call).
    Returns the shards' launches; prints the errors and the shards' and the
    whole launch's times."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.kernels.ref import BF16_GRAD_RULE, grad_row_error
    from repro_torch.models.lm import transformer as tf
    s, m = args.attn_seq, args.seq_shards
    n = s // m
    q = torch.randn((b, s, hq, d), generator=g).to(torch.bfloat16).to(dev)
    k, v = (torch.randn((b, s, hkv, d), generator=g).to(torch.bfloat16)
            .to(dev) for _ in range(2))
    do = torch.randn((b, s, hq, d), generator=g).to(torch.bfloat16).to(dev)
    rows = [slice(i * n, (i + 1) * n) for i in range(m)]
    with torch.no_grad():
        shards_ms = time_ms(lambda: [tf.seqpar_shard(q[:, r], k, v, i, n)
                                     for i, r in enumerate(rows)], 5)
        whole_ms = time_ms(lambda: ops.flash_attention(q, k, v, True), 5)
    torch.cuda.synchronize()
    LAUNCHES.reset()
    outs, dq = [], []
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for i, r in enumerate(rows):
        qi, ki, vi = (t.detach().requires_grad_(backward)
                      for t in (q[:, r], k, v))
        o = tf.seqpar_shard(qi, ki, vi, i, n)
        if backward:
            o.backward(do[:, r])
            dq.append(qi.grad)
            dk += ki.grad.float()
            dv += vi.grad.float()
        outs.append(o.detach())
    torch.cuda.synchronize()
    launches = LAUNCHES.snapshot()
    qw, kw, vw = (t.detach().requires_grad_(backward) for t in (q, k, v))
    whole = ops.flash_attention(qw, kw, vw, True)
    got = torch.cat(outs, 1)
    equal = torch.equal(got, whole.detach())
    err = (got.float() - whole.detach().float()).abs().max().item()
    tol_o = ATTN_TOL["bf16"][0]
    check(err <= tol_o, f"seqpar {label}: the shards' outputs {err} from "
          f"the whole launch's (bound {tol_o})")
    line = (f"o {'bit-equal' if equal else f'max abs err {err:.3g}'} "
            f"(bound {tol_o})")
    if backward:
        whole.backward(do)
        for name, x, w in (("dq", torch.cat(dq, 1), qw.grad),
                           ("dk", dk, kw.grad), ("dv", dv, vw.grad)):
            peak, rel, worst = grad_row_error(x, w)
            check(peak <= BF16_GRAD_RULE["peak"] and
                  rel <= BF16_GRAD_RULE["whole"] and worst <= 1.0,
                  f"seqpar {label} {name}: peak {peak}, relative L2 {rel}, "
                  f"worst row {worst} of its limit (BF16_GRAD_RULE)")
            exact = torch.equal(x.to(w.dtype), w)
            line += (f"; {name} " + ("bit-equal" if exact else
                     f"peak {peak:.3g}, relative L2 {rel:.3g}, worst row "
                     f"{worst:.3g} of its limit"))
        line += (" (dk / dv: the shards' bf16 parts summed in f32 against "
                 "K8's one sum; BF16_GRAD_RULE)")
    print(f"seqpar {label}: q [{b},{s},{hq},{d}] k/v [{b},{s},{hkv},{d}] "
          f"bf16 over a model axis of {m} ({n} queries a shard, q_pos0 0 .. "
          f"{s - n}), {'forward and backward' if backward else 'forward'}: "
          f"{line}; launches {launches}; the {m} shards' forward "
          f"{shards_ms:.4f} ms against the whole launch's {whole_ms:.4f} ms "
          "(CUDA events)")
    return launches


def seqpar_phase(args, dev, total):
    """Phase 8d: the ``"seq"`` partition's attention on one card, each
    rank's part replayed in turn (:func:`seqpar_replay`) at minitron-4b's
    prefill and training shapes (D 128) and granite-moe-3b-a800m's (D 64),
    after checking that ``LMModel``'s rule picks ``"seq"`` for both on a
    model axis of ``args.seq_shards``. Adds the shards' launches to
    ``total``."""
    import torch
    from repro_torch.configs.registry import get_lm_config
    from repro_torch.models.lm.backbone import LMModel
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(args.seed + 32)
    seen = {}
    for arch in (args.lm_arch, args.granite_arch):
        cfg = get_lm_config(arch)
        part = LMModel(cfg, seq_rule_mesh(args.seq_shards), device=dev,
                       remat="none").attn_partition
        check(part == "seq", f"seqpar: {arch}'s rule picks {part!r} on a "
              f"model axis of {args.seq_shards}, not 'seq'")
        for label, b, backward in (("prefill", args.lm_batch, False),
                                   ("training", args.lm_train_batch, True)):
            got = seqpar_replay(args, dev, g, f"{arch} {label}", b,
                                cfg.num_heads, cfg.num_kv_heads,
                                cfg.resolved_head_dim, backward)
            for k, n in got.items():
                seen[k] = seen.get(k, 0) + n
                total[k] = total.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
    check(seen.get("flash_fwd", 0) > 0 and seen.get("flash_bwd", 0) > 0,
          f"seqpar: the shards launched {seen}, not K7 and K8")
    print(f"seqpar phase on {smi}: {time.perf_counter() - t0:.1f} s "
          f"(launches {seen})")


def recsys_phases(args, dev):
    """Phases 4-6 (DLRM, its vocabulary capped: train, deploy, serve
    through submit with f32 and int8 L1), 6b (its online path), DCN
    (capped) through fit, deploy, rebuild and predict (f32), 6c (the
    serving engine on both bundles), 6d (ETC and online training) and 6e
    (the launchers: open-loop load tests of 6c's ensemble, ``launch.serve``
    on DLRM's single-model bundle, ``launch.train`` of full-width WDL with
    a checkpoint and its resume); then phase 7 (with 6b's fan-out
    count for the full-width recipes): WDL at full width and vocabulary
    through the same, on two HPSes, then DeepFM (capped) as DCN; then
    phase 8: NeuMF at full width and vocabulary through the same as WDL,
    on three HPSes, then the two-tower and cross-deep graphs (capped) as
    DCN. Returns the launch counts of their main paths."""
    import torch
    total = {}
    dlrm = capped_config(args)
    print(reduced_line(args, dlrm,
                       recipe_config(args, "dlrm-criteo", capped=False)))
    short = types.SimpleNamespace(**{**vars(args), "lr": args.recipe_lr})
    dlrm_model = recipe_run(args, dev, dlrm, args.timed_steps,
                            ("f32", "int8"), True, total,
                            online=online_phase, keep=True)
    dcn = recipe_config(args, "dcn-criteo", capped=True)
    print(reduced_line(args, dcn,
                       recipe_config(args, "dcn-criteo", capped=False)))
    dcn_model = recipe_run(short, dev, dcn, args.recipe_timed_steps,
                           ("f32",), False, total, keep=True)
    try:
        served = serving_engine_phase(args, dev, dlrm_model, dcn_model,
                                      total)
        del dcn_model
        gc.collect()
        torch.cuda.empty_cache()
        etc_phase(args, dev, dlrm_model, total)
        del dlrm_model
        gc.collect()
        torch.cuda.empty_cache()
        front_doors_phase(args, dev, served, total)
        train_launcher_phase(args, dev, total)
    finally:
        shutil.rmtree(os.path.join(ROOT, "_smoke_bundle"),
                      ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    for full, capped in (("wdl-criteo", ("deepfm-criteo",)),
                         ("neumf-criteo", ("twotower-criteo",
                                           "crossdeep-criteo"))):
        cfg = recipe_config(args, full, capped=False)
        print(full_line(cfg))
        recipe_run(args, dev, cfg, args.timed_steps, ("f32", "int8"), True,
                   total, online=online_fanout)
        for arch in capped:
            cfg = recipe_config(args, arch, capped=True)
            print(reduced_line(args, cfg,
                               recipe_config(args, arch, capped=False)))
            recipe_run(short, dev, cfg, args.recipe_timed_steps, ("f32",),
                       False, total)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_phase(args, dev, total)
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

    # 4-8. train, deploy, serve: DLRM, WDL, DCN, DeepFM; NeuMF, two-tower,
    # cross-deep
    total = recsys_phases(args, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 9. LM serve
    from repro_torch.configs.registry import get_lm_config
    lm_cfg = get_lm_config(args.lm_arch)
    for k, n in lm_phase(args, dev, lm_cfg).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()

    # 10-11. LM train: the kernels against the plain path at depth 2, then
    # the full-width steps
    lm_grad_check(args, dev, lm_cfg, args.lm_check_layers)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in lm_train_phase(args, dev, lm_cfg).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()

    # 12. the remat policies' peaks at full width
    remat_phase(args, dev, lm_cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # 13. recurrentgemma: serve at full width and depth, then train a
    # full-width copy at depth 5, checked against the plain path
    rg_cfg = get_lm_config(args.rg_arch)
    for k, n in lm_phase(args, dev, rg_cfg, f32_replay=True).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    decode_depths(args, dev, rg_cfg, args.rg_decode_depths)
    lm_grad_check(args, dev, rg_cfg, args.rg_train_layers)
    gc.collect()
    torch.cuda.empty_cache()
    period = len(rg_cfg.block_pattern)
    cut = (f"one {period}-layer pattern period and the "
           f"{args.rg_train_layers - period}-layer tail of the published "
           f"{rg_cfg.num_layers}: f32 weights and gradients of all "
           f"{rg_cfg.num_layers} take about 75 GB")
    rg_small = dataclasses.replace(rg_cfg, num_layers=args.rg_train_layers)
    for k, n in lm_train_phase(args, dev, rg_small, cut).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()

    # 15. granite-moe-3b-a800m: serve at full width and depth (the decode
    # replay held as recurrentgemma's, and a 5-layer copy to the bf16
    # bound), the kernels against the plain path at depth 2, then train at
    # full depth
    g_cfg = get_lm_config(args.granite_arch)
    for k, n in lm_phase(args, dev, g_cfg, f32_replay=True).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    decode_depths(args, dev, no_drop(g_cfg), (5,))
    gc.collect()
    torch.cuda.empty_cache()
    lm_grad_check(args, dev, g_cfg, args.lm_check_layers)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in lm_train_phase(args, dev, g_cfg).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()

    # 8c. the LM on the mesh: granite and the depth-5 recurrentgemma against
    # their one-device steps of phases 15 and 14, then the launcher
    lm_mesh_phase(args, dev, total)

    # 8d. sequence-parallel attention, each rank's part replayed in turn
    seqpar_phase(args, dev, total)
    gc.collect()
    torch.cuda.empty_cache()

    # 16. xlstm-125m at full width and depth on a shorter sequence: serve,
    # a gradient against the plain path, train
    x_cfg = get_lm_config(args.xlstm_arch)
    xargs = types.SimpleNamespace(**{
        **vars(args), "lm_seq": args.xlstm_seq, "lm_timed": args.xlstm_timed,
        "lm_train_timed": args.xlstm_train_timed})
    why = (f" (sequence {args.xlstm_seq}, not the other LM phases' "
           f"{args.lm_seq}: the mLSTM / sLSTM recurrences run as Python "
           "loops, about 270 launches a token forward)")
    t0 = time.perf_counter()
    for k, n in lm_phase(xargs, dev, x_cfg, cut=why,
                         profile_seq=args.xlstm_profile_seq).items():
        total[k] = total.get(k, 0) + n
    lm_grad_check(xargs, dev, x_cfg, args.lm_check_layers)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in lm_train_phase(xargs, dev, x_cfg, cut=why,
                               profile_seq=args.xlstm_profile_seq).items():
        total[k] = total.get(k, 0) + n
    print(f"xlstm phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 17. seamless-m4t-large-v2 at full width and depth: serve (frames
    # through the 24-layer encoder, cross-attention through K7 with the
    # encoder's 512 keys), the kernels against the plain path on a copy cut
    # to 2 + 2 layers, then SGD at full depth
    sm_cfg = get_lm_config(args.seamless_arch)
    t0 = time.perf_counter()
    for k, n in frontend_phase(args, dev, sm_cfg).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    lm_grad_check(args, dev, sm_cfg, args.lm_check_layers)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in lm_train_phase(args, dev, sm_cfg).items():
        total[k] = total.get(k, 0) + n
    print(f"seamless phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 18. pixtral-12b at full width and depth: serve (1024 patch positions
    # ahead of 3072 text tokens), then SGD on a full-width copy cut in
    # depth
    px_cfg = get_lm_config(args.pixtral_arch)
    t0 = time.perf_counter()
    for k, n in frontend_phase(args, dev, px_cfg).items():
        total[k] = total.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    px_small = depth_cut(px_cfg, args.pixtral_train_layers)
    cut = (f"{args.pixtral_train_layers} of the published "
           f"{px_cfg.num_layers}: f32 weights and gradients of all "
           f"{px_cfg.num_layers} take about 98 GB")
    for k, n in lm_train_phase(args, dev, px_small, cut).items():
        total[k] = total.get(k, 0) + n
    print(f"pixtral phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 19. the example twins
    twins_phase(dev)

    # 20. kernels line, then the device line last
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
