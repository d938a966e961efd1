"""``LMModel`` for the dense decoder family on one device (counterpart of
``repro/models/lm/backbone.py``).

The paper's technique shows up as the vocabulary embedding modes, as in the
reference: LM token tables are Zipf-accessed like CTR features, so the
hybrid hot/cold split applies. On one device:

* ``replicated`` — one ``[V, D]`` table;
* ``sharded``    — one ``[V_pad, D]`` table (the reference stripes its rows
  over the mesh; on one device that is the whole table);
* ``hybrid``     — a hot ``[V·hot_fraction, D]`` table for the lowest ids
  and a cold table for the rest, each read by its own lookup and summed.

Every lookup is the pooled-lookup kernel K1 with one id a row (-1 where the
mode masks the id out), whose gradient is the dense adjoint K3, and
attention is the flash kernel K7 with K8 as its backward. With
``use_kernels=False`` all run their plain versions on any device: the
in-port reference path.

Ported: ``init``, ``embed``, ``train_loss`` (with the chunked
cross-entropy), ``prefill``, ``init_cache`` and ``decode_step`` for the
dense decoders (phi3-mini, minitron-4b, command-r-plus, olmo-1b), the
hybrid of RG-LRU and local-attention blocks (recurrentgemma: local
attention is K7 / K8 with a window, its decode a rolling cache), the MoE
decoders (granite: every attention layer's FFN is ``moe.moe_apply``) and
xLSTM (mLSTM and sLSTM blocks, no FFN), with every ``remat`` policy of
the reference. The encoder-decoder families raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Layers run group-major, as the reference scans them: every layer of
pattern slot 0, then of slot 1, ..., then the tail.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    noop_context_fn,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_lookup import lookup_fwd_plain
from repro_torch.models.lm import moe
from repro_torch.models.lm import rglru as rg
from repro_torch.models.lm import transformer as tf
from repro_torch.models.lm import xlstm as xl
from repro_torch.tree import tree_map

EMBED_MODES = ("replicated", "sharded", "hybrid")
REMATS = ("none", "full", "dots", "group")
KINDS = ("attn", "local_attn", "rglru", "mlstm", "slstm")
#: the kinds whose decode state is a dict of f32 tensors, not a KV cache
RECURRENT = ("rglru", "mlstm", "slstm")

#: the matmul ops whose outputs ``remat="dots"`` saves, as
#: ``jax.checkpoint_policies.checkpoint_dots`` saves ``dot_general``'s
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _check_ported(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` (naming its ROADMAP item) for a config
    outside the decoder families the port has."""
    if cfg.encoder_layers or cfg.frontend:
        raise tf.not_ported(f"{cfg.name}: encoder layers and modality "
                            "frontends", tf.ENCDEC)
    for kind in cfg.block_pattern:
        if kind not in KINDS:
            raise ValueError(kind)


def _layers(stacked: Dict, n: int) -> List[Dict]:
    """The ``n`` layers of a stacked ``[n, ...]`` params tree, each leaf
    split once by ``unbind``: its backward stacks the layers' gradients
    into one ``[n, ...]`` tensor, where ``a[i]`` of each layer would add a
    zero-filled tensor the size of the whole leaf per layer."""
    split = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


class LMModel:
    """``device`` resolves as every port entry point does (``cuda`` unless
    given ``"cpu"``); ``embed_mode="auto"`` picks as the reference does:
    ``hybrid`` from 100,000 tokens, else ``sharded`` above 2**26 table
    entries, else ``replicated``. ``loss_chunk`` is the cross-entropy's
    sequence chunk. ``remat`` is the reference's policy for the pattern
    groups' layers (the tail is never recomputed): ``"full"`` recomputes
    each layer in backward (``torch.utils.checkpoint``, as
    ``jax.checkpoint``), ``"dots"`` saves only the matmuls' outputs
    (``checkpoint_dots``), ``"group"`` is the nested sqrt(L) remat."""

    def __init__(self, cfg: LMConfig, *, device: DeviceLike = None,
                 embed_mode: str = "auto", hot_fraction: float = 0.05,
                 loss_chunk: int = 512, remat: str = "none",
                 use_kernels: bool = True):
        _check_ported(cfg)
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} not in {REMATS}")
        self.cfg = cfg
        self.loss_chunk = loss_chunk
        self.remat = remat
        self.device = resolve_device(device)
        self.cd = torch.bfloat16 if cfg.dtype == "bf16" else torch.float32
        self.use_kernels = use_kernels
        if embed_mode == "auto":
            embed_mode = "hybrid" if cfg.vocab_size >= 100_000 else \
                "sharded" if cfg.vocab_size * cfg.d_model > 2 ** 26 else \
                "replicated"
        if embed_mode not in EMBED_MODES:
            raise ValueError(f"embed_mode {embed_mode!r} not in "
                             f"{EMBED_MODES}")
        self.embed_mode = embed_mode
        # one device: no row padding to a shard count
        self.hot_rows = max(1, int(cfg.vocab_size * hot_fraction)) \
            if embed_mode == "hybrid" else 0
        self.cold_rows = cfg.vocab_size - self.hot_rows
        self.vocab_pad = cfg.vocab_size
        self.pattern = cfg.block_pattern
        per = len(self.pattern)
        self.n_groups = cfg.num_layers // per
        self.n_tail = cfg.num_layers - self.n_groups * per
        self.tail_pattern = cfg.block_pattern[:self.n_tail]

    def _group_keys(self):
        """``(params key, kind, layers)`` of every stacked group."""
        return ([(f"{pi}_{kind}", kind, self.n_groups)
                 for pi, kind in enumerate(self.pattern)]
                + [(f"tail{pi}_{kind}", kind, 1)
                   for pi, kind in enumerate(self.tail_pattern)])

    # ------------------------------------------------------------------ init

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """f32 params with the reference's tree keys and distributions,
        drawn from ``generator`` (on the model's device; seed 0 if none)."""
        cfg, dev = self.cfg, self.device
        g = generator or torch.Generator(device=dev).manual_seed(0)
        d = cfg.d_model
        scale = 1.0 / math.sqrt(d)
        params: Dict = {}
        if self.embed_mode == "hybrid":
            params["embed_hot"] = tf._normal(g, (self.hot_rows, d), scale,
                                             dev)
            params["embed_cold"] = tf._normal(g, (self.cold_rows, d), scale,
                                              dev)
        else:
            rows = self.vocab_pad if self.embed_mode == "sharded" \
                else cfg.vocab_size
            params["embed"] = tf._normal(g, (rows, d), scale, dev)
        if not cfg.tie_embeddings:
            params["head"] = tf._normal(g, (d, self.vocab_pad), scale, dev)
        params["final_norm"] = tf.norm_init(cfg, device=dev)
        params["groups"] = {
            key: self._block_init(g, kind, n)
            for key, kind, n in self._group_keys()}
        return params

    def _block_init(self, g: torch.Generator, kind: str, n: int) -> Dict:
        """``n`` stacked layers of one kind: ``{"attn", "ffn"}`` for
        (local) attention (the FFN an MoE one for an MoE config's ``attn``
        layers), ``{"rglru", "ffn"}`` for an RG-LRU block, ``{"mlstm"}``
        or ``{"slstm"}`` for an xLSTM block."""
        cfg, dev, stack = self.cfg, self.device, (n,)
        if kind in ("mlstm", "slstm"):
            init = xl.mlstm_init if kind == "mlstm" else xl.slstm_init
            return {kind: init(g, cfg, stack=stack, device=dev)}
        mix = (rg.rglru_init(g, cfg, stack=stack, device=dev)
               if kind == "rglru"
               else tf.attn_init(g, cfg, stack=stack, device=dev))
        ffn = (moe.moe_init(g, cfg, stack=stack, device=dev)
               if cfg.moe is not None and kind == "attn"
               else tf.ffn_init(g, cfg, stack=stack, device=dev))
        return {"rglru" if kind == "rglru" else "attn": mix, "ffn": ffn}

    # ----------------------------------------------------------------- embed

    def embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens [B, S]`` -> ``[B, S, D]`` in the compute type: lookups
        of one id a row (K1, with K3 as the tables' gradient), exact f32
        rows, summed (hybrid) and cast."""
        lookup = ops.fused_embedding_lookup if self.use_kernels \
            else lookup_fwd_plain
        ids = tokens.reshape(-1, 1).to(torch.int32)
        if self.embed_mode == "hybrid":
            is_hot = ids < self.hot_rows
            none = torch.full_like(ids, -1)
            x = lookup(params["embed_hot"], torch.where(is_hot, ids, none)) \
                + lookup(params["embed_cold"],
                         torch.where(is_hot, none, ids - self.hot_rows))
        else:
            x = lookup(params["embed"], ids)
        return x.reshape(*tokens.shape, -1).to(self.cd)

    def _head_parts(self, params: Dict):
        """Output head as a list of ``[D, V_part]`` matrices (tied hybrid
        stays in its two parts; the logits are their concatenation)."""
        if self.cfg.tie_embeddings:
            if self.embed_mode == "hybrid":
                return [params["embed_hot"].T, params["embed_cold"].T]
            return [params["embed"].T]
        return [params["head"]]

    @property
    def logits_size(self) -> int:
        if self.cfg.tie_embeddings and self.embed_mode == "hybrid":
            return self.hot_rows + self.cold_rows
        return self.vocab_pad

    def _logits(self, params: Dict, h: torch.Tensor) -> torch.Tensor:
        """``h [B, D]`` -> f32 logits ``[B, logits_size]``."""
        return torch.cat([(h @ hp.to(self.cd)).float()
                          for hp in self._head_parts(params)], dim=-1)

    # ---------------------------------------------------------------- blocks

    def _apply_block(self, kind: str, bp: Dict, x, *, positions,
                     cache=None, cache_pos=None):
        """One layer; ``cache`` is a (local) attention layer's ``(k, v)``
        or a recurrent layer's state, and the new one is returned."""
        cfg = self.cfg
        if kind in ("mlstm", "slstm"):
            apply = xl.mlstm_apply if kind == "mlstm" else xl.slstm_apply
            return apply(bp[kind], x, cfg, state=cache)
        if kind == "rglru":
            x, new_cache = rg.rglru_apply(bp["rglru"], x, cfg, state=cache)
        else:
            window = cfg.local_attn_window if kind == "local_attn" else None
            x, new_cache = tf.attn_apply(
                bp["attn"], x, cfg, positions=positions, causal=True,
                window=window, cache=cache, cache_pos=cache_pos,
                use_kernels=self.use_kernels)
        if cfg.moe is not None and kind == "attn":
            # adds its own residual, as the FFN does
            return moe.moe_apply(bp["ffn"], x, cfg), new_cache
        return tf.ffn_apply(bp["ffn"], x, cfg), new_cache

    def _run_stack(self, params: Dict, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        """Every layer in order; returns the final hidden states. Under
        ``checkpoint`` backward keeps a layer's input and runs it again:
        every layer with ``"full"``; with ``"dots"`` too, but keeping the
        matmuls' outputs; with ``"group"`` each of ``outer`` blocks of a
        group's layers (``outer`` the largest divisor of the layer count
        at most its square root), and each layer inside it. The tail
        layers run plain, as in the reference."""
        def block(h, lp, kind):
            return self._apply_block(kind, lp, h, positions=positions)[0]

        def run(h, lps, kind):
            for lp in lps:
                h = checkpoint(block, h, lp, kind, use_reentrant=False)
            return h

        for key, kind, n in self._group_keys():
            lps = _layers(params["groups"][key], n)
            if key.startswith("tail") or self.remat == "none":
                for lp in lps:
                    x = block(x, lp, kind)
            elif self.remat == "group":
                outer = max(1, math.isqrt(n))
                while n % outer:
                    outer -= 1
                inner = n // outer
                for o in range(outer):
                    x = checkpoint(run, x, lps[o * inner:(o + 1) * inner],
                                   kind, use_reentrant=False)
            else:
                ctx = _dots_context if self.remat == "dots" else \
                    noop_context_fn
                for lp in lps:
                    x = checkpoint(block, x, lp, kind, use_reentrant=False,
                                   context_fn=ctx)
        return x

    # ---------------------------------------------------------------- train

    def train_loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"] [B, S]`` (the
        last position has no label); f32 scalar."""
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        x = self.embed(params, tokens)
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        x = self._run_stack(params, x, positions)
        x = tf.norm_apply(params.get("final_norm", {}), x, self.cfg)
        labels = torch.cat([tokens[:, 1:],
                            torch.full((b, 1), -1, dtype=tokens.dtype,
                                       device=self.device)], dim=1)
        return self._xent(params, x, labels)

    def _xent(self, params: Dict, h: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """Cross-entropy in ``loss_chunk`` sequence chunks, so ``[B, S, V]``
        logits never exist at once: each chunk's body runs under
        ``checkpoint`` and backward recomputes its logits. The heads are
        cast to the compute type once; labels of -1 are not counted."""
        heads = [hp.to(self.cd) for hp in self._head_parts(params)]
        chunk = min(self.loss_chunk, h.shape[1])
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.int64, device=h.device)
        for c0 in range(0, h.shape[1], chunk):
            lc = labels[:, c0:c0 + chunk]
            total = total + checkpoint(self._xent_chunk, h[:, c0:c0 + chunk],
                                       lc, *heads, use_reentrant=False)
            count = count + (lc >= 0).sum()
        return total / count.clamp_min(1)

    def _xent_chunk(self, hc: torch.Tensor, lc: torch.Tensor,
                    *heads: torch.Tensor) -> torch.Tensor:
        """The summed loss of one chunk: f32 logits, ``logsumexp -
        logit[label]`` over the valid labels. (The reference also masks
        the vocabulary's padding to the mesh; on one device there is
        none: ``logits_size == vocab_size``.)"""
        logits = torch.cat([(hc @ hp).float() for hp in heads], dim=-1)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lc.clamp_min(0)[..., None].long())[..., 0]
        return torch.where(lc >= 0, lse - ll, 0.0).sum()

    # ---------------------------------------------------------------- serve

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def prefill(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Full-sequence forward of ``batch["tokens"] [B, S]``; returns the
        last position's f32 logits ``[B, logits_size]``."""
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        x = self.embed(params, tokens)
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        x = self._run_stack(params, x, positions)
        x = tf.norm_apply(params.get("final_norm", {}), x, self.cfg)
        return self._logits(params, x[:, -1])

    def init_cache(self, b: int, max_seq: int) -> Dict:
        """Zero decode state per stacked group: an attention group's KV
        cache ``(k, v)``, each ``[layers, B, S, Hkv, Dh]`` in the compute
        type with S ``max_seq`` (``min(max_seq, window)`` for local
        attention, a rolling cache); a recurrent group's state in f32,
        each leaf ``[layers, B, ...]``: ``{"h", "conv"}`` for RG-LRU,
        ``{"C", "n", "m"}`` for mLSTM, ``{"c", "n", "h", "m"}`` for
        sLSTM."""
        cfg = self.cfg
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        zero_state = {"rglru": rg.rglru_zero_state,
                      "mlstm": xl.mlstm_zero_state,
                      "slstm": xl.slstm_zero_state}

        def blk_cache(kind, n):
            if kind in RECURRENT:
                return zero_state[kind](cfg, b, stack=(n,),
                                        device=self.device)
            s = min(max_seq, cfg.local_attn_window) \
                if kind == "local_attn" else max_seq
            return tuple(torch.zeros((n, b, s, hkv, hd), dtype=self.cd,
                                     device=self.device) for _ in range(2))
        return {"groups": {key: blk_cache(kind, n)
                           for key, kind, n in self._group_keys()}}

    def decode_step(self, params: Dict, tokens, cache: Dict, pos
                    ) -> Tuple[torch.Tensor, Dict]:
        """``tokens [B, 1]``, ``pos [B]`` -> (f32 logits ``[B,
        logits_size]``, the cache). Each layer's new K/V (at ``pos``, or
        ``pos % S`` in a rolling cache) and each recurrent layer's new
        state are written into ``cache`` in place; the returned cache is
        that one."""
        tokens = self._tokens(tokens)
        pos = self._tokens(pos)
        x = self.embed(params, tokens)
        positions = pos[:, None]
        new_cache: Dict = {"groups": {}}
        for key, kind, n in self._group_keys():
            gp = params["groups"][key]
            gc = cache["groups"][key]
            for i, lp in enumerate(_layers(gp, n)):
                if kind in RECURRENT:
                    x, st = self._apply_block(
                        kind, lp, x, positions=positions,
                        cache={k: v[i] for k, v in gc.items()})
                    for k, v in st.items():
                        gc[k][i].copy_(v)
                else:
                    x, _ = self._apply_block(
                        kind, lp, x, positions=positions,
                        cache=(gc[0][i], gc[1][i]), cache_pos=pos)
            new_cache["groups"][key] = gc
        x = tf.norm_apply(params.get("final_norm", {}), x, self.cfg)
        return self._logits(params, x[:, 0]), new_cache
