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
cross-entropy), ``prefill``, ``init_cache`` and ``decode_step`` for
``block_pattern == ("attn",)`` without MoE, encoder or frontend
(phi3-mini, minitron-4b, command-r-plus, olmo-1b), with ``remat`` "none"
or "full". The other families and remat policies raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_lookup import lookup_fwd_plain
from repro_torch.models.lm import transformer as tf
from repro_torch.tree import tree_map

EMBED_MODES = ("replicated", "sharded", "hybrid")
REMATS = ("none", "full", "dots", "group")


def _check_ported(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` (naming its ROADMAP item) for a config
    outside the dense decoder family this slice ports."""
    if cfg.moe is not None:
        raise tf.not_ported(f"{cfg.name}: MoE blocks", tf.MOE)
    if cfg.encoder_layers or cfg.frontend:
        raise tf.not_ported(f"{cfg.name}: encoder layers and modality "
                            "frontends", tf.ENCDEC)
    for kind in cfg.block_pattern:
        if kind in ("rglru", "local_attn"):
            raise tf.not_ported(f"{cfg.name}: {kind} blocks", tf.RGLRU)
        if kind in ("mlstm", "slstm"):
            raise tf.not_ported(f"{cfg.name}: {kind} blocks", tf.XLSTM)
        if kind != "attn":
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
    sequence chunk; ``remat="full"`` recomputes each layer in backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``."""

    def __init__(self, cfg: LMConfig, *, device: DeviceLike = None,
                 embed_mode: str = "auto", hot_fraction: float = 0.05,
                 loss_chunk: int = 512, remat: str = "none",
                 use_kernels: bool = True):
        _check_ported(cfg)
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} not in {REMATS}")
        if remat in ("dots", "group"):
            raise tf.not_ported(f'remat="{remat}"', tf.LM_REMAT)
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
            key: {"attn": tf.attn_init(g, cfg, stack=(n,), device=dev),
                  "ffn": tf.ffn_init(g, cfg, stack=(n,), device=dev)}
            for key, _, n in self._group_keys()}
        return params

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
        x, new_cache = tf.attn_apply(
            bp["attn"], x, self.cfg, positions=positions, causal=True,
            cache=cache, cache_pos=cache_pos, use_kernels=self.use_kernels)
        return tf.ffn_apply(bp["ffn"], x, self.cfg), new_cache

    def _run_stack(self, params: Dict, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        """Every layer in order; returns the final hidden states. With
        ``remat="full"`` each layer runs under ``checkpoint``: backward
        keeps its input only and runs it again."""
        def block(h, lp, kind):
            return self._apply_block(kind, lp, h, positions=positions)[0]

        for key, kind, n in self._group_keys():
            for lp in _layers(params["groups"][key], n):
                if self.remat == "full":
                    x = checkpoint(block, x, lp, kind, use_reentrant=False)
                else:
                    x = block(x, lp, kind)
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
        """Zero KV caches, ``(k, v)`` each ``[layers, B, max_seq, Hkv, Dh]``
        in the compute type, per stacked group."""
        hkv, hd = self.cfg.num_kv_heads, self.cfg.resolved_head_dim

        def zeros(n):
            return torch.zeros((n, b, max_seq, hkv, hd), dtype=self.cd,
                               device=self.device)
        return {"groups": {key: (zeros(n), zeros(n))
                           for key, _, n in self._group_keys()}}

    def decode_step(self, params: Dict, tokens, cache: Dict, pos
                    ) -> Tuple[torch.Tensor, Dict]:
        """``tokens [B, 1]``, ``pos [B]`` -> (f32 logits ``[B,
        logits_size]``, the cache). Each layer's new K/V are written into
        ``cache`` in place at ``pos``; the returned cache is that one."""
        tokens = self._tokens(tokens)
        pos = self._tokens(pos)
        x = self.embed(params, tokens)
        positions = pos[:, None]
        new_cache: Dict = {"groups": {}}
        for key, kind, n in self._group_keys():
            gp = params["groups"][key]
            kc, vc = cache["groups"][key]
            for i, lp in enumerate(_layers(gp, n)):
                x, _ = self._apply_block(kind, lp, x, positions=positions,
                                         cache=(kc[i], vc[i]), cache_pos=pos)
            new_cache["groups"][key] = (kc, vc)
        x = tf.norm_apply(params.get("final_norm", {}), x, self.cfg)
        return self._logits(params, x[:, 0]), new_cache
