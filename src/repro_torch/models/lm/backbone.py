"""``LMModel`` for the LM families, on one device or on a mesh
(counterpart of ``repro/models/lm/backbone.py``).

The paper's technique shows up as the vocabulary embedding modes, as in the
reference: LM token tables are Zipf-accessed like CTR features, so the
hybrid hot/cold split applies:

* ``replicated`` — one ``[V, D]`` table, whole on every rank;
* ``sharded``    — one ``[V_pad, D]`` table, its rows striped over the
  mesh's ``"model"`` axis (on one device, the whole table);
* ``hybrid``     — a hot ``[max(n_dev, V·hot_fraction), D]`` table for the
  lowest ids, whole on every rank, and a cold table for the rest, striped
  over ``"model"`` like ``sharded``; each read by its own lookup, summed.

Every lookup is the pooled-lookup kernel K1 with one id a row (-1 where the
mode or the stripe masks the id out), whose gradient is the dense adjoint
K3, and attention is the flash kernel K7 with K8 as its backward. With
``use_kernels=False`` all run their plain versions on any device: the
in-port reference path.

Ported: ``init``, ``embed``, ``train_loss`` (with the chunked
cross-entropy), ``prefill``, ``init_cache`` and ``decode_step`` for the
dense decoders (phi3-mini, minitron-4b, command-r-plus, olmo-1b), the
hybrid of RG-LRU and local-attention blocks (recurrentgemma: local
attention is K7 / K8 with a window, its decode a rolling cache), the MoE
decoders (granite: every attention layer's FFN is ``moe.moe_apply``),
xLSTM (mLSTM and sLSTM blocks, no FFN), the encoder-decoder (seamless:
``frames [B, S_f, D]``, a stub frontend with no parameters, through a
non-causal encoder stack; every decoder layer's cross-attention reads its
output through K7 / K8 with the encoder's key length) and the vision
prefix (pixtral: ``patches [B, S_img, D]`` ahead of the token
embeddings, the loss on the text positions only), with every ``remat``
policy of the reference (the encoder-decoder's as the reference maps
them: ``"dots"`` and ``"group"`` both save the matmuls, and the encoder
is never recomputed). Decode never sees ``frames`` or ``patches``, as in
the reference.

On a mesh (``launch.mesh``: one rank a device, axes ``("data",
"model")``) every method takes and returns this rank's data-parallel
block of the batch, the same on each rank of a model group, and the
reference's three ``shard_map`` regions run over the ``"model"`` axis:

* ``_sharded_lookup``: each rank looks its block's ids up in its own
  stripe (K1, ids outside it -1 holes; K3 the backward), casts its part to
  the compute type, and the parts are summed once over ``"model"``
  (exactly one stripe holds each id);
* the head and the loss, vocab-parallel: a tied ``sharded`` or
  ``hybrid`` table is never gathered; each rank takes the logits of its
  own stripe, and the cross-entropy's log-sum-exp runs over ``"model"``
  (the max, the sum of exponentials and the label's logit each summed or
  maxed over the axis; the hot logits, alike on every rank, enter once),
  the vocabulary's padding to the axis masked; ``prefill`` and
  ``decode_step`` gather the rows' whole logits over ``"model"``;
* the MoE's experts (``moe.moe_apply_local``).

The loss is the global mean (its sum and count summed over the data
axes). Each sum over ``"model"`` back-propagates as the identity, and each
value that the ranks of a model group hold alike and feed into their own
shard's work sums its gradient over the group on the way back
(``strategies.all_reduce`` / ``copy_to_group``); :meth:`LMModel.
reduce_grads` then sums every gradient over the data axes. Attention
follows the reference's rule: the ``"heads"`` partition runs whole on the
rank's block (the reference's head sharding is a placement that changes
no value); the ``"seq"`` partition is ``transformer.seqpar_attention``
over ``"model"`` for the causal self-attention layers (each rank its
shard of the queries against the whole K/V, K7 / K8 with a causal query
offset, the shards gathered along the sequence; the encoder-decoder's
layers never take it, as in the reference). :meth:`LMModel.shard_params` and
:meth:`LMModel.gather_params` move whole (logical) parameters, as the
reference draws them at the mesh's padded shapes, to a rank's and back.

Layers run group-major, as the reference scans them: every layer of
pattern slot 0, then of slot 1, ..., then the tail.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    noop_context_fn,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LMConfig
from repro_torch.core.embedding.common import masked_range_lookup
from repro_torch.core.embedding.strategies import (
    all_gather, all_reduce, copy_to_group)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_lookup import lookup_fwd_plain
from repro_torch.models.lm import moe
from repro_torch.models.lm import rglru as rg
from repro_torch.models.lm import transformer as tf
from repro_torch.models.lm import xlstm as xl
from repro_torch.launch import mesh as meshlib
from repro_torch.tree import flatten, tree_map, unflatten

EMBED_MODES = ("replicated", "sharded", "hybrid")
ATTN_PARTITIONS = ("auto", "heads", "seq")
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


def _check_kinds(cfg: LMConfig) -> None:
    """Raise ``ValueError`` for a block kind the reference does not have."""
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
    given ``"cpu"``); ``mesh`` (a ``launch.mesh`` mesh with a ``"model"``
    axis, this rank in it) spreads the model over ranks, None runs it on
    one device. ``embed_mode="auto"`` picks as the reference does:
    ``hybrid`` from 100,000 tokens, else ``sharded`` above 2**26 table
    entries, else ``replicated``. ``loss_chunk`` is the cross-entropy's
    sequence chunk. ``remat`` is the reference's policy for the pattern
    groups' layers (the tail is never recomputed): ``"full"`` recomputes
    each layer in backward (``torch.utils.checkpoint``, as
    ``jax.checkpoint``), ``"dots"`` saves only the matmuls' outputs
    (``checkpoint_dots``), ``"group"`` is the nested sqrt(L) remat.
    ``attn_partition`` is the reference's rule (``"auto"``: ``"seq"``
    where the model axis does not factor over the KV heads and their
    query groups, or for an FSDP-sized model in training, else
    ``"heads"``)."""

    def __init__(self, cfg: LMConfig, mesh=None, *,
                 device: DeviceLike = None, embed_mode: str = "auto",
                 hot_fraction: float = 0.05, loss_chunk: int = 512,
                 remat: str = "none", attn_partition: str = "auto",
                 use_kernels: bool = True):
        _check_kinds(cfg)
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} not in {REMATS}")
        if attn_partition not in ATTN_PARTITIONS:
            raise ValueError(f"attn_partition {attn_partition!r} not in "
                             f"{ATTN_PARTITIONS}")
        self.cfg = cfg
        self.mesh = mesh
        self.loss_chunk = loss_chunk
        self.remat = remat
        self.device = resolve_device(device)
        self.cd = torch.bfloat16 if cfg.dtype == "bf16" else torch.float32
        self.use_kernels = use_kernels
        if mesh is None:
            self.model_size = self.n_dev = 1
        else:
            shape = meshlib.mesh_shape(mesh)
            if "model" not in shape:
                raise ValueError(f"an LM mesh needs a 'model' axis, got "
                                 f"{tuple(shape)}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot run a "
                                 f"model on {self.device}")
            self.model_size = shape["model"]
            self.n_dev = meshlib.mesh_size(mesh)
        if embed_mode == "auto":
            embed_mode = "hybrid" if cfg.vocab_size >= 100_000 else \
                "sharded" if cfg.vocab_size * cfg.d_model > 2 ** 26 else \
                "replicated"
        if embed_mode not in EMBED_MODES:
            raise ValueError(f"embed_mode {embed_mode!r} not in "
                             f"{EMBED_MODES}")
        self.embed_mode = embed_mode
        # FSDP-sized: TP-only sharding would blow past the device's memory
        self.fsdp = cfg.dense_param_count * 12 / self.model_size > 10e9
        self.hot_rows = max(self.n_dev, int(cfg.vocab_size * hot_fraction)) \
            if embed_mode == "hybrid" else 0
        # the cold / sharded rows padded to the stripes over "model" (the
        # reference's default embed_shard_axes); one device pads nothing
        m = self.model_size
        self.cold_rows = -(-(cfg.vocab_size - self.hot_rows) // m) * m
        self.vocab_pad = -(-cfg.vocab_size // m) * m
        if attn_partition == "auto":
            dirty = False
            if self.model_size > 1 and cfg.num_kv_heads > 0:
                a = math.gcd(cfg.num_kv_heads, self.model_size)
                group = cfg.num_heads // cfg.num_kv_heads
                dirty = group % (self.model_size // a) != 0
            training = remat != "none"
            attn_partition = "seq" if (dirty or (self.fsdp and training)) \
                else "heads"
        self.attn_partition = attn_partition
        self._seq_par_mesh = mesh if attn_partition == "seq" else None
        self.pattern = cfg.block_pattern
        per = len(self.pattern)
        self.n_groups = cfg.num_layers // per
        self.n_tail = cfg.num_layers - self.n_groups * per
        self.tail_pattern = cfg.block_pattern[:self.n_tail]

    # ------------------------------------------------------------------ mesh

    @property
    def _model_group(self):
        return meshlib.axis_group(self.mesh, ("model",))

    @property
    def _model_index(self) -> int:
        return self.mesh.get_local_rank("model")

    @property
    def _dp_axes(self) -> Tuple[str, ...]:
        return meshlib.dp_axes(self.mesh)

    @property
    def vocab_parallel(self) -> bool:
        """Whether the head is this rank's stripe of a tied striped table
        (the logits of its own vocabulary slice), not a whole matrix."""
        return self.mesh is not None and self.cfg.tie_embeddings and \
            self.embed_mode in ("sharded", "hybrid")

    def data_block(self, x):
        """This rank's data-parallel block of a global batch's leading
        axis (the whole batch without a mesh); the batch must divide over
        the data axes."""
        if self.mesh is None:
            return x
        n = meshlib.axis_size(self.mesh, self._dp_axes)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over the "
                             f"{n} data-parallel ranks of the mesh")
        blk = x.shape[0] // n
        i = meshlib.axis_index(self.mesh, self._dp_axes)
        return x[i * blk:(i + 1) * blk]

    def _striped(self, key: str) -> Optional[int]:
        """The axis of leaf ``key`` (a ``/``-joined params path) striped
        over ``"model"``: the rows of ``embed`` (``sharded``) and
        ``embed_cold`` (``hybrid``), the experts of an MoE layer's ``w1``,
        ``w2``, ``w3`` (axis 1, after the layer axis); None for a leaf
        every rank holds whole."""
        if self.mesh is None:
            return None
        if key == {"sharded": "embed", "hybrid": "embed_cold"}.get(
                self.embed_mode):
            return 0
        parts = key.split("/")
        if self.cfg.moe is not None and len(parts) == 4 and \
                parts[0] == "groups" and parts[2] == "ffn" and \
                parts[3] in ("w1", "w2", "w3"):
            return 1
        return None

    def shard_params(self, params: Dict) -> Dict:
        """Whole parameters (the reference's ``init`` tree at this mesh's
        padded shapes) -> this rank's: its stripe of each striped leaf,
        the other leaves as they are. Without a mesh, ``params``."""
        if self.mesh is None:
            return params
        m, i = self.model_size, self._model_index
        out = {}
        for key, v in flatten(params):
            ax = self._striped(key)
            if ax is not None:
                n = v.shape[ax] // m
                v = v.narrow(ax, i * n, n).clone()
            out[key] = v
        return unflatten(out)

    def gather_params(self, params: Dict) -> Dict:
        """Inverse of :meth:`shard_params` on every rank: a rank's
        parameters, or their gradients, -> the whole tree (each striped
        leaf gathered over ``"model"``)."""
        if self.mesh is None:
            return params
        out = {}
        for key, v in flatten(params):
            ax = self._striped(key)
            if ax is not None:
                v = all_gather(v.detach().movedim(ax, 0).contiguous(),
                               self._model_group).movedim(0, ax)
            out[key] = v
        return unflatten(out)

    def reduce_grads(self, grads: Dict) -> Dict:
        """This rank's gradients summed over the data axes, in place: the
        whole gradient of a replicated leaf, and of this rank's stripe of a
        striped one (the ranks of a model group already hold alike the
        gradient of what they share)."""
        if self.mesh is None or \
                meshlib.axis_size(self.mesh, self._dp_axes) == 1:
            return grads
        group = meshlib.axis_group(self.mesh, self._dp_axes)
        for _, g in flatten(grads):
            dist.all_reduce(g, group=group)
        return grads

    def _group_keys(self):
        """``(params key, kind, layers)`` of every stacked group."""
        return ([(f"{pi}_{kind}", kind, self.n_groups)
                 for pi, kind in enumerate(self.pattern)]
                + [(f"tail{pi}_{kind}", kind, 1)
                   for pi, kind in enumerate(self.tail_pattern)])

    # ------------------------------------------------------------------ init

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """f32 params with the reference's tree keys and distributions,
        drawn from ``generator`` (on the model's device; seed 0 if none);
        on a mesh, drawn whole at its padded shapes (alike on every rank
        given one seed) and this rank's kept (:meth:`shard_params`)."""
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
        if cfg.encoder_layers:
            # the reference's backbone.py:186-197: the encoder's layers,
            # then one cross-attention a decoder layer
            e = (cfg.encoder_layers,)
            params["enc_groups"] = {
                "attn": tf.attn_init(g, cfg, stack=e, device=dev),
                "ffn": tf.ffn_init(g, cfg, stack=e, device=dev)}
            params["cross"] = tf.attn_init(g, cfg, stack=(cfg.num_layers,),
                                           device=dev)
        return self.shard_params(params)

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
        ffn = (moe.moe_init(g, cfg, self.model_size, stack=stack,
                            device=dev)
               if cfg.moe is not None and kind == "attn"
               else tf.ffn_init(g, cfg, stack=stack, device=dev))
        return {"rglru" if kind == "rglru" else "attn": mix, "ffn": ffn}

    # ----------------------------------------------------------------- embed

    def embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens [B, S]`` -> ``[B, S, D]`` in the compute type: lookups
        of one id a row (K1, with K3 as the tables' gradient), exact f32
        rows, summed (hybrid) and cast; a striped table through
        :meth:`_sharded_lookup`."""
        lookup = ops.fused_embedding_lookup if self.use_kernels \
            else lookup_fwd_plain
        ids = tokens.reshape(-1, 1).to(torch.int32)
        if self.embed_mode == "hybrid":
            is_hot = ids < self.hot_rows
            none = torch.full_like(ids, -1)
            hot = lookup(params["embed_hot"], torch.where(is_hot, ids, none))
            cold = torch.where(is_hot, none, ids - self.hot_rows)
            if self.mesh is None:
                x = hot + lookup(params["embed_cold"], cold)
            else:
                x = hot.to(self.cd) + self._sharded_lookup(
                    params["embed_cold"], cold)
        elif self.embed_mode == "sharded" and self.mesh is not None:
            x = self._sharded_lookup(params["embed"], ids)
        else:
            x = lookup(params["embed"], ids)
        return x.reshape(*tokens.shape, -1).to(self.cd)

    def _sharded_lookup(self, table: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
        """``ids [N, 1]`` (-1: none) against the rows striped over
        ``"model"``, ``table`` this rank's stripe: the ids in its row range
        looked up (K1; the others -1 holes), cast to the compute type, and
        the parts summed over ``"model"`` -> ``[N, D]``."""
        v0 = self._model_index * table.shape[0]
        part = masked_range_lookup(
            table, ids[:, :, None], v0, compute_dtype=self.cd,
            pool_fn=ops.kernel_pool if self.use_kernels else None)
        return all_reduce(part[:, 0], self._model_group)

    def _head_parts(self, params: Dict):
        """Output head as a list of ``[D, V_part]`` matrices: a tied hybrid
        table stays in its two parts (the logits are their concatenation),
        a tied replicated one is padded to ``vocab_pad`` columns. On a mesh
        a tied striped table gives this rank's stripe
        (:attr:`vocab_parallel`), last."""
        if self.cfg.tie_embeddings:
            if self.embed_mode == "hybrid":
                return [params["embed_hot"].T, params["embed_cold"].T]
            emb = params["embed"]
            if self.embed_mode == "replicated" and \
                    emb.shape[0] < self.vocab_pad:
                emb = torch.cat([emb, emb.new_zeros(
                    (self.vocab_pad - emb.shape[0], emb.shape[1]))])
            return [emb.T]
        return [params["head"]]

    @property
    def logits_size(self) -> int:
        if self.cfg.tie_embeddings and self.embed_mode == "hybrid":
            return self.hot_rows + self.cold_rows
        return self.vocab_pad

    def _logits(self, params: Dict, h: torch.Tensor) -> torch.Tensor:
        """``h [B, D]`` -> f32 logits ``[B, logits_size]`` (on a mesh the
        stripes' columns gathered over ``"model"``)."""
        parts = [(h @ hp.to(self.cd)).float()
                 for hp in self._head_parts(params)]
        if self.vocab_parallel:
            parts[-1] = all_gather(parts[-1].T.contiguous(),
                                   self._model_group).T
        return torch.cat(parts, dim=-1)

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
                use_kernels=self.use_kernels,
                seq_par_mesh=self._seq_par_mesh)
        if cfg.moe is not None and kind == "attn":
            # adds its own residual, as the FFN does
            if self.mesh is not None:
                return moe.moe_apply_local(
                    bp["ffn"], x, cfg, mesh=self.mesh,
                    model_axis_size=self.model_size), new_cache
            return moe.moe_apply(bp["ffn"], x, cfg), new_cache
        return tf.ffn_apply(bp["ffn"], x, cfg), new_cache

    def _run_stack(self, params: Dict, x: torch.Tensor,
                   positions: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every layer in order; returns the final hidden states (an
        encoder-decoder's decoder: :meth:`_run_encdec_decoder`). Under
        ``checkpoint`` backward keeps a layer's input and runs it again:
        every layer with ``"full"``; with ``"dots"`` too, but keeping the
        matmuls' outputs; with ``"group"`` each of ``outer`` blocks of a
        group's layers (``outer`` the largest divisor of the layer count
        at most its square root), and each layer inside it. The tail
        layers run plain, as in the reference."""
        if self.cfg.encoder_layers:
            return self._run_encdec_decoder(params, x, positions, enc_out)

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

    def _run_encdec_decoder(self, params: Dict, x: torch.Tensor,
                            positions: torch.Tensor,
                            enc_out: torch.Tensor) -> torch.Tensor:
        """The encoder-decoder's decoder
        (``repro/models/lm/backbone.py::_run_encdec_decoder``): each layer
        of pattern slot 0 (there is no tail) runs causal self-attention,
        cross-attention to ``enc_out`` (non-causal, K7 / K8 with the
        encoder's key length), then the FFN. ``"full"`` recomputes each
        layer in backward; ``"dots"`` and ``"group"`` both keep the
        matmuls' outputs (the reference maps both to ``checkpoint_dots``
        here: no nested group remat on this path)."""
        cfg, kernels = self.cfg, self.use_kernels

        def layer(h, lp, cp, enc):
            h, _ = tf.attn_apply(lp["attn"], h, cfg, positions=positions,
                                 causal=True, use_kernels=kernels)
            h, _ = tf.attn_apply(cp, h, cfg, positions=positions,
                                 causal=False, kv_from=enc,
                                 use_kernels=kernels)
            return tf.ffn_apply(lp["ffn"], h, cfg)

        key = f"0_{self.pattern[0]}"
        n = self.n_groups
        ctx = _dots_context if self.remat in ("dots", "group") \
            else noop_context_fn
        for lp, cp in zip(_layers(params["groups"][key], n),
                          _layers(params["cross"], n)):
            if self.remat == "none":
                x = layer(x, lp, cp, enc_out)
            else:
                x = checkpoint(layer, x, lp, cp, enc_out,
                               use_reentrant=False, context_fn=ctx)
        return x

    def _encode(self, params: Dict, frames) -> torch.Tensor:
        """The bidirectional encoder over stub frame embeddings
        (``repro/models/lm/backbone.py::_encode``): ``frames [B, S_f, D]``
        cast to the compute type and fed straight in (the frontend has no
        parameters), then each encoder layer's non-causal self-attention
        (RoPE at ``arange(S_f)``; K7 / K8) and FFN. Never recomputed."""
        x = self._frontend(frames)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        for lp in _layers(params["enc_groups"], self.cfg.encoder_layers):
            x, _ = tf.attn_apply(lp["attn"], x, self.cfg,
                                 positions=positions, causal=False,
                                 use_kernels=self.use_kernels)
            x = tf.ffn_apply(lp["ffn"], x, self.cfg)
        return x

    def _frontend(self, x) -> torch.Tensor:
        """A frontend's input (``frames`` or ``patches``) on the model's
        device in the compute type."""
        return torch.as_tensor(x, device=self.device).to(self.cd)

    def _forward(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor,
                                                           int]:
        """The final-normed hidden states of ``batch`` and the number of
        vision-prefix positions ahead of the text: ``batch["tokens"]``
        embedded, ``batch["patches"]`` ahead of them (vision), or
        ``batch["frames"]`` through the encoder (audio); positions over
        the whole sequence. The keys are read in the reference's order,
        so a missing one raises the reference's ``KeyError``."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        b = tokens.shape[0]
        x = self.embed(params, tokens)
        prefix, enc_out = 0, None
        if cfg.frontend == "vision":
            patches = self._frontend(batch["patches"])
            x = torch.cat([patches, x], dim=1)
            prefix = patches.shape[1]
        if cfg.frontend == "audio":
            enc_out = self._encode(params, batch["frames"])
        s = x.shape[1]
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        x = self._run_stack(params, x, positions, enc_out)
        return tf.norm_apply(params.get("final_norm", {}), x, cfg), prefix

    # ---------------------------------------------------------------- train

    def train_loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"] [B, S]`` (the
        last position has no label; a vision prefix is not scored); f32
        scalar. A vision config also takes ``batch["patches"] [B, S_img,
        D]``, an audio one ``batch["frames"] [B, S_f, D]``."""
        x, prefix = self._forward(params, batch)
        tokens = self._tokens(batch["tokens"])
        b = tokens.shape[0]
        labels = torch.cat([tokens[:, 1:],
                            torch.full((b, 1), -1, dtype=tokens.dtype,
                                       device=self.device)], dim=1)
        return self._xent(params, x[:, prefix:], labels)

    def _xent(self, params: Dict, h: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """Cross-entropy in ``loss_chunk`` sequence chunks, so ``[B, S, V]``
        logits never exist at once: each chunk's body runs under
        ``checkpoint`` and backward recomputes its logits. The heads are
        cast to the compute type once; labels of -1 are not counted. On a
        mesh the loss's sum and count are summed over the data axes (the
        global mean) and a striped head's chunks run vocab-parallel
        (:meth:`_xent_chunk_vp`)."""
        heads = [hp.to(self.cd) for hp in self._head_parts(params)]
        body = self._xent_chunk_vp if self.vocab_parallel \
            else self._xent_chunk
        chunk = min(self.loss_chunk, h.shape[1])
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.int64, device=h.device)
        for c0 in range(0, h.shape[1], chunk):
            lc = labels[:, c0:c0 + chunk]
            total = total + checkpoint(body, h[:, c0:c0 + chunk], lc,
                                       *heads, use_reentrant=False)
            count = count + (lc >= 0).sum()
        if self.mesh is not None:
            dp = meshlib.axis_group(self.mesh, self._dp_axes)
            total, count = all_reduce(total, dp), all_reduce(count, dp)
        return total / count.clamp_min(1)

    def _xent_chunk(self, hc: torch.Tensor, lc: torch.Tensor,
                    *heads: torch.Tensor) -> torch.Tensor:
        """The summed loss of one chunk: f32 logits, ``logsumexp -
        logit[label]`` over the valid labels, the logits at and past
        ``vocab_size`` (the vocabulary's padding to the mesh) masked out."""
        logits = torch.cat([(hc @ hp).float() for hp in heads], dim=-1)
        if logits.shape[-1] > self.cfg.vocab_size:
            logits = logits.masked_fill(torch.arange(
                logits.shape[-1], device=logits.device)
                >= self.cfg.vocab_size, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lc.clamp_min(0)[..., None].long())[..., 0]
        return torch.where(lc >= 0, lse - ll, 0.0).sum()

    def _xent_chunk_vp(self, hc: torch.Tensor, lc: torch.Tensor,
                       *heads: torch.Tensor) -> torch.Tensor:
        """:meth:`_xent_chunk` with the last head this rank's stripe of the
        vocabulary (a hybrid table's hot head, whole, ahead of it): the
        log-sum-exp's max, its sum of exponentials and the label's logit
        each taken over ``"model"``, the hot logits counted once."""
        group = self._model_group
        *hot, stripe = heads
        width = stripe.shape[1]
        local = (copy_to_group(hc, group) @ stripe).float()
        col0 = self.hot_rows + self._model_index * width  # its 1st logit
        if col0 + width > self.cfg.vocab_size:       # padding columns
            local = local.masked_fill(
                torch.arange(width, device=hc.device)
                >= self.cfg.vocab_size - col0, -1e30)
        hot = [(hc @ hp).float() for hp in hot]
        mx = local.amax(-1)
        if hot:
            mx = torch.maximum(mx, hot[0].amax(-1))
        mx = mx.detach()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        label = lc.clamp_min(0).long()
        rel = label - col0
        mine = (rel >= 0) & (rel < width)
        # the stripe's sum of exponentials and label logit, summed at once
        se, ll = all_reduce(torch.stack([
            torch.exp(local - mx[..., None]).sum(-1),
            torch.where(mine, local.gather(-1, torch.where(
                mine, rel, 0)[..., None])[..., 0], 0.0)]), group).unbind()
        if hot:
            se = se + torch.exp(hot[0] - mx[..., None]).sum(-1)
            is_hot = label < self.hot_rows
            ll = ll + torch.where(is_hot, hot[0].gather(
                -1, torch.where(is_hot, label, 0)[..., None])[..., 0], 0.0)
        lse = mx + torch.log(se)
        return torch.where(lc >= 0, lse - ll, 0.0).sum()

    # ---------------------------------------------------------------- serve

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def prefill(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Full-sequence forward of ``batch["tokens"] [B, S]`` (with
        ``patches`` or ``frames`` as :meth:`train_loss`); returns the last
        position's f32 logits ``[B, logits_size]``, the padding entries
        unmasked as in the reference."""
        x, _ = self._forward(params, batch)
        return self._logits(params, x[:, -1])

    def init_cache(self, b: int, max_seq: int) -> Dict:
        """Zero decode state per stacked group: an attention group's KV
        cache ``(k, v)``, each ``[layers, B, S, Hkv, Dh]`` in the compute
        type with S ``max_seq`` (``min(max_seq, window)`` for local
        attention, a rolling cache); a recurrent group's state in f32,
        each leaf ``[layers, B, ...]``: ``{"h", "conv"}`` for RG-LRU,
        ``{"C", "n", "m"}`` for mLSTM, ``{"c", "n", "h", "m"}`` for
        sLSTM. An encoder-decoder's also holds ``"cross"``, zeros ``[L, B,
        frontend_seq or 512, Hkv, Dh]`` (the reference's
        ``init_cache``)."""
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
        cache = {"groups": {key: blk_cache(kind, n)
                            for key, kind, n in self._group_keys()}}
        if cfg.encoder_layers:
            senc = cfg.frontend_seq or 512
            cache["cross"] = tuple(
                torch.zeros((cfg.num_layers, b, senc, hkv, hd),
                            dtype=self.cd, device=self.device)
                for _ in range(2))
        return cache

    def decode_step(self, params: Dict, tokens, cache: Dict, pos
                    ) -> Tuple[torch.Tensor, Dict]:
        """``tokens [B, 1]``, ``pos [B]`` -> (f32 logits ``[B,
        logits_size]``, the cache). Each layer's new K/V (at ``pos``, or
        ``pos % S`` in a rolling cache) and each recurrent layer's new
        state are written into ``cache`` in place; the returned cache is
        that one. An encoder-decoder runs the reference's decode: each
        layer's causal self-attention, then its cross layer called with
        ``cache["cross"]`` and no encoder output, so it takes the
        self-attention decode (RoPE, the token's K/V written at ``pos``,
        entries past ``pos`` masked) on a copy that is then dropped
        (``keep_cache``): ``cache["cross"]`` goes back as it came, and a
        ``pos`` past its length writes nothing."""
        tokens = self._tokens(tokens)
        pos = self._tokens(pos)
        x = self.embed(params, tokens)
        positions = pos[:, None]
        new_cache: Dict = {"groups": {}}
        for key, kind, n in self._group_keys():
            gp = params["groups"][key]
            gc = cache["groups"][key]
            if self.cfg.encoder_layers and not key.startswith("tail"):
                x = self._encdec_decode(params, gp, gc, cache["cross"], n,
                                        x, positions, pos)
                new_cache["groups"][key] = gc
                new_cache["cross"] = cache["cross"]
                continue
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

    def _encdec_decode(self, params, gp, gc, cross, n, x, positions, pos):
        """One decode step through the encoder-decoder's ``n`` decoder
        layers (:meth:`decode_step`); ``gc`` is written in place, ``cross``
        is not."""
        cfg, kernels = self.cfg, self.use_kernels
        for i, (lp, cp) in enumerate(zip(_layers(gp, n),
                                         _layers(params["cross"], n))):
            x, _ = tf.attn_apply(lp["attn"], x, cfg, positions=positions,
                                 causal=True, cache=(gc[0][i], gc[1][i]),
                                 cache_pos=pos, use_kernels=kernels)
            x, _ = tf.attn_apply(cp, x, cfg, positions=positions,
                                 causal=False,
                                 cache=(cross[0][i], cross[1][i]),
                                 cache_pos=pos, keep_cache=True,
                                 use_kernels=kernels)
            x = tf.ffn_apply(lp["ffn"], x, cfg)
        return x
