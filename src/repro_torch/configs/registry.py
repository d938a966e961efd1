"""Registry entries copied from ``repro.configs.registry``: the recsys
configs the port serves and trains (the paper's four recipes on Criteo,
``RECSYS_ARCHS``, and their smoke reduction; every recipe's module,
``RECSYS_RECIPES``), and the ten LM
architectures with ``get_lm_config`` and
``reduce_for_smoke``, so the tests build the same reduced configs on both
sides."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (
    EmbeddingTableConfig, LMConfig, MoEConfig, RecsysConfig)

# ---------------------------------------------------------------------------
# LM architectures
# ---------------------------------------------------------------------------

LM_ARCHS: Dict[str, LMConfig] = {}


def _reg(cfg: LMConfig) -> LMConfig:
    LM_ARCHS[cfg.name] = cfg
    return cfg


granite_moe_1b = _reg(LMConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, norm="rmsnorm", activation="swiglu",
    moe=MoEConfig(num_experts=32, top_k=8, expert_d_ff=512),
    tie_embeddings=True, block_pattern=("attn",),
    full_attention_only=True))

granite_moe_3b = _reg(LMConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, norm="rmsnorm", activation="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
    tie_embeddings=True, block_pattern=("attn",),
    full_attention_only=True))

phi3_mini = _reg(LMConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, norm="rmsnorm", activation="swiglu",
    block_pattern=("attn",), full_attention_only=True))

minitron_4b = _reg(LMConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    head_dim=128, d_ff=9216, vocab_size=256000, norm="layernorm",
    activation="relu_sq", block_pattern=("attn",),
    full_attention_only=True))

command_r_plus = _reg(LMConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, norm="layernorm", activation="swiglu",
    tie_embeddings=True, block_pattern=("attn",),
    full_attention_only=True))

olmo_1b = _reg(LMConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304, norm="nonparam_ln", activation="swiglu",
    tie_embeddings=True, block_pattern=("attn",),
    full_attention_only=True))

seamless_m4t = _reg(LMConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206, norm="layernorm", activation="relu",
    tie_embeddings=True, block_pattern=("attn",),
    encoder_layers=24, frontend="audio", frontend_seq=512,
    full_attention_only=True))

pixtral_12b = _reg(LMConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072, norm="rmsnorm",
    activation="swiglu", block_pattern=("attn",),
    frontend="vision", frontend_seq=1024, full_attention_only=True))

xlstm_125m = _reg(LMConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, norm="layernorm", activation="gelu",
    tie_embeddings=True, block_pattern=("mlstm", "slstm"),
    full_attention_only=False))

recurrentgemma_9b = _reg(LMConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000, norm="rmsnorm",
    activation="geglu", tie_embeddings=True,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_attn_window=2048, full_attention_only=False))


def get_lm_config(name: str) -> LMConfig:
    return LM_ARCHS[name]


def reduce_for_smoke(cfg: LMConfig) -> LMConfig:
    """Shrink an arch to CPU-testable size, keeping its structure."""
    per = len(cfg.block_pattern)
    layers = per + (2 if cfg.name == "recurrentgemma-9b" else per)
    kv = min(cfg.num_kv_heads, 2)
    heads = 4 if 4 % kv == 0 else kv
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                        capacity_factor=cfg.moe.capacity_factor)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers, d_model=64, num_heads=heads,
        num_kv_heads=kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab_size=512, moe=moe,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_seq=16 if cfg.frontend else 0,
        local_attn_window=8)


# ---------------------------------------------------------------------------
# Recsys configs
# ---------------------------------------------------------------------------

#: Criteo-Kaggle-like vocab profile (26 tables, heavy-tailed sizes)
CRITEO_VOCAB_SIZES = (
    1460, 584, 10131227, 2202608, 306, 24, 12518, 634, 4, 93146,
    5684, 8351593, 3195, 28, 14993, 5461306, 11, 5653, 2173, 4,
    7046547, 18, 16, 286181, 105, 142572)


def _criteo_tables(dim: int):
    return tuple(
        EmbeddingTableConfig(f"C{i+1}", max(4, v), dim,
                             hotness=1, strategy="auto")
        for i, v in enumerate(CRITEO_VOCAB_SIZES))


dlrm_criteo = RecsysConfig(
    name="dlrm-criteo", model="dlrm",
    tables=_criteo_tables(128),
    num_dense_features=13,
    bottom_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
    embedding_dim=128)

dcn_criteo = RecsysConfig(
    name="dcn-criteo", model="dcn",
    tables=_criteo_tables(16),
    num_dense_features=13,
    bottom_mlp=(), top_mlp=(1024, 1024), embedding_dim=16,
    num_cross_layers=6)

deepfm_criteo = RecsysConfig(
    name="deepfm-criteo", model="deepfm",
    tables=_criteo_tables(16),
    num_dense_features=13,
    bottom_mlp=(), top_mlp=(400, 400, 400), embedding_dim=16)

wdl_criteo = RecsysConfig(
    name="wdl-criteo", model="wdl",
    tables=_criteo_tables(16),
    num_dense_features=13,
    bottom_mlp=(), top_mlp=(1024, 1024), embedding_dim=16)

RECSYS_ARCHS: Dict[str, RecsysConfig] = {
    c.name: c for c in (dlrm_criteo, dcn_criteo, deepfm_criteo, wdl_criteo)
}

#: every graph-API recipe module, selectable via ``--arch`` in the
#: launchers: the four canonical paper recipes (which lower onto the
#: registry configs above) PLUS novel architectures that lower to
#: ``model="graph"``; each module's ``build_model(smoke=...)`` declares
#: its graph
RECSYS_RECIPES: Dict[str, str] = {
    arch: "repro_torch.configs." + arch.replace("-", "_")
    for arch in ("dlrm-criteo", "dcn-criteo", "deepfm-criteo",
                 "wdl-criteo", "twotower-criteo", "crossdeep-criteo",
                 "neumf-criteo")
}


def reduce_recsys_for_smoke(cfg: RecsysConfig) -> RecsysConfig:
    d = 16
    tables = tuple(
        dataclasses.replace(t, vocab_size=min(t.vocab_size, 1000), dim=d)
        for t in cfg.tables[:6])
    bottom = (32, d) if cfg.model == "dlrm" else ()
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", tables=tables, embedding_dim=d,
        bottom_mlp=bottom, top_mlp=(32, 16, 1) if cfg.model == "dlrm"
        else (32, 16))
