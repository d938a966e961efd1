"""The recsys registry entries the port serves, copied from
``repro.configs.registry`` (DLRM on Criteo and its smoke reduction)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import EmbeddingTableConfig, RecsysConfig

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
