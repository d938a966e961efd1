from repro_torch.core.embedding.collection import EmbeddingCollection
from repro_torch.core.embedding.frequency import FrequencyStats, apply_remap
from repro_torch.core.embedding.planner import plan, resolve_strategies

__all__ = [
    "EmbeddingCollection", "FrequencyStats", "apply_remap",
    "plan", "resolve_strategies",
]
