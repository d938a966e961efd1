"""Online training: ETC-staged passes + the live train->serve freshness
loop (paper §1 "Online training" / §3 "Online model updating");
counterpart of ``repro/online``.

The pieces:

* :class:`~repro_torch.online.trainer.OnlineTrainer` — the Embedding Training
  Cache as a first-class training backend: keyset-staged passes, the
  parameter server as the durable tier, dense+sparse optimizers running
  on the cache tensors.
* :class:`~repro_torch.online.publisher.UpdatePublisher` — turns each pass's
  flushed dirty rows into versioned updates on the existing MessageBus
  topics, consumed by a LIVE ``InferenceServer``.
* :mod:`~repro_torch.online.freshness` — probes measuring the publish ->
  visible-in-prediction lag against the live server.
"""
from repro_torch.online.publisher import UpdatePublisher
from repro_torch.online.trainer import OnlineTrainer
from repro_torch.online.freshness import probe_prediction, wait_visible

__all__ = ["UpdatePublisher", "OnlineTrainer", "probe_prediction",
           "wait_visible"]
