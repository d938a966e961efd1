"""Versioned online-update publisher — the training half of the
train->serve freshness loop (counterpart of ``repro/online/publisher.py``,
copied: the same updates give the same bus messages byte for byte).

Each :meth:`UpdatePublisher.publish` call is one atomic freshness unit:
every table's rows go out on the existing ``hps.<model>.<table>`` topics
stamped with the same monotonically increasing version. The serving side
certifies application through ``Consumer.last_versions[table] >= v``
(bus drained into L2/L3, touched L1 rows queued for refresh), and
:func:`repro_torch.online.freshness.wait_visible` closes the loop by probing
live predictions.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hps.message_bus import MessageBus, _serialize


class UpdatePublisher:
    """Publishes ``{table: (ids, rows)}`` update sets with one version
    per set.

    Thread safety: ``publish()`` runs on the training thread while
    freshness probes on other threads read :meth:`last_version` /
    :meth:`publish_time`. The version counter and the publish log are
    guarded by ``_lock``; ALL bus IO happens outside it — a reader must
    never wait behind a bus publish (LOCK002).
    """

    # Checked by `python -m repro_torch.analysis`.
    _GUARDED_BY = {"_version": "_lock", "_log": "_lock"}

    def __init__(self, bus: MessageBus, model: str, *,
                 max_batch_rows: int = 4096):
        self.bus = bus
        self.model = model
        self.max_batch_rows = max_batch_rows
        self._lock = threading.Lock()
        self._version = 0
        self._log: List[Dict] = []

    def publish(self, updates: Dict[str, Tuple[np.ndarray, np.ndarray]]
                ) -> int:
        """Publish one versioned update set; returns its version."""
        with self._lock:
            self._version += 1
            version = self._version
        total = 0
        tables: List[str] = []
        for table in sorted(updates):
            ids, rows = updates[table]
            ids = np.asarray(ids, np.int64)
            rows = np.asarray(rows, np.float32)
            if ids.size == 0:
                continue
            topic = self.bus.topic(self.model, table)
            for lo in range(0, ids.size, self.max_batch_rows):
                hi = min(ids.size, lo + self.max_batch_rows)
                self.bus.publish(
                    topic, _serialize(ids[lo:hi], rows[lo:hi], version))
            total += int(ids.size)
            tables.append(table)
        rec = {"version": version, "tables": tables, "rows": total,
               "published_at": time.monotonic()}
        with self._lock:
            self._log.append(rec)
        return version

    def publish_cache(self, etc, params) -> int:
        """Publish every row resident in an EmbeddingTrainingCache — the
        pass-boundary feed (resident == touched this pass + survivors)."""
        updates = {t.name: etc.dirty_rows(params, ti)
                   for ti, t in enumerate(etc.tables)}
        return self.publish(updates)

    # -- read side (freshness probes) ----------------------------------------

    def last_version(self) -> int:
        with self._lock:
            return self._version

    def publish_time(self, version: int) -> Optional[float]:
        """``time.monotonic()`` at which ``version`` finished publishing
        (None if that version never completed)."""
        with self._lock:
            for rec in reversed(self._log):
                if rec["version"] == version:
                    return rec["published_at"]
        return None

    def history(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._log]
