"""Kafka-analogue online-update path (paper §3 "Online model updating"),
counterpart of ``repro/core/hps/message_bus.py``.

``MessageBus`` holds one ordered queue per (model, table) topic, named
``hps.<model>.<table>``. ``Producer`` (training side) serializes, batches
and publishes update messages; ``Consumer`` (inference side) discovers
topics, subscribes with an offset, and hands polled updates to the HPS,
which applies them to its L2/L3 and marks its L1 rows dirty: the blue
data-flow of the paper's Figure 2.

Pure Python and numpy. The wire format is the reference's byte for byte,
so a message either package publishes is read by the other's consumer.
"""
from __future__ import annotations

import io
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


def _serialize(ids: np.ndarray, rows: np.ndarray,
               version: int = 0) -> bytes:
    """Wire format: ``<IIQ`` (rows, dim, version) + int64 ids + f32 rows.

    ``version`` is the producer-assigned update version (a monotonically
    increasing pass/window counter); consumers surface the last version
    seen per topic so the freshness loop can measure publish->visible lag
    end to end."""
    buf = io.BytesIO()
    n, d = rows.shape
    buf.write(struct.pack("<IIQ", n, d, version))
    buf.write(np.ascontiguousarray(ids, np.int64).tobytes())
    buf.write(np.ascontiguousarray(rows, np.float32).tobytes())
    return buf.getvalue()


_HEADER = struct.calcsize("<IIQ")


def _deserialize(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    ids, rows, _ = _deserialize_versioned(data)
    return ids, rows


def _deserialize_versioned(data: bytes
                           ) -> Tuple[np.ndarray, np.ndarray, int]:
    n, d, version = struct.unpack_from("<IIQ", data, 0)
    off = _HEADER
    ids = np.frombuffer(data, np.int64, n, off)
    rows = np.frombuffer(data, np.float32, n * d, off + 8 * n).reshape(n, d)
    return ids.copy(), rows.copy(), version


class MessageBus:

    # every listed attribute is touched only under self._lock
    _GUARDED_BY = {"_topics": "_lock"}

    def __init__(self):
        self._topics: Dict[str, List[bytes]] = {}
        self._lock = threading.Lock()

    def topic(self, model: str, table: str) -> str:
        return f"hps.{model}.{table}"

    def publish(self, topic: str, message: bytes) -> int:
        with self._lock:
            q = self._topics.setdefault(topic, [])
            q.append(message)
            return len(q) - 1

    def fetch(self, topic: str, offset: int, max_messages: int = 64
              ) -> Tuple[List[bytes], int]:
        with self._lock:
            q = self._topics.get(topic, [])
            out = q[offset:offset + max_messages]
            return out, offset + len(out)

    def topics(self) -> List[str]:
        with self._lock:
            return list(self._topics)


class Producer:
    """Message Producer API: batching + serialization (training side).
    A table's pending rows go out as one message once they reach
    ``max_batch_rows`` (at version 0), or at :meth:`flush`."""

    def __init__(self, bus: MessageBus, model: str, *,
                 max_batch_rows: int = 4096):
        self.bus = bus
        self.model = model
        self.max_batch_rows = max_batch_rows
        self._pending: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}

    def send(self, table: str, ids: np.ndarray, rows: np.ndarray) -> None:
        pend = self._pending.setdefault(table, [])
        pend.append((np.asarray(ids), np.asarray(rows)))
        if sum(len(i) for i, _ in pend) >= self.max_batch_rows:
            self.flush(table)

    def flush(self, table: Optional[str] = None, *,
              version: int = 0) -> None:
        tables = [table] if table else list(self._pending)
        for t in tables:
            pend = self._pending.pop(t, [])
            if not pend:
                continue
            ids = np.concatenate([i for i, _ in pend])
            rows = np.concatenate([r for _, r in pend])
            self.bus.publish(self.bus.topic(self.model, t),
                             _serialize(ids, rows, version))


class Consumer:
    """Message Source API: subscribe + apply (inference side).

    ``last_versions`` maps each table to the highest producer version
    applied so far (a version-0 message never lowers it): once
    ``last_versions[table] >= v``, every row of update ``v`` has been
    applied to this consumer's L2/L3 and its L1 rows marked dirty."""

    def __init__(self, bus: MessageBus, model: str):
        self.bus = bus
        self.model = model
        self._offsets: Dict[str, int] = {}
        self.last_versions: Dict[str, int] = {}

    def discover(self) -> List[str]:
        prefix = f"hps.{self.model}."
        return [t for t in self.bus.topics() if t.startswith(prefix)]

    def poll(self, apply_fn) -> int:
        """``apply_fn(table, ids, rows)``; returns #messages applied."""
        n = 0
        for topic in self.discover():
            table = topic.rsplit(".", 1)[1]
            off = self._offsets.get(topic, 0)
            msgs, off = self.bus.fetch(topic, off)
            self._offsets[topic] = off
            for m in msgs:
                ids, rows, version = _deserialize_versioned(m)
                apply_fn(table, ids, rows)
                if version > self.last_versions.get(table, -1):
                    self.last_versions[table] = version
                n += 1
        return n
