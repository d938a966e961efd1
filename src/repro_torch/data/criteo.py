"""Criteo Terabyte / Kaggle format reader (the paper's benchmark dataset),
copied from ``repro/data/criteo.py`` (numpy only): the same file, batch
size and step give the same batch in both packages.

Format: TSV lines ``label \t I1..I13 \t C1..C26`` where I* are ints (may be
empty) and C* are 8-hex-digit category hashes (may be empty). Ids are
hashed into each table's vocab with a stable fingerprint, as HugeCTR's
data preprocessing does.

``CriteoReader`` is the SEEKABLE entry point: ``batch(step)`` is a pure
function of ``(file contents, batch_size, step)`` — batch ``s`` holds
lines ``[s*B, (s+1)*B)`` of the endlessly-looped file — so a
fault-tolerant trainer can replay any step after a restore exactly, the
same stateless contract ``SyntheticCTR.batch`` provides. The line-offset
index is built in one scan at construction; each batch is then a couple
of seeks, never a replay of the file prefix. The streaming ``reader()``
generator remains for purely-sequential consumers (O(1) memory, no
index).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch.configs.base import RecsysConfig

NUM_INT = 13
NUM_CAT = 26


def _fingerprint(token: str, vocab: int) -> int:
    h = hashlib.md5(token.encode()).digest()
    return int.from_bytes(h[:8], "little") % vocab


def parse_lines(lines: Sequence[str], cfg: RecsysConfig
                ) -> Dict[str, np.ndarray]:
    b = len(lines)
    dense = np.zeros((b, NUM_INT), np.float32)
    cat = np.full((b, NUM_CAT, 1), -1, np.int32)
    label = np.zeros((b,), np.float32)
    for r, line in enumerate(lines):
        # \r too: binary-mode readers hand CRLF lines through untranslated,
        # and a trailing \r on C26 would silently remap its embedding id
        parts = line.rstrip("\r\n").split("\t")
        label[r] = float(parts[0])
        for i in range(NUM_INT):
            v = parts[1 + i]
            dense[r, i] = np.log1p(max(0.0, float(v))) if v else 0.0
        for c in range(NUM_CAT):
            v = parts[1 + NUM_INT + c]
            if v:
                cat[r, c, 0] = _fingerprint(
                    v, cfg.tables[c].vocab_size)
    return {"dense": dense, "cat": cat, "label": label}


class CriteoReader:
    """Seekable, stateless ``batch(step)`` view over a Criteo TSV file.

    Batch ``s`` covers absolute line indices ``[s*B, s*B + B)`` of the
    infinitely-looped file (index ``a`` maps to line ``a % num_lines``)
    — byte-identical to chunking the old looping generator's stream,
    but addressable by step in O(B) instead of replaying the prefix:
    deterministic failure-replay for criteo runs.
    """

    def __init__(self, path: str, cfg: RecsysConfig, batch_size: int):
        self.path = path
        self.cfg = cfg
        self.batch_size = batch_size
        self._offsets = self._index_lines(path)
        if len(self._offsets) == 0:
            raise ValueError(f"{path}: empty criteo file")

    @staticmethod
    def _index_lines(path: str) -> np.ndarray:
        """Byte offset of every line start, in one chunked scan with a
        vectorized newline search — 8 bytes/line resident and no
        Python-int list, so a Criteo-Terabyte-scale TSV indexes without
        a transient memory blow-up. A final line without a trailing
        newline counts, like ``for line in f`` does."""
        starts = [np.zeros(1, np.int64)]
        pos = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                nl = np.flatnonzero(
                    np.frombuffer(chunk, np.uint8) == 0x0A)
                if len(nl):
                    starts.append(nl.astype(np.int64) + (pos + 1))
                pos += len(chunk)
        offs = np.concatenate(starts)
        # drop the bogus start at EOF (trailing newline) and, for an
        # empty file, the seed 0 itself
        return offs[offs < pos]

    @property
    def num_lines(self) -> int:
        return len(self._offsets)

    def read_lines(self, start: int, count: int) -> List[str]:
        """``count`` decoded lines from line index ``start``, wrapping
        past EOF back to line 0 (and again, if count > num_lines)."""
        lines: List[str] = []
        with open(self.path, "rb") as f:
            s = start % self.num_lines
            while count > 0:
                take = min(count, self.num_lines - s)
                f.seek(self._offsets[s])
                lines.extend(f.readline().decode("utf-8")
                             for _ in range(take))
                count -= take
                s = 0
        return lines

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        start = (step * self.batch_size) % self.num_lines
        return parse_lines(self.read_lines(start, self.batch_size),
                           self.cfg)


def reader(path: str, cfg: RecsysConfig, batch_size: int,
           *, loop: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Purely-sequential streaming reader: O(1) memory, first batch
    after ``batch_size`` lines — no offset index (a sequential consumer
    gains nothing from one; use :class:`CriteoReader` when you need
    seekable, replayable ``batch(step)`` access). ``loop=True`` streams
    forever, epoch boundaries crossing seamlessly; ``loop=False``
    yields one epoch, final partial batch included. Batch ``s`` of the
    looped stream is byte-identical to ``CriteoReader.batch(s)``."""
    buf: List[str] = []
    while True:
        with open(path) as f:
            for line in f:
                buf.append(line)
                if len(buf) == batch_size:
                    yield parse_lines(buf, cfg)
                    buf = []
        if not loop:
            if buf:
                yield parse_lines(buf, cfg)
            return


def write_synthetic_file(path: str, n: int, cfg: RecsysConfig,
                         seed: int = 0) -> None:
    """Emit a tiny Criteo-format file for tests."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            label = rng.integers(0, 2)
            ints = [str(rng.integers(0, 1000)) if rng.random() > 0.1 else ""
                    for _ in range(NUM_INT)]
            cats = [f"{rng.integers(0, 2**32):08x}"
                    if rng.random() > 0.1 else "" for _ in range(NUM_CAT)]
            f.write("\t".join([str(label)] + ints + cats) + "\n")
