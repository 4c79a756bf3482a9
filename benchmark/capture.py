"""Which of the window's batches the check compares, and what it keeps of them."""
from __future__ import annotations

import threading

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``k`` of the window's batches, drawn from the
    seed as the batches come (reservoir sampling).

    ``offer(record)`` at a batch's sampling returns the dict to fill with
    that batch's outputs, or None.  A later stage finds its batch's dict by
    the object that flows into it: ``tag(obj, keep)`` files an output under
    the dict, ``find(obj)`` looks it up by identity (so outputs reach their
    own batch whatever the order or thread the stages run in).  ``enter`` /
    ``active`` / ``leave`` hold the dict of the batch a stage is running on
    the calling thread, for the calls nested inside that stage."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.seen = 0
        self.slots = []
        self._tags = []          # (object, dict) of the kept batches
        self._local = threading.local()

    def offer(self, record):
        n, self.seen = self.seen, self.seen + 1
        j = n if n < self.k else int(self.rng.integers(0, n + 1))
        if j >= self.k:
            return None
        keep = {"record": record}
        if j < len(self.slots):
            gone = self.slots[j]
            self._tags = [(o, d) for o, d in self._tags if d is not gone]
            self.slots[j] = keep
        else:
            self.slots.append(keep)
        self.tag(record, keep)
        return keep

    def tag(self, obj, keep):
        if keep is not None:
            self._tags.append((obj, keep))

    def find(self, obj):
        for o, d in self._tags:
            if o is obj:
                return d
        return None

    def enter(self, keep):
        self._local.keep = keep

    def active(self):
        return getattr(self._local, "keep", None)

    def leave(self):
        self._local.keep = None


def shipped_rows(rows: torch.Tensor, shipped: torch.Tensor):
    """(mask, unmatched): the (S,) bool mask of the rows of ``rows`` (S, L)
    that, in order, make up ``shipped`` (s, L) (the program ships a
    subsequence of its shots, in their order; equal rows decode alike, so
    the earliest match stands for the shot), and how many shipped rows
    matched no row in that order."""
    packed = np.packbits(rows.to(torch.uint8).cpu().numpy(), axis=1)
    want = np.packbits(shipped.to(torch.uint8).cpu().numpy(), axis=1)
    mask = torch.zeros(rows.shape[0], dtype=torch.bool)
    j = 0
    for i in range(packed.shape[0]):
        if j < want.shape[0] and np.array_equal(packed[i], want[j]):
            mask[i] = True
            j += 1
    return mask, int(want.shape[0] - j)
