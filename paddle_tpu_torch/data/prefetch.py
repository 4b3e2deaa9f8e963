"""Shape policy for ragged batches: the port's copy of
``paddle_tpu/data/prefetch.py:LengthBuckets``. The background prefetch
pipeline arrives with training."""

from __future__ import annotations

import bisect
from typing import Sequence


class LengthBuckets:
    """Pad-to-bucket policy for ragged sequence lengths.

    ``edges`` is a small ascending set of padded lengths (e.g.
    ``[32, 64, 128]``). A raw max-length pads to the smallest edge that
    holds it; lengths beyond the last edge pad to the next multiple of it.
    """

    def __init__(self, edges: Sequence[int]):
        edges = sorted(int(e) for e in edges)
        if not edges or edges[0] < 1:
            raise ValueError(f"bucket edges must be positive ints: {edges}")
        if len(set(edges)) != len(edges):
            raise ValueError(f"duplicate bucket edges: {edges}")
        self.edges = edges

    def pad_len(self, n: int) -> int:
        """Smallest bucket holding a raw length ``n``."""
        n = max(int(n), 1)
        i = bisect.bisect_left(self.edges, n)
        if i < len(self.edges):
            return self.edges[i]
        last = self.edges[-1]
        return ((n + last - 1) // last) * last

    def __repr__(self):
        return f"LengthBuckets({self.edges})"
