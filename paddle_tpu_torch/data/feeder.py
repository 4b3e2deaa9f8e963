"""DataFeeder: python samples -> device Arguments.

The port's counterpart of ``paddle_tpu/data/feeder.py`` for every slot
type: dense, sparse (binary or float, densified) and index values, flat,
as sequences or as nested sequences (a sample is a list of sub-sequences:
``[B, S, T(, D)]`` values with a ``[B, S, T]`` mask, ``T`` padded like a
sequence's length). Sequences pad to ``pad_multiple`` or to a
``length_buckets`` menu; ``batch_buckets`` pads a short batch up to a
bucketed row count with all-masked rows plus a ``ROW_MASK_KEY`` entry.
Batches are assembled in numpy on the host and land as torch tensors on
``device``. Masks are f32.
"""

from __future__ import annotations

import bisect
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.data import types as T
from paddle_tpu_torch.data.prefetch import LengthBuckets

# feed-dict entry carrying the [B] f32 row-validity mask emitted when
# batch_buckets pads the batch dim (not a data layer)
ROW_MASK_KEY = "__row_mask__"


def _ceil_to(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def _zero_sample(itype: T.InputType):
    """An all-padding sample for one slot: empty for sequences (rows pad
    to an all-zero mask), zeros otherwise."""
    if itype.seq_type != T.NO_SEQUENCE:
        return []
    if itype.type == T.INDEX:
        return 0
    if itype.type in (T.SPARSE_BINARY, T.SPARSE_FLOAT):
        return []
    return np.zeros(itype.dim, dtype=np.float32)


def _densify(value: np.ndarray, sparse_type: str, idxs) -> None:
    """Write one sparse entry into its dense row ``value`` [dim]: ids set
    to 1 (binary) or (id, value) pairs (float)."""
    if sparse_type == T.SPARSE_BINARY:
        value[np.asarray(idxs, dtype=np.int64)] = 1.0
    else:
        for j, v in idxs:
            value[j] = v


class DataFeeder:
    def __init__(self, feeding: Dict[str, T.InputType],
                 pad_multiple: int = 32,
                 length_buckets: Optional[Sequence[int]] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 validate_ids: Optional[bool] = None,
                 shared_length_bucket: bool = False,
                 device="cuda"):
        """feeding: data-layer name -> InputType, in the order of a
        sample's slots. ``validate_ids`` (default from the
        ``PADDLE_TPU_VALIDATE_IDS`` environment variable) checks every
        INDEX input against its declared range on the host and raises with
        the offending id. ``shared_length_bucket`` pads every sequence slot
        of a batch to one bucket (serving's closed shape menu)."""
        self.feeding = feeding
        self.names = list(feeding)
        self.pad_multiple = pad_multiple
        if validate_ids is None:
            validate_ids = os.environ.get(
                "PADDLE_TPU_VALIDATE_IDS", "").lower() in ("1", "true", "yes")
        self.validate_ids = bool(validate_ids)
        self.length_buckets = (None if length_buckets is None
                               else LengthBuckets(length_buckets))
        self.batch_buckets = (sorted(int(b) for b in batch_buckets)
                              if batch_buckets else None)
        self.shared_length_bucket = bool(shared_length_bucket)
        self.device = torch.device(device)

    def _pad_len(self, raw_max: int) -> int:
        if self.length_buckets is not None:
            return self.length_buckets.pad_len(raw_max)
        return _ceil_to(raw_max, self.pad_multiple)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr)

    def convert(self, batch: List[Tuple], host: bool = False
                ) -> Dict[str, Argument]:
        """One batch as Arguments on ``device``; with ``host`` as CPU
        tensors (the prefetch pipeline copies them itself)."""
        feed = self._convert_host(batch)
        if host:
            return feed

        return {k: a.to(self.device) for k, a in feed.items()}

    def _convert_host(self, batch: List[Tuple]) -> Dict[str, Argument]:
        n_real = len(batch)
        row_mask = None
        if self.batch_buckets:
            # a closed menu: a batch beyond the largest bucket is a
            # reader/config mismatch, not something to pad around
            i = bisect.bisect_left(self.batch_buckets, n_real)
            if i == len(self.batch_buckets):
                raise ValueError(
                    f"batch of {n_real} exceeds the largest batch bucket "
                    f"{self.batch_buckets[-1]}; include the reader's "
                    "batch size in batch_buckets")
            target = self.batch_buckets[i]
            pad_row = tuple(_zero_sample(self.feeding[n])
                            for n in self.names)
            batch = list(batch) + [pad_row] * (target - n_real)
            row_mask = np.zeros(target, dtype=np.float32)
            row_mask[:n_real] = 1.0
        cols = list(zip(*batch))
        if len(cols) != len(self.names):
            raise ValueError(
                f"batch has {len(cols)} columns, feeder expects "
                f"{len(self.names)} ({self.names})")
        pad_to = None
        if self.shared_length_bucket:
            raw = [len(s) for name, col in zip(self.names, cols)
                   if self.feeding[name].seq_type == T.SEQUENCE
                   for s in col]
            if raw:
                pad_to = self._pad_len(max(raw))
        feed = {name: self._convert_one(self.feeding[name], col, name,
                                        pad_to=pad_to)
                for name, col in zip(self.names, cols)}
        if row_mask is not None:
            feed[ROW_MASK_KEY] = Argument(value=self._tensor(row_mask))
        return feed

    __call__ = convert

    def _check_ids(self, name, itype: T.InputType, value: np.ndarray,
                   mask: Optional[np.ndarray] = None):
        """Host-side range check for INDEX inputs: -1 stays legal (the OOV
        ignore sentinel); padding positions (mask 0) are exempt."""
        if not self.validate_ids:
            return
        bad = (value >= itype.dim) | (value < -1)
        if mask is not None:
            bad &= mask > 0
        if bad.any():
            pos = tuple(int(i) for i in np.argwhere(bad)[0])
            raise ValueError(
                f"input {name!r}: id {int(value[pos])} at position {pos} "
                f"is outside the declared range [-1, {itype.dim}); the "
                "table lookup would read a zero row for it")

    def _convert_one(self, itype: T.InputType, col: Sequence,
                     name: str = "?",
                     pad_to: Optional[int] = None) -> Argument:
        if itype.seq_type == T.NO_SEQUENCE:
            if itype.type == T.INDEX:
                arr = np.asarray(col, dtype=np.int32)
                self._check_ids(name, itype, arr)
                return Argument(value=self._tensor(arr))
            if itype.type == T.DENSE:
                return Argument(value=self._tensor(
                    np.asarray(col, dtype=np.float32)))
            if itype.type not in (T.SPARSE_BINARY, T.SPARSE_FLOAT):
                raise KeyError(itype.type)
            dense = np.zeros((len(col), itype.dim), dtype=np.float32)
            for i, idxs in enumerate(col):
                _densify(dense[i], itype.type, idxs)
            return Argument(value=self._tensor(dense))
        if itype.seq_type == T.SUB_SEQUENCE:
            return self._convert_nested(itype, col, name)
        max_len = pad_to or self._pad_len(max(len(s) for s in col))
        bsz = len(col)
        mask = np.zeros((bsz, max_len), dtype=np.float32)
        if itype.type == T.INDEX:
            value = np.zeros((bsz, max_len), dtype=np.int32)
            for i, s in enumerate(col):
                value[i, : len(s)] = np.asarray(s, dtype=np.int32)
                mask[i, : len(s)] = 1.0
            self._check_ids(name, itype, value, mask)
        elif itype.type in (T.SPARSE_BINARY, T.SPARSE_FLOAT):
            # per-timestep id lists densify to [B, T, dim]
            value = np.zeros((bsz, max_len, itype.dim), dtype=np.float32)
            for i, s in enumerate(col):
                for t, idxs in enumerate(s):
                    _densify(value[i, t], itype.type, idxs)
                    mask[i, t] = 1.0
        else:
            value = np.zeros((bsz, max_len, itype.dim), dtype=np.float32)
            for i, s in enumerate(col):
                arr = np.asarray(s, dtype=np.float32).reshape(len(s),
                                                              itype.dim)
                value[i, : len(s)] = arr
                mask[i, : len(s)] = 1.0
        return Argument(value=self._tensor(value), mask=self._tensor(mask))

    def _convert_nested(self, itype: T.InputType, col: Sequence,
                        name: str) -> Argument:
        """A nested slot: each sample a list of sub-sequences, as
        ``[B, S, T(, D)]`` with a ``[B, S, T]`` mask; S is the batch's
        largest sub-sequence count, T its padded longest sub-sequence."""
        B = len(col)
        S = max(len(s) for s in col)
        Tm = self._pad_len(max((len(ss) for s in col for ss in s),
                               default=1))
        mask = np.zeros((B, S, Tm), dtype=np.float32)
        if itype.type == T.INDEX:
            value = np.zeros((B, S, Tm), dtype=np.int32)
            for i, s in enumerate(col):
                for j, ss in enumerate(s):
                    value[i, j, : len(ss)] = np.asarray(ss, dtype=np.int32)
                    mask[i, j, : len(ss)] = 1.0
            self._check_ids(name, itype, value, mask)
        elif itype.type == T.DENSE:
            value = np.zeros((B, S, Tm, itype.dim), dtype=np.float32)
            for i, s in enumerate(col):
                for j, ss in enumerate(s):
                    value[i, j, : len(ss)] = np.asarray(
                        ss, dtype=np.float32).reshape(len(ss), itype.dim)
                    mask[i, j, : len(ss)] = 1.0
        else:
            value = np.zeros((B, S, Tm, itype.dim), dtype=np.float32)
            for i, s in enumerate(col):
                for j, ss in enumerate(s):
                    for t, idxs in enumerate(ss):
                        _densify(value[i, j, t], itype.type, idxs)
                        mask[i, j, t] = 1.0
        return Argument(value=self._tensor(value), mask=self._tensor(mask))
