"""Input type declarations, mirroring ``python/paddle/trainer/
PyDataProvider2.py``: the port's copy of ``paddle_tpu/data/types.py`` for
the slot kinds it serves (dense and index values, flat or as sequences).
The class and constant names match, so a pickled ``InputType`` maps
across."""

from __future__ import annotations

import dataclasses

NO_SEQUENCE = 0
SEQUENCE = 1
SUB_SEQUENCE = 2

DENSE = "dense"
SPARSE_BINARY = "sparse_binary"
SPARSE_FLOAT = "sparse_float"
INDEX = "index"


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    seq_type: int = NO_SEQUENCE
    type: str = DENSE


def dense_vector(dim):
    return InputType(dim, NO_SEQUENCE, DENSE)


def dense_vector_sequence(dim):
    return InputType(dim, SEQUENCE, DENSE)


def integer_value(value_range):
    return InputType(value_range, NO_SEQUENCE, INDEX)


def integer_value_sequence(value_range):
    return InputType(value_range, SEQUENCE, INDEX)
