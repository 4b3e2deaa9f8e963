"""Input type declarations, mirroring ``python/paddle/trainer/
PyDataProvider2.py``: the port's copy of ``paddle_tpu/data/types.py``
(dense, sparse and index values, flat, as sequences or as nested
sequences). The class and constant names match, so a pickled
``InputType`` maps across."""

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


def sparse_binary_vector(dim):
    return InputType(dim, NO_SEQUENCE, SPARSE_BINARY)


def sparse_binary_vector_sequence(dim):
    return InputType(dim, SEQUENCE, SPARSE_BINARY)


def sparse_float_vector(dim):
    return InputType(dim, NO_SEQUENCE, SPARSE_FLOAT)


def sparse_float_vector_sequence(dim):
    return InputType(dim, SEQUENCE, SPARSE_FLOAT)


# -- 2-level (nested) sequences: one sample = a list of sub-sequences --
def integer_value_sub_sequence(value_range):
    return InputType(value_range, SUB_SEQUENCE, INDEX)


def dense_vector_sub_sequence(dim):
    return InputType(dim, SUB_SEQUENCE, DENSE)


def sparse_binary_vector_sub_sequence(dim):
    return InputType(dim, SUB_SEQUENCE, SPARSE_BINARY)


def sparse_float_vector_sub_sequence(dim):
    return InputType(dim, SUB_SEQUENCE, SPARSE_FLOAT)
