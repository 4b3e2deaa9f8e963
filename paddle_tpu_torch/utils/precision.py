"""JAX's dtype promotion where torch refuses mixed operands.

Under ``--compute_dtype bfloat16`` a layer after the first recurrent one
multiplies f32 activations by bf16 weights: JAX promotes the product to
f32 (``jnp.result_type``), while ``torch.matmul`` raises on mixed dtypes.
``torch.promote_types`` agrees with ``jnp.result_type`` on the floating
dtypes the port meets (bf16 with f32 gives f32), and widening a bf16
operand to f32 is exact, so the promoted product is JAX's.

The recurrent cells meet the same mix inside a recurrent group (seq2seq's
decoder: an f32 state and input, bf16 weights): their promoted math is
exactly the f32 function of the widened operands, so on the card they
take the f32 kernel on ``widen``'s results.
"""

from __future__ import annotations

import functools

import torch


def result_type(*tensors) -> torch.dtype:
    """The promoted dtype of floating tensors (``jnp.result_type``)."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the promoted dtype of the two."""
    if a.dtype == b.dtype:
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def widen(ts):
    """``ts`` with every bf16 tensor cast to f32, exactly; other dtypes
    pass through for the callee's checks. Returns (the tensors, the
    number of casts made: a cast is one device launch on the card)."""
    bf16 = torch.bfloat16
    out = tuple(t.float() if t.dtype == bf16 else t for t in ts)
    return out, sum(t.dtype == bf16 for t in ts)
