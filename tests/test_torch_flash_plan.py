"""The flash kernels' arithmetic and shared-memory plan, on the CPU.

The kernels of ``csrc/flash_attn.cu`` run every product on the tensor
cores in split TF32: each float32 operand is split into big = TF32(x) and
small = TF32(x - big), and a product sums small·big' + big·small' +
big·big'. ``split_tf32_einsum`` is that arithmetic in plain PyTorch; here
it takes the place of every product of ``blockwise_plain`` (two) and
``flash_bwd_plain`` (five), and the results must hold the tolerances the
card holds the kernels to (o and the row statistics rtol 1e-4 / atol 1e-5;
each gradient within 1e-4 of its largest entry + 1e-5) against the
float32 plain versions and against JAX's ``flash_attention`` (its Pallas
kernel interpreted, at its default blocks) and ``jax.grad`` through it.
One TF32 pass alone misses them: the split is what keeps f32 accuracy.
Inputs from a numpy seed; shapes: the seq2seq path's heads [4, 4, 50, 50,
128] with ragged kv lengths and an all-padding row, a causal cross
attention [2, 2, 70, 133, 16], and rows of 1024 keys.

``flash_plan`` is the kernels' shared-memory formula: every instance fits
the 232,448 bytes a block may take, and at D = 128 two blocks of each
kernel fit an SM, as the source note says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import common
from paddle_tpu.ops.attention import flash_attention
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import build

TOL = dict(rtol=1e-4, atol=1e-5)

# (B, N, Tq, Tk, D, causal, last kv row all padding)
CASES = [(4, 4, 50, 50, 128, False, True),
         (2, 2, 70, 133, 16, True, False),
         (1, 2, 16, 1024, 64, False, False)]


def _inputs(B, N, Tq, Tk, D, seed, all_padding):
    """q, k, v, a ragged kv mask (row 0 full) and the cotangent dO."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lens = rng.integers(1, Tk + 1, size=B)
    lens[0] = Tk
    if all_padding:
        lens[-1] = 0
    mask = (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)
    return f(B, N, Tq, D), f(B, N, Tk, D), f(B, N, Tk, D), mask, \
        f(B, N, Tq, D)


def _one_pass_einsum(eq, a, b):
    """One TF32 pass: both operands rounded, the small terms dropped."""
    return torch.einsum(eq, tattn._round_tf32(a), tattn._round_tf32(b))


def _plain(ins, causal, einsum):
    """o, the row statistics and (dq, dk, dv) of the plain versions with
    ``einsum`` for every product."""
    q, k, v, mask, do = (torch.from_numpy(a) for a in ins)
    o, lse = tattn.blockwise_plain(q, k, v, mask, causal, einsum=einsum)
    grads = tattn.flash_bwd_plain(q, k, v, mask, o, lse, do, causal,
                                  einsum=einsum)
    return o.numpy(), lse.numpy(), [g.numpy() for g in grads]


def _jax(ins, causal):
    q, k, v, mask, do = ins

    def loss(q_, k_, v_):
        return jnp.sum(flash_attention(q_, k_, v_, jnp.asarray(mask),
                                       causal=causal) * do)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    with common.force_mode("interpret"):
        out = flash_attention(*args, jnp.asarray(mask), causal=causal)
        grads = jax.grad(loss, (0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _grad_errs(got, want):
    """Each gradient's largest error and its limit, 1e-4 of the largest
    entry + 1e-5."""
    return [(float(np.abs(g - w).max()), 1e-4 * float(np.abs(w).max())
             + 1e-5) for g, w in zip(got, want)]


@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", CASES)
def test_split_tf32_holds_the_card_tolerances(B, N, Tq, Tk, D, causal,
                                              all_padding):
    """The kernels' arithmetic (``split_tf32_einsum`` in every product)
    against the float32 plain versions and against JAX."""
    ins = _inputs(B, N, Tq, Tk, D, B * Tq + Tk + D, all_padding)
    o, lse, grads = _plain(ins, causal, tattn.split_tf32_einsum)
    w_o, w_lse, w_grads = _plain(ins, causal, torch.einsum)
    np.testing.assert_allclose(o, w_o, **TOL)
    np.testing.assert_allclose(lse, w_lse, **TOL)
    for name, (err, limit) in zip(("dq", "dk", "dv"),
                                  _grad_errs(grads, w_grads)):
        assert err <= limit, (name, err, limit)
    j_o, j_grads = _jax(ins, causal)
    np.testing.assert_allclose(o, j_o, **TOL)
    for name, (err, limit) in zip(("dq", "dk", "dv"),
                                  _grad_errs(grads, j_grads)):
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", CASES)
def test_one_tf32_pass_misses_the_card_tolerances(B, N, Tq, Tk, D, causal,
                                                  all_padding):
    """Without the small terms (one TF32 pass, 10 mantissa bits) o and
    every gradient miss the tolerances that split TF32 holds."""
    ins = _inputs(B, N, Tq, Tk, D, B * Tq + Tk + D, all_padding)
    o, _, grads = _plain(ins, causal, _one_pass_einsum)
    w_o, _, w_grads = _plain(ins, causal, torch.einsum)
    assert not np.allclose(o, w_o, **TOL)
    assert all(err > limit for err, limit in _grad_errs(grads, w_grads))


def test_round_tf32_is_round_to_nearest_ties_away():
    """``_round_tf32`` is ``cvt.rna.tf32.f32``: 10 mantissa bits, ties
    away from zero, the low 13 bits zero; big + small is x within 2^-22
    of |x|."""
    eps = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1 + eps / 2, -(1 + eps / 2), 1 + eps / 2 - 2 ** -23,
                      1 + 1.5 * eps, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + eps, -(1 + eps), 1.0, 1 + 2 * eps, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tattn._round_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32) * 10.0)
    big = tattn._round_tf32(r)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert ((big - r).abs() <= 2.0 ** -11 * r.abs()).all()
    small = tattn._round_tf32(r - big)
    assert ((big + small - r).abs() <= 2.0 ** -22 * r.abs()).all()


@pytest.mark.parametrize("D", tattn.HEAD_DIMS)
def test_flash_plan_fits_a_block_at_every_instance(D):
    """Each kernel's shared memory within what a block may take on
    Hopper, with room for at least one block an SM."""
    plan = tattn.flash_plan(D)
    for kernel in ("fwd", "dq", "dkdv"):
        assert 0 < plan["smem_" + kernel] <= build.SMEM_BYTES, kernel
        assert plan["blocks_per_sm_" + kernel] >= 1, kernel
    assert plan["rows"] == tattn.FLASH_ROWS == 64
    assert plan["kv_cols"] % 8 == 0 and plan["q_cols"] % 8 == 0


def test_flash_plan_fits_two_blocks_an_sm_at_128():
    """The source note's claim at D = 128: every kernel at most 113 KB,
    so two blocks (8 warps) fit an SM."""
    plan = tattn.flash_plan(128)
    for kernel in ("fwd", "dq", "dkdv"):
        assert plan["smem_" + kernel] <= 113 * 1024, kernel
        assert plan["blocks_per_sm_" + kernel] >= 2, kernel
    assert (plan["kv_cols"], plan["q_cols"]) == (32, 16)


def test_flash_plan_refuses_a_width_without_an_instance():
    with pytest.raises(ValueError, match="not an instance"):
        tattn.flash_plan(40)
