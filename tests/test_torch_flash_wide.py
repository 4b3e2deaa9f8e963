"""Flash attention at head widths above 128, on the CPU: the port's plain
versions (``blockwise_plain``, ``flash_bwd_plain``: what the wide-head
kernels of ``paddle_tpu_torch/csrc/flash_attn.cu`` are held to on the card
by ``tests/test_torch_cuda.py``) against the JAX package's
``flash_attention``, which takes any D, and the routing of a head width
to the kernels (``padded_width``, ``flash_plan``).

The JAX side runs ``flash_attention`` under ``force_mode("interpret")`` at
its default blocks, so its Pallas kernel ``_flash_kernel`` is taken, and
its gradient is ``jax.vjp`` of ``blockwise_attention``; rows that see no
key (an all-padding kv row with Tk > 256, and causal with Tq > Tk) get
JAX's padded mean of v. Inputs come from numpy with a seed (D = 160 and
256, T <= 300; D = 1056 and 2048, the split-row path's widths).

Tolerances: the forward rtol/atol 1e-5 (f32 sums over D and Tk in another
order); gradients rtol 1e-4 / atol 1e-5 (the analytic backward against
JAX's recompute through the online softmax).
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

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, N, Tq, Tk, D, seed, all_padding):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lens = rng.integers(1, Tk + 1, size=B)
    lens[0] = Tk
    if all_padding:
        lens[-1] = 0
    mask = (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)
    return f(B, N, Tq, D), f(B, N, Tk, D), f(B, N, Tk, D), mask, \
        f(B, N, Tq, D)


def _jax(q, k, v, mask, causal, do):
    def loss(q_, k_, v_):
        return jnp.sum(flash_attention(q_, k_, v_, jnp.asarray(mask),
                                       causal=causal) * do)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    with common.force_mode("interpret"):
        out = flash_attention(*args, jnp.asarray(mask), causal=causal)
        grads = jax.grad(loss, (0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


# (B, N, Tq, Tk, D, causal, all_padding): a ragged self-attention; the
# chip check's shape cut in batch, with its all-padding kv row (Tk > 256,
# Tk % 256 != 0: Tk_pad = 512); causal cross with Tq > Tk, whose first
# Tq - Tk rows see no key
CASES = [(2, 2, 40, 40, 160, True, False),
         (2, 1, 20, 300, 256, False, True),
         (2, 1, 300, 300, 256, True, True),
         (1, 2, 45, 30, 160, True, False),
         # the split-row path's widths (above 1024)
         (2, 1, 24, 20, 1056, True, True),
         (1, 2, 16, 16, 2048, False, False)]


@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", CASES)
def test_plain_versions_match_jax_at_wide_heads(B, N, Tq, Tk, D, causal,
                                                all_padding):
    """o from ``blockwise_plain`` and (dq, dk, dv) from ``flash_bwd_plain``
    on its row statistics against JAX's ``flash_attention`` and
    ``jax.grad`` through it; the rows that see no key get sum_j v_j /
    Tk_pad, the row statistics (-1e9, log Tk_pad) and a zero dq."""
    q, k, v, mask, do = _inputs(B, N, Tq, Tk, D, B * Tq + D, all_padding)
    j_out, j_grads = _jax(q, k, v, mask, causal, do)
    tq, tk, tv, tm, tdo = (torch.from_numpy(a) for a in (q, k, v, mask, do))
    o, lse = tattn.blockwise_plain(tq, tk, tv, tm, causal)
    np.testing.assert_allclose(o.numpy(), j_out, **FWD_TOL)
    grads = tattn.flash_bwd_plain(tq, tk, tv, tm, o, lse, tdo, causal)
    for name, g, w in zip(("dq", "dk", "dv"), grads, j_grads):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)
    vis = np.broadcast_to(mask[:, None, :] > 0, (B, Tq, Tk))
    if causal:
        vis = vis & (np.arange(Tk)[None, :] <= np.arange(Tq)[:, None]
                     + (Tk - Tq))
    rows = ~vis.any(axis=-1)
    if all_padding or Tq > Tk:
        assert rows.any()
    b, i = np.nonzero(rows)
    bk = min(256, Tk)
    tk_pad = -(-Tk // bk) * bk
    np.testing.assert_allclose(o.numpy()[b, :, i], v[b].sum(axis=2) / tk_pad,
                               **FWD_TOL)
    assert grads[0].numpy()[b, :, i].size == 0 or \
        np.abs(grads[0].numpy()[b, :, i]).max() == 0.0
    lse = lse.reshape(2, B, N, Tq).numpy()
    assert (lse[0][b, :, i] == -1e9).all()


def test_the_wrappers_take_wide_heads_on_the_cpu():
    """``flash_attention`` at D = 160 on CPU tensors runs the plain
    versions through ``FlashFunction`` (no kernel launch) and gives JAX's
    forward and gradients."""
    q, k, v, mask, do = _inputs(2, 2, 24, 31, 160, 7, True)
    j_out, j_grads = _jax(q, k, v, mask, False, do)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = (tattn.flash_fwd.launches, tattn.flash_bwd.launches)
    out = tattn.flash_attention(*leaves, torch.from_numpy(mask))
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    assert (tattn.flash_fwd.launches, tattn.flash_bwd.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), j_out, **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, j_grads):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("D", [129, 160, 256, 257, 384, 512, 513, 1024])
def test_wide_heads_route_to_the_wide_path(D):
    """Every D from 129 to ``WIDE_MAX_D`` (1024) takes the wide-head path
    unpadded at the wrapper: ``padded_width`` is D itself and
    ``flash_plan`` gives the wide variant, 16 rows a block, streamed tiles
    of 64 rows in chunks of 64 columns through a ring (4 forward, 2
    backward), D padded inside the kernels to the next chunk (the
    instance's chunks 4, 8 or 16 hold it), and each kernel's shared memory
    (the resident rows q; q and dO; k and v: split into 2 x padded words a
    row, else padded + 4 floats where dq's and dkdv's are raw, above 512)
    within a block's limit, two blocks an SM up to D = 256."""
    assert tattn.padded_width(D) == D
    plan = tattn.flash_plan(D)
    assert plan["variant"] == "wide" and plan["max_d"] == tattn.WIDE_MAX_D
    assert (plan["rows"], plan["stage_rows"], plan["chunk"]) == (16, 64, 64)
    assert plan["stages"] == dict(fwd=4, dq=2, dkdv=2)
    assert plan["padded"] % 64 == 0 and 0 <= plan["padded"] - D < 64
    assert plan["padded"] <= 64 * plan["instance"] and (
        plan["instance"] == 4 or 32 * plan["instance"] < plan["padded"])
    shared = 2 * 16 * 68 + 2 * 8 * 16 + 16
    dp = plan["padded"]
    row = 2 * dp if plan["instance"] <= 8 else dp + 4
    assert plan["presplit"] == dict(fwd=True, dq=plan["instance"] <= 8,
                                    dkdv=plan["instance"] <= 8)
    assert plan["smem_fwd"] == 4 * (16 * 2 * dp + 4 * 64 * 68 + shared)
    assert plan["smem_dq"] == plan["smem_dkdv"] == \
        4 * (2 * 16 * row + 2 * 64 * 68 + shared)
    for kernel in ("fwd", "dq", "dkdv"):
        assert plan["smem_" + kernel] <= build.SMEM_BYTES
        assert plan["blocks_per_sm_" + kernel] >= (2 if D <= 256 else 1)


@pytest.mark.parametrize("D", [1025, 1056, 4096])
def test_heads_above_the_wide_limit_raise_naming_it(D):
    """Above ``WIDE_MAX_D`` the kernels no longer refuse: ``padded_width``
    is D itself and ``flash_plan`` gives the split-row path (a block of
    256 threads a row, 8 streamed rows a step, no dynamic shared memory);
    the instances keep their padding below 128 and D < 1 raises."""
    assert tattn.padded_width(D) == D
    plan = tattn.flash_plan(D)
    assert (plan["variant"], plan["rows"], plan["threads"],
            plan["stage_rows"]) == ("split", 1, 256, 8)
    assert plan["smem_fwd"] == plan["smem_dq"] == plan["smem_dkdv"] == 0
    with pytest.raises(ValueError, match="D >= 1"):
        tattn.padded_width(0)
    assert [tattn.padded_width(d) for d in (8, 9, 40, 100, 128)] == \
        [8, 16, 64, 128, 128]
    assert tattn.flash_plan(128)["variant"] == "tensor_cores"
