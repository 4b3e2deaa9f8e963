"""The plain bf16 versions of the flash-attention and CRF kernels against
the JAX package's kernels at bf16, on the CPU (the card kernels are held
to these plain versions by ``chip_smoke.py`` phase 17 and the ``cuda``
tests of ``tests/test_torch_cuda.py``).

- flash forward: ``blockwise_plain`` at bf16 keeps ``_flash_kernel``'s
  rounding points (f32 scores and statistics, p rounded to bf16 before
  its product with v, o rounded once): bit-equal to the Pallas kernel
  interpreted where the keys fit one kv block (Tk <= 256), within one bf16
  ulp of the largest entry beyond;
- flash backward: ``flash_bwd_plain`` at bf16 (the analytic gradient of
  the widened operands, rounded to bf16) within 2e-2 of the largest entry
  of ``jax.vjp`` of ``blockwise_attention`` at bf16 (what ``_flash_bwd``
  computes), dq, dk, dv bf16 as JAX's cotangents;
- CRF forward: ``crf_forward_plain`` at bf16 bit-equal to the interpreted
  ``_crf_alphas_pallas`` (alphas) and ``_crf_core`` (log Z) and to
  ``crf_log_z_ref``'s scan;
- CRF backward: ``crf_bwd_plain`` at bf16 against ``_crf_bwd`` (the
  custom VJP of the interpreted ``_crf_core``): dx, da and db bit-equal,
  dtrans within 2e-2 of its largest entry (the port sums the pairwise
  marginals in f32 and rounds once, JAX adds each step's sum into a bf16
  accumulator: they part by up to 1 % here);
- the Viterbi: ``crf_viterbi_plain`` at bf16, paths and scores equal to
  ``crf_decode``'s at bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.layers.chain import crf_decode as j_crf_decode
from paddle_tpu.ops import attention as jatt
from paddle_tpu.ops import common
from paddle_tpu.ops import crf as jcrf
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.utils.precision import widen

BF, JBF = torch.bfloat16, jnp.bfloat16


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF)


def _flash_inputs(B, N, Tq, Tk, D, pad_row, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, N, t, D)).astype(np.float32)
                   for t in (Tq, Tk, Tk, Tq))
    mask = np.ones((B, Tk), np.float32)
    if pad_row:
        mask[-1] = 0.0  # an all-padding kv row, as a batch bucket pads it
    if Tk > 3:
        mask[0, -2:] = 0.0
    return q, k, v, mask, do


def _ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


# (B, N, Tq, Tk, D, causal, pad_row)
ONE_BLOCK = [(2, 2, 12, 16, 16, False, True), (2, 2, 12, 16, 16, True, False),
             (2, 2, 40, 256, 16, False, True), (1, 2, 8, 8, 32, False, False)]
BEYOND = [(2, 2, 300, 300, 16, False, True), (2, 2, 300, 300, 16, True, False)]


@pytest.mark.parametrize("case", ONE_BLOCK + BEYOND)
def test_plain_flash_forward_keeps_the_pallas_kernels_rounding(case):
    """Bit-equal to ``_flash_kernel`` interpreted within one kv block;
    beyond it (Tk = 300: two blocks), within one bf16 ulp of the largest
    entry. The row statistics f32, o bf16."""
    B, N, Tq, Tk, D, causal, pad_row = case
    q, k, v, mask, _ = _flash_inputs(*case[:5], pad_row)
    with common.force_mode("interpret"):
        want = _np(jatt.flash_attention(
            *(jnp.asarray(t, JBF) for t in (q, k, v)), jnp.asarray(mask),
            causal=causal))
    o, lse = tatt.blockwise_plain(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                                  causal)
    assert o.dtype == BF and lse.dtype == torch.float32
    got = o.float().numpy()
    if Tk <= 256:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= _ulp(np.abs(want).max())


@pytest.mark.parametrize("case", ONE_BLOCK[:3] + BEYOND[1:])
def test_plain_flash_backward_against_vjp_of_blockwise(case):
    """dq, dk, dv of the plain bf16 backward (from the plain forward's o
    and statistics) within 2e-2 of the largest entry of ``jax.vjp`` of
    ``blockwise_attention`` at bf16, and bf16 like JAX's cotangents."""
    B, N, Tq, Tk, D, causal, pad_row = case
    q, k, v, mask, do = _flash_inputs(*case[:5], pad_row, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: jatt.blockwise_attention(
        a, b, c, jnp.asarray(mask), causal=causal, block_k=256),
        *(jnp.asarray(t, JBF) for t in (q, k, v)))
    want = vjp(jnp.asarray(do, JBF))
    tq, tk, tv = _t(q), _t(k), _t(v)
    tmask = torch.from_numpy(mask)
    o, lse = tatt.blockwise_plain(tq, tk, tv, tmask, causal)
    got = tatt.flash_bwd_plain(tq, tk, tv, tmask, o, lse, _t(do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == BF and w.dtype == JBF, name
        w = _np(w)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max(
        ), name


def test_flash_attention_keeps_the_mask_f32():
    """``flash_attention`` hands the kernels an f32 mask for bf16 q (the
    mask invariant), and the plain path gives o in q's dtype."""
    q, k, v, mask, _ = _flash_inputs(2, 2, 5, 7, 8, True)
    seen = {}
    real = tatt.flash_fwd

    def spy(q, k, v, kv_mask=None, causal=False, scale=None):
        seen["mask"] = kv_mask.dtype
        return real(q, k, v, kv_mask, causal, scale)

    tatt.flash_fwd = spy
    try:
        with torch.no_grad():
            o = tatt.flash_attention(_t(q), _t(k), _t(v),
                                     torch.from_numpy(mask))
    finally:
        tatt.flash_fwd = real
    assert seen["mask"] == torch.float32 and o.dtype == BF


def _crf_inputs(B, T, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, T, C)) * 2).astype(np.float32)
    trans = rng.normal(size=(C, C)).astype(np.float32)
    a, b = (rng.normal(size=C).astype(np.float32) for _ in range(2))
    mask = np.zeros((B, T), np.float32)
    for i in range(B):
        mask[i, :int(rng.integers(1, T + 1))] = 1.0
    mask[0] = 1.0
    g = rng.normal(size=B).astype(np.float32)
    return x, mask, trans, a, b, g


CRF_CASES = [(3, 5, 4), (4, 20, 23), (2, 12, 9)]


@pytest.fixture(scope="module", params=CRF_CASES)
def crf_case(request):
    """The inputs at bf16 and JAX's interpreted kernel path: (inputs,
    alphas, log Z, (dx, dtrans, da, db), log Z of the scan, the Viterbi's
    path and score)."""
    B, T, C = request.param
    x, mask, trans, a, b, g = _crf_inputs(B, T, C, seed=B + T + C)
    J = lambda t: jnp.asarray(t, JBF)  # noqa: E731
    with common.force_mode("interpret"):
        alphas = jcrf._crf_alphas_pallas(J(x), J(mask), J(trans), J(a))
        log_z, vjp = jax.vjp(lambda x_, t_, a_, b_: jcrf._crf_core(
            x_, J(mask), t_, a_, b_), J(x), J(trans), J(a), J(b))
        grads = vjp(J(g))
    ref = jcrf.crf_log_z_ref(J(x), J(mask), J(trans), J(a), J(b))
    path, score = j_crf_decode(J(x), J(mask), jnp.concatenate(
        [J(a)[None], J(b)[None], J(trans)]))
    return ((x, mask, trans, a, b, g), alphas, log_z, grads, ref,
            np.asarray(path), score)


def test_plain_crf_forward_is_bit_equal_to_jax(crf_case):
    """alphas and log Z bf16, bit-equal to the interpreted Pallas kernel
    and to ``crf_log_z_ref``'s scan."""
    (x, mask, trans, a, b, _), alphas, log_z, _, ref, _, _ = crf_case
    got_a, got_z = tcrf.crf_forward_plain(_t(x), _t(mask), _t(trans), _t(a),
                                          _t(b))
    assert got_a.dtype == BF and got_z.dtype == BF
    np.testing.assert_array_equal(got_a.float().numpy(), _np(alphas))
    np.testing.assert_array_equal(got_z.float().numpy(), _np(log_z))
    np.testing.assert_array_equal(got_z.float().numpy(), _np(ref))


def test_plain_crf_backward_against_jax(crf_case):
    """dx, da, db bit-equal to ``_crf_bwd``'s at bf16; dtrans within 2e-2
    of its largest entry (f32 sums against JAX's bf16 accumulator)."""
    (x, mask, trans, a, b, g), _, _, want, _, _, _ = crf_case
    al, lz = tcrf.crf_forward_plain(_t(x), _t(mask), _t(trans), _t(a),
                                    _t(b))
    dx, dtrans, da, db = tcrf.crf_bwd_plain(_t(x), _t(mask), _t(trans),
                                            _t(b), al, lz, _t(g))
    assert all(t.dtype == BF for t in (dx, dtrans, da, db))
    for got, w in ((dx, want[0]), (da, want[2]), (db, want[3])):
        np.testing.assert_array_equal(got.float().numpy(), _np(w))
    w = _np(want[1])
    assert np.abs(dtrans.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()


def test_plain_viterbi_equals_crf_decode_at_bf16(crf_case):
    """The paths equal ``crf_decode``'s at bf16 and the scores (bf16) too:
    each step one rounded addition, the first index at a tie."""
    (x, mask, trans, a, b, _), _, _, _, _, path, score = crf_case
    got_p, got_s = tcrf.crf_viterbi_plain(_t(x), _t(mask), _t(trans),
                                          _t(a), _t(b))
    np.testing.assert_array_equal(got_p.numpy(), path)
    assert got_s.dtype == BF
    np.testing.assert_array_equal(got_s.float().numpy(), _np(score))


def test_widen_casts_only_the_narrow_tensors():
    """``widen``: bf16 tensors cast to f32 exactly, f32 and f64 ones
    passed through (a wrong dtype is the kernel check's to refuse); the
    casts counted (each one device launch on the card)."""
    f = torch.randn(3, 4)
    b = torch.randn(4, 5).to(BF)
    d = torch.randn(2).double()
    (f2, b2, d2), n = widen((f, b, d))
    assert f2 is f and d2 is d and b2.dtype == torch.float32 and n == 1
    assert torch.equal(b2.to(BF), b)
    assert widen((f,))[1] == 0
