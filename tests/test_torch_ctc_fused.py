"""The port's fused CTC (``paddle_tpu_torch/ops/ctc.py:
ctc_ll_from_log_probs`` and its kernels' plain versions) against the JAX
package, on the CPU, where the wrappers run their plain versions.

- The fused wrapper's plain path (the extended labels, the gather, the
  plain recursions, autograd's scatter) against JAX's
  ``paddle_tpu/layers/chain.py:ctc_loss`` and ``jax.vjp`` of it, with
  ``_ctc_core`` in interpret mode (as ``tests/test_torch_ctc.py`` runs
  it), at the cases of ``tests/test_torch_ctc.py`` with the blank at 0 and
  at C - 1: values rtol 1e-5 / atol 1e-5, gradients with respect to the
  log-probs rtol 1e-4 / atol 1e-5.
- The kernels' shortened log-sum-exp (``lse3_kernel``: two exps, the
  three terms in the plain order) inside ``ctc_forward_plain`` and
  ``ctc_bwd_plain`` over T = 1600 at ``chip_smoke.py``'s LibriSpeech-length
  shape: within the card tolerances of today's plain versions (alphas and
  ll rtol 1e-4 / atol 1e-5, NEG entries equal; the gradient within 1e-4 of
  its largest entry + 1e-5), and in fact bit-equal.
- The posterior pass's class sums (ascending s from 0), emulated in plain
  torch, against autograd's scatter within 1e-6 relative.
- The routes (``ctc_plan``) at S = 133, 481 and the former limits, and
  at the sizes the kernels refused before (C = 60,000; S = 20,001); the
  fused wrappers' CPU path at C = 60,000 against JAX.

Run as a script, it prints the accuracy budget of other log-sum-exp
spellings over T = 1600 (each against today's plain versions, as a
multiple of the card tolerance): ``python tests/test_torch_ctc_fused.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.layers.chain import ctc_loss as j_ctc_loss
from paddle_tpu.ops import common
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops import ctc as tctc

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_torch_ctc.py's cases: (B, T, C, labels per row (no blank),
# frames per row); "infeasible" has rows with fewer frames than their
# labels need. Labels are drawn below C - 1 and shifted up by one where the
# blank is 0.
CASES = {
    "ragged": (4, 12, 6, [[0, 3, 1, 2], [4, 1], [2], [3, 0, 4]],
               [12, 9, 5, 10]),
    "empty": (3, 8, 6, [[1, 2], [], [4]], [8, 6, 3]),
    "repeats": (3, 12, 6, [[1, 1, 2, 2], [3, 3, 3], [0, 4, 4]],
                [12, 10, 7]),
    "tight": (2, 9, 6, [[0, 1, 2, 3], [2, 2, 1, 1]], [9, 9]),
    "infeasible": (3, 10, 6, [[0, 1, 2, 3], [1, 1, 1, 1], [2, 3]],
                   [3, 6, 10]),
    "padded": (4, 12, 5, [[0, 1], [2, 3, 0], [1], [3, 3]],
               [4, 7, 2, 12]),
    "b1": (1, 11, 6, [[4, 0, 4, 2]], [11]),
}


def _inputs(case, blank_at_zero, seed=0):
    """log_probs [B,T,C], labels [B,L] (int32, padded with 0), in_mask
    [B,T], label_mask [B,L], the cotangent g [B] and the blank."""
    B, T, C, labs, frames = CASES[case]
    rng = np.random.default_rng(seed + 7 * B + T + blank_at_zero)
    L = max(max(len(x) for x in labs), 1)
    logits = rng.normal(size=(B, T, C)).astype(np.float32)
    log_probs = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = np.zeros((B, L), np.int32)
    label_mask = np.zeros((B, L), np.float32)
    for b, x in enumerate(labs):
        labels[b, :len(x)] = np.asarray(x) + int(blank_at_zero)
        label_mask[b, :len(x)] = 1.0
    in_mask = (np.arange(T)[None, :] < np.array(frames)[:, None]).astype(
        np.float32)
    g = rng.normal(size=B).astype(np.float32)
    return log_probs, labels, in_mask, label_mask, g, \
        0 if blank_at_zero else C - 1


@pytest.mark.parametrize("blank_at_zero", [False, True],
                         ids=["blank_last", "blank_0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_path_matches_jax_ctc_loss(case, blank_at_zero):
    """-ll and d(sum g * loss) / d log_probs of ``ctc_ll_from_log_probs``
    on the CPU (no kernel launch counted) against JAX's ``ctc_loss`` and
    its VJP through the interpreted Pallas kernel and ``_ctc_bwd``."""
    log_probs, labels, in_mask, label_mask, g, blank = _inputs(
        case, blank_at_zero)

    @jax.jit
    def run(lp, lab, im, lm, gg):
        loss, vjp = jax.vjp(lambda x: j_ctc_loss(x, lab, im, lm, blank), lp)
        return loss, vjp(gg)[0]

    with common.force_mode("interpret"):
        want, want_g = (np.asarray(v) for v in run(*(jnp.asarray(v) for v in (
            log_probs, labels, in_mask, label_mask, g))))
    before = {k: v["launches"] for k, v in tops.kernel_counts().items()
              if k.startswith("ctc_")}
    leaf = torch.from_numpy(log_probs).requires_grad_(True)
    loss = -tctc.ctc_ll_from_log_probs(leaf, torch.from_numpy(labels),
                                       torch.from_numpy(in_mask),
                                       torch.from_numpy(label_mask), blank)
    got_g, = torch.autograd.grad((loss * torch.from_numpy(g)).sum(), leaf)
    assert before == {k: v["launches"] for k, v in
                      tops.kernel_counts().items() if k.startswith("ctc_")}
    loss, got_g = loss.detach().numpy(), got_g.numpy()
    assert np.isfinite(loss).all() and np.isfinite(got_g).all()
    np.testing.assert_allclose(loss, want, **VAL_TOL)
    np.testing.assert_allclose(got_g, want_g, **GRAD_TOL)


def test_fused_plain_path_reads_no_padded_label_slot():
    """Ids at or above C in the label slots past each transcript give the
    result of zeros there, value and gradient."""
    log_probs, labels, in_mask, label_mask, g, blank = _inputs("padded",
                                                               False)
    wild = labels.copy()
    wild[label_mask == 0] = 1000
    results = []
    for lab in (labels, wild):
        leaf = torch.from_numpy(log_probs).requires_grad_(True)
        ll = tctc.ctc_ll_from_log_probs(leaf, torch.from_numpy(lab),
                                        torch.from_numpy(in_mask),
                                        torch.from_numpy(label_mask), blank)
        results.append((ll.detach(), torch.autograd.grad(
            (ll * torch.from_numpy(g)).sum(), leaf)[0]))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])


def _long_inputs(B=16, T=1600, L=240, seed=1856):
    """chip_smoke.py's phase 6b operands at its LibriSpeech-length row
    (C = 29, blank 28; ragged frames, an empty transcript, repeated labels,
    an infeasible row), on the CPU: the gathered operands and g."""
    C = 29
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    log_probs = torch.log_softmax(logits, dim=-1)
    in_lens = rng.integers(T // 4, T + 1, size=B)
    in_lens[0] = T
    lab_lens = np.minimum(rng.integers(in_lens // 10, in_lens // 6 + 1), L)
    labels = rng.integers(0, C - 1, size=(B, L))
    lab_lens[1] = 0
    labels[2, 1::2] = labels[2, 0::2][:L // 2]
    in_lens[2], lab_lens[2] = T, L
    in_lens[3], lab_lens[3] = max(L // 2, 1), L
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32))
    label_mask = torch.from_numpy((np.arange(L)[None, :] < lab_lens[:, None])
                                  .astype(np.float32))
    emit, valid_s, can_skip, ext_lens, _ = tctc._fused_operands(
        log_probs, torch.from_numpy(labels), label_mask, C - 1)
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    return (emit, in_mask, valid_s, can_skip, ext_lens), g


def _against_today(ops, g, lse3, ref=None):
    """(alphas, ll, demit) of the plain versions with ``lse3``, and each
    one's error against today's plain versions (``ref``, computed when not
    given) as a multiple of the card tolerance: alphas and ll rtol 1e-4 /
    atol 1e-5 (inf where their NEG entries differ), demit 1e-4 of its
    largest entry + 1e-5."""
    if ref is None:
        ref = _run(ops, g, tctc._lse3)
    got = _run(ops, g, lse3)
    ratios = []
    for a, b in zip(got[:2], ref[:2]):
        neg = b < -1e29
        if not torch.equal(a[neg], b[neg]) or not (a[~neg] > -1e29).all():
            ratios.append(math.inf)
            continue
        ratios.append(((a[~neg] - b[~neg]).abs()
                       / (1e-5 + 1e-4 * b[~neg].abs())).max().item())
    ratios.append((got[2] - ref[2]).abs().max().item()
                  / (1e-4 * ref[2].abs().max().item() + 1e-5))
    return got, ref, ratios


def _run(ops, g, lse3):
    alphas, ll = tctc.ctc_forward_plain(*ops, lse3=lse3)
    return alphas, ll, tctc.ctc_bwd_plain(*ops, alphas, ll, g, lse3=lse3)


def test_kernel_lse3_holds_the_card_tolerances_over_1600_frames():
    """The kernels' log-sum-exp (two exps; the largest term's exp is 1
    exactly) in the plain recursions, forward and backward, over T = 1600:
    within the card's tolerances of today's plain versions at every
    output, and bit-equal to them."""
    ops, g = _long_inputs()
    got, ref, ratios = _against_today(ops, g, tctc.lse3_kernel)
    assert max(ratios) <= 1.0, ratios
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_lse3_gives_the_plain_bits_at_every_corner(seed):
    """``lse3_kernel`` equals ``_lse3`` bit for bit on terms that tie, sit
    at NEG, below NEG (-2e30: a closed jump that the plain beta adds NEG
    to) and at the scale of long alphas."""
    rng = np.random.default_rng(seed)
    pool = np.array([-1e30, -2e30, 0.0, -1.5, -4000.25, -4000.5, -3.0],
                    np.float32)
    vals = [torch.from_numpy(np.where(
        rng.random(4096) < 0.5, rng.choice(pool, 4096),
        rng.normal(scale=10 ** seed, size=4096)).astype(np.float32))
        for _ in range(3)]
    assert torch.equal(tctc.lse3_kernel(*vals), tctc._lse3(*vals))


def test_class_sum_order_matches_autograd_scatter():
    """``class_sums_plain`` (each (b, t, c) summed over its states in
    ascending s from 0, the posterior pass's order) equals autograd's
    scatter-add through the gather within 1e-6 relative."""
    rng = np.random.default_rng(3)
    B, T, C, S = 3, 7, 5, 41
    ext = torch.from_numpy(rng.integers(0, C, size=(B, S)))
    demit = torch.from_numpy(rng.normal(size=(B, T, S)).astype(np.float32))
    leaf = torch.zeros(B, T, C, requires_grad=True)
    emit = torch.gather(leaf, 2, ext[:, None, :].expand(B, T, S))
    want, = torch.autograd.grad(emit, leaf, demit)
    got = tctc.class_sums_plain(demit, ext, C)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _former_limit(C):
    """The S above which the kernels refused before any S and C were taken:
    16 states a lane over 32 warps, and the staged posterior pass's 4 (C +
    1) + 8 S bytes within a block."""
    return max(0, min(tctc.MAX_STATES, (build.SMEM_BYTES - 4 * (C + 1)) // 8))


@pytest.mark.parametrize("S,C", [(133, 29), (481, 29), (None, 29),
                                 (None, 0), (None, 40000)])
def test_smem_formula_against_the_limit(S, C):
    """At S = 133, 481 and the former limit of C classes, ``ctc_plan``
    keeps the lane chains and the staged posterior pass (the chains cover
    S within 32 warps, both kernels' shared memory fits a block); two
    states more take the wide chains (above 16,384 states) or the sorted
    posterior pass (at 40,000 classes, where the class offsets and one
    frame no longer fit), and nothing raises."""
    limit = _former_limit(C)
    S = S or limit
    plan = tctc.ctc_plan(S, C)
    assert (plan["fwd"], plan["bwd"]) == ("lanes", "staged")
    assert plan["warps"] <= 32 and 32 * plan["warps"] * plan["per_lane"] >= S
    assert plan["smem_chain"] <= build.SMEM_BYTES
    assert plan["smem_grad"] <= build.SMEM_BYTES and plan["frames"] >= 1
    above = tctc.ctc_plan(limit + 2, C)
    if C == 40000:
        assert limit < tctc.MAX_STATES
        assert 4 * (C + 1) + 8 * (limit + 1) > build.SMEM_BYTES
        assert (above["fwd"], above["bwd"]) == ("lanes", "sorted")
        assert above["smem_grad"] == 0 and above["order_ints"] == limit + 2
    else:
        assert limit == tctc.MAX_STATES == 16384 >= 12001
        assert (above["fwd"], above["bwd"]) == ("wide", "staged")
        assert above["smem_chain"] == 0
        assert above["scratch_floats"] == 2 * (limit + 2)
    if S in (133, 481):  # a state a lane: 5 and 16 warps
        assert (plan["per_lane"], plan["warps"]) == (1, -(-S // 32))


@pytest.mark.parametrize("S,C,routes", [
    (21, 60000, ("lanes", "sorted")),      # every transcript refused before
    (20001, 29, ("wide", "staged")),       # above 16,384 states
    (20001, 20000, ("wide", "sorted")),
    (1, 1, ("lanes", "staged"))])
def test_ctc_plan_takes_every_size(S, C, routes):
    """Sizes the kernels refused (C >= 58,110 at any S; S > 16,384) have a
    route; the wrappers' CPU path takes them too (below)."""
    plan = tctc.ctc_plan(S, C)
    assert (plan["fwd"], plan["bwd"]) == routes
    with pytest.raises(ValueError, match="S >= 1"):
        tctc.ctc_plan(0, C)


def test_fused_plain_matches_jax_at_60000_classes():
    """C = 60,000 (B = 1, T = 8, L = 3, a repeat): the fused wrappers' CPU
    path (``ctc_fused_fwd`` / ``ctc_fused_bwd``: the plain versions the
    card holds the kernels to) against JAX's ``ctc_loss`` and its VJP."""
    B, T, C, blank = 1, 8, 60000, 0
    rng = np.random.default_rng(60000)
    log_probs = np.array(jax.nn.log_softmax(jnp.asarray(
        rng.normal(size=(B, T, C)).astype(np.float32)), axis=-1))
    labels = np.array([[17, 59999, 59999]], np.int32)
    in_mask, label_mask = np.ones((B, T), np.float32), np.ones((B, 3),
                                                               np.float32)
    g = np.array([0.7], np.float32)

    def jloss(lp):
        return j_ctc_loss(lp, jnp.asarray(labels), jnp.asarray(in_mask),
                          jnp.asarray(label_mask), blank)

    with common.force_mode("interpret"):
        want, vjp = jax.vjp(jloss, jnp.asarray(log_probs))
        want_g = np.asarray(vjp(jnp.asarray(g))[0])
    args = (torch.from_numpy(labels), torch.from_numpy(in_mask),
            torch.from_numpy(label_mask), blank)
    loss, alphas, betas = tctc.ctc_fused_fwd(torch.from_numpy(log_probs),
                                             *args, grad=True, negate=True)
    dlp = tctc.ctc_fused_bwd(*args, C, alphas, betas, loss,
                             torch.from_numpy(g), negate=True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), **VAL_TOL)
    np.testing.assert_allclose(dlp.numpy(), want_g, **GRAD_TOL)
    assert np.count_nonzero(dlp.numpy()) <= T * 3  # blank, 17, 59999


# ----------------------------------------------------- the budget, printed
def _lse3_base2(bias=0.0):
    """The base-2 form the approximate SFU functions would take (exp2 of
    (x - ms) log2(e), log2 of the sum times ln 2; NEG selected, never
    scaled), each function off by ``bias`` of 2^-22 (ex2.approx's relative
    and lg2.approx's absolute error bound)."""
    eps = bias * 2.0 ** -22

    def lse3(a, b, c):
        m = torch.maximum(torch.maximum(a, b), c)
        ms = torch.clamp_min(m, tctc.NEG)

        def ex(x):
            return torch.exp2((x - ms) * math.log2(math.e)) * (1 + eps)

        s = torch.log2(ex(a) + ex(b) + ex(c)) + eps
        return ms + s * math.log(2.0)
    return lse3


def _lse3_reordered(a, b, c):
    """Two exps with the largest term's 1 added first: another order."""
    m = torch.maximum(torch.maximum(a, b), c)
    ms = torch.clamp_min(m, tctc.NEG)
    lo = torch.minimum(a, b)
    mid = torch.minimum(torch.maximum(a, b), c)
    return ms + torch.log(1 + torch.exp(mid - ms) + torch.exp(lo - ms))


if __name__ == "__main__":
    ops, g = _long_inputs()
    ref = _run(ops, g, tctc._lse3)
    print("T = 1600, S = 481, B = 16: error / card tolerance "
          "(alphas, ll, gradient)")
    for name, fn in (("kernel (two exps, plain order)", tctc.lse3_kernel),
                     ("reordered sum", _lse3_reordered),
                     ("base 2", _lse3_base2()),
                     ("base 2, +2^-22", _lse3_base2(1.0)),
                     ("base 2, -2^-22", _lse3_base2(-1.0))):
        print(f"{name:32s}", ["%.3g" % r for r in
                              _against_today(ops, g, fn, ref)[2]])
