"""The CRF kernels' design in plain code, on the CPU (``paddle_tpu_torch/
ops/crf.py``; the kernels are ``csrc/crf.cu``, held to the same plain
versions on the card by ``tests/test_torch_cuda.py``):

- the plain forward against the JAX package at C = 33, 257 and 300, class
  counts of the forward's block variant, in and out of shared memory
  (``paddle_tpu/ops/crf.py:_crf_alphas_pallas`` interpreted and
  ``crf_log_z_ref``), with ragged and all-padding rows;
- the forward's summation orders in plain code (a warp: each lane's
  column in order; a block: K parts of a column, each in order, then the
  butterfly; log Z over the owners, the warps' butterflies and the warps
  in order), held to ``crf_forward_plain``;
- the plain backward and Viterbi against the JAX package at C = 300
  (``jax.vjp`` of ``paddle_tpu/ops/crf.py:crf_log_z`` with its Pallas
  kernel interpreted, and ``paddle_tpu/layers/chain.py:crf_decode``, as
  ``tests/test_torch_crf.py`` runs them);
- the Viterbi kernels' max over i as four interleaved partial (value,
  first index) maxima combined with the lower index winning a tie, in
  plain code, equal to ``torch.max`` / ``torch.argmax``;
- the backward's fixed summation orders in plain code (up to 32 classes
  each sequence's pairs in order, then the sequences in order; above, the
  marginal pass's chunks of pairs in order; da and db over b in order),
  held to ``crf_bwd_plain``;
- ``chain_floor_plain``, what the chain-floor microkernel computes;
- ``crf_plan``'s variant and shared-memory formula at C = 1, 23, 32, 33,
  256, 257, 1000 and where the vectors outgrow shared memory, and the
  forward's at C = 1 .. 14,600.

Inputs come from numpy with a seed. Tolerances: log Z and scores 1e-5;
gradients per tensor within 1e-4 of the largest entry + 1e-5 (f32 sums in
other orders), paths equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.layers.chain import crf_decode as j_crf_decode
from paddle_tpu.ops import common
from paddle_tpu.ops.crf import _crf_alphas_pallas as j_crf_alphas
from paddle_tpu.ops.crf import crf_log_z as j_crf_log_z
from paddle_tpu.ops.crf import crf_log_z_ref as j_crf_log_z_ref
from paddle_tpu_torch.layers.chain import crf_decode as t_crf_decode
from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops import crf as tcrf


def _inputs(B, T, C, seed, lengths=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    lens = np.array(lengths) if lengths is not None else \
        rng.integers(1, T + 1, size=B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    trans = rng.normal(size=(C, C)).astype(np.float32)
    trans[0, 1] = trans[2, 3] = -1e4
    a, b = (rng.normal(size=C).astype(np.float32) for _ in range(2))
    g = rng.normal(size=B).astype(np.float32)
    return x, mask, trans, a, b, g


def _close_per_tensor(got, want, name):
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()) + 1e-5, (name, err)


def test_plain_backward_and_viterbi_match_jax_at_300_classes():
    """At C = 300 the backward and the Viterbi kernels run on the card
    (the forward keeps its 256); their plain versions, which the card holds
    them to, equal JAX's ``jax.vjp`` of ``crf_log_z`` (its Pallas kernel
    interpreted, the custom_vjp ``_crf_bwd``) and ``crf_decode``."""
    x, mask, trans, a, b, g = _inputs(3, 6, 300, 0, lengths=[6, 2, 0])
    args = [jnp.asarray(v) for v in (x, mask, trans, a, b)]
    with common.force_mode("interpret"):
        jz, vjp = jax.vjp(lambda x_, t_, a_, b_: j_crf_log_z(
            x_, args[1], t_, a_, b_), args[0], *args[2:])
        jg = vjp(jnp.asarray(g))
    tx, tmask, ttrans, ta, tb, tg = (torch.from_numpy(v)
                                     for v in (x, mask, trans, a, b, g))
    alphas, log_z = tcrf.crf_forward_plain(tx, tmask, ttrans, ta, tb)
    np.testing.assert_allclose(log_z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    before = tcrf.crf_bwd.launches
    got = tcrf.crf_bwd(tx, tmask, ttrans, tb, alphas, log_z, tg)
    assert tcrf.crf_bwd.launches == before  # the CPU runs the plain version
    for name, gk, gj in zip(("x", "trans", "a", "b"), got, jg):
        _close_per_tensor(gk, torch.from_numpy(np.array(gj)), name)
    assert abs(float(got[1][0, 1])) < 1e-6
    w = np.concatenate([a[None], b[None], trans], axis=0)
    jpath, jscore = j_crf_decode(jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(w))
    tpath, tscore = t_crf_decode(tx, tmask, torch.from_numpy(w))
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,lengths", [(33, [7, 1, 0]), (257, [7, 3, 0]),
                                       (300, [5, 7, 0, 2])])
def test_plain_forward_matches_jax_at_block_class_counts(C, lengths):
    """At C = 33 (E in shared memory), 257 and 300 (E read from L2) the
    forward kernel runs a block a sequence; its plain version, which the
    card holds it to, gives JAX's alphas (``_crf_alphas_pallas``, the
    Pallas kernel interpreted) and log Z (``crf_log_z`` interpreted and
    ``crf_log_z_ref``), with ragged rows, a length-1 row and an
    all-padding row (alpha frozen at alpha_0)."""
    B, T = len(lengths), max(lengths)
    x, mask, trans, a, b, _ = _inputs(B, T, C, C, lengths=lengths)
    args = [jnp.asarray(v) for v in (x, mask, trans, a, b)]
    with common.force_mode("interpret"):
        j_alphas = np.asarray(j_crf_alphas(args[0], args[1], args[2],
                                           args[3]))
        j_log_z = np.asarray(j_crf_log_z(*args))
    j_ref = np.asarray(j_crf_log_z_ref(*args))
    alphas, log_z = tcrf.crf_forward_plain(
        *(torch.from_numpy(v) for v in (x, mask, trans, a, b)))
    np.testing.assert_allclose(alphas.numpy(), j_alphas, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(log_z.numpy(), j_log_z, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(log_z.numpy(), j_ref, rtol=1e-5, atol=1e-5)
    pad = lengths.index(0)
    np.testing.assert_array_equal(alphas[pad].numpy(),
                                  np.broadcast_to(a + x[pad, 0], (T, C)))


# --------------------------------------------- the forward's sum orders
def _f32(v):
    return np.float32(v)


def _butterfly(parts):
    """The xor butterfly over K = len(parts) lanes as part 0 ends it:
    at o = 1, 2, ..., lane k adds lane k ^ o's value."""
    vals = [np.float32(v) for v in parts]
    o = 1
    while o < len(vals):
        vals = [np.float32(vals[k] + vals[k ^ o]) for k in range(len(vals))]
        o *= 2
    return vals[0]


def _forward_in_kernel_order(x, mask, trans, a, b):
    """``crf_alpha_fwd``'s arithmetic in numpy float32, in the kernels'
    orders (``crf_plan``'s variant and K): column j's dot over i as K
    parts (part k: i = k, k + K, ... in order; the warp variant: K = 1
    over the 8-rounded C, the padded terms +0), combined in the fixed
    butterfly, then ((log(max(s, 1e-37)) + m) + tm) + x_t[j]; log Z as m
    + log(z), z summed over each owner's columns in order, 32-lane
    butterflies, then the warps in order."""
    B, T, C = x.shape
    plan = tcrf.crf_plan(T, C)["fwd"]
    K, nt = plan["parts"], plan["threads"]
    slots = nt // K if plan["variant"] == "block" else 32
    tm = np.float32(trans.max())
    E = np.exp(trans - tm).astype(np.float32)
    alphas = np.zeros((B, T, C), np.float32)
    log_z = np.zeros(B, np.float32)
    for bb in range(B):
        alpha = (a + x[bb, 0]).astype(np.float32)
        alphas[bb, 0] = alpha
        for t in range(1, T):
            if mask[bb, t] > 0:
                m = np.float32(alpha.max())
                p = np.exp(alpha - m).astype(np.float32)
                new = np.empty(C, np.float32)
                for j in range(C):
                    parts = []
                    for k in range(K):
                        s = np.float32(0)
                        for i in range(k, C, K):
                            s = np.float32(s + p[i] * E[i, j])
                        parts.append(s)
                    s = _butterfly(parts)
                    r = np.float32(np.log(max(s, np.float32(1e-37))))
                    new[j] = np.float32(np.float32(np.float32(r + m) + tm)
                                        + x[bb, t, j])
                alpha = new
            alphas[bb, t] = alpha
        v = (alpha + b).astype(np.float32)
        m = np.float32(v.max())
        lane = np.zeros(max(nt, 32), np.float32)
        for j in range(C):  # owner thread of column j
            owner = (j % slots) * K
            lane[owner] = np.float32(lane[owner] + np.exp(np.float32(v[j]
                                                                  - m)))
        z = np.float32(0)
        for w in range(0, len(lane), 32):
            z = np.float32(z + _butterfly(lane[w:w + 32]))
        log_z[bb] = np.float32(m + np.float32(np.log(z)))
    return alphas, log_z


@pytest.mark.parametrize("B,T,C", [(3, 6, 23), (3, 6, 33), (2, 5, 128),
                                   (2, 4, 257)])
def test_forward_sum_order_holds_the_plain_forward(B, T, C):
    """The forward kernels' summation orders (the warp variant at C = 23;
    the block variant's K = 4 parts at C = 33 and 128, E in shared memory,
    and 2 at C = 257, E from L2), rendered in float32, within rtol 1e-4 /
    atol 1e-5 of ``crf_forward_plain``, an all-padding row included."""
    lengths = [T] + [2] * (B - 2) + [0]  # full, ragged, all padding
    x, mask, trans, a, b, _ = _inputs(B, T, C, B + T + C, lengths=lengths)
    got_a, got_z = _forward_in_kernel_order(x, mask, trans, a, b)
    want_a, want_z = tcrf.crf_forward_plain(
        *(torch.from_numpy(v) for v in (x, mask, trans, a, b)))
    np.testing.assert_allclose(got_a, want_a.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_z, want_z.numpy(), rtol=1e-4, atol=1e-5)
    assert tcrf.crf_plan(T, C)["fwd"]["parts"] == {23: 1, 33: 4, 128: 4,
                                                   257: 2}[C]


# ------------------------------------------------ the Viterbi's argmax
def _take_better(v, i, ov, oi):
    return (ov, oi) if ov > v or (ov == v and oi < i) else (v, i)


def _partial_argmax(row, parts):
    """The kernels' max over i: ``parts`` interleaved partial maxima (i =
    parts q + k, each in increasing i, ``>`` keeping the first index), then
    a tree that combines (0, 1), (2, 3), ... and then the pairs' winners,
    the lower index winning a tie. The kernels take 4 (``csrc/crf.cu:
    max_plus``'s loads in batches of 16 and 4 keep each partial's order)."""
    best = [float("-inf")] * parts
    idx = list(range(parts))
    for i, v in enumerate(row):
        if v > best[i % parts]:
            best[i % parts], idx[i % parts] = v, i
    h = 1
    while h < parts:
        for k in range(0, parts, 2 * h):
            best[k], idx[k] = _take_better(best[k], idx[k], best[k + h],
                                           idx[k + h])
        h *= 2
    return best[0], idx[0]


@pytest.mark.parametrize("C", [1, 2, 3, 5, 16, 17, 23, 33, 257])
def test_partial_argmax_combine_equals_torch_first_index(C):
    """The partial (value, index) maxima give ``torch.max``'s value and
    ``torch.argmax``'s first index on all-equal rows, rows of -1e4 and
    -inf (all of them, or mixed with one finite value), random rows, and
    rows of few distinct values (many ties)."""
    rng = np.random.default_rng(C)
    rows = [np.zeros(C), np.full(C, -1e4), np.full(C, -np.inf),
            rng.normal(size=C), rng.integers(0, 3, size=C).astype(float)]
    mixed = np.where(rng.random(C) < 0.5, -np.inf, -1e4)
    mixed[rng.integers(0, C)] = 0.5
    rows += [mixed, np.where(rng.random(C) < 0.5, -np.inf, 2.0)]
    for row in rows:
        t = torch.from_numpy(row.astype(np.float32))
        v, i = _partial_argmax(t.tolist(), 4)
        assert i == int(torch.argmax(t)), (row, i)
        assert v == float(torch.max(t))


# -------------------------------------------------- the marginal pass
def _fma_f32(a, b, c):
    """f32 a * b + c with one rounding (the kernel's contracted
    ``acc += e * w``): exact product in float64, one rounding to f32 up to
    a double rounding."""
    return (a.double() * b.double() + c.double()).float()


def _pair_term(x, mask, trans, alphas, betas, log_z, g, b, t):
    """Pair (t, t+1) of sequence b: its pairwise marginals [C, C] before
    the weight, and the weight mask_{t+1} mask_t g."""
    r = x[b, t + 1] + betas[b, t + 1]
    s = alphas[b, t][:, None] + trans + r[None, :] - log_z[b]
    w = mask[b, t + 1] * mask[b, t] * g[b]
    return torch.exp(torch.clamp_max(s, 30.0)), w


def _marginals_in_kernel_order(x, mask, trans, b, alphas, betas, log_z, g):
    """The backward's sums in the kernels' fixed order. C <= 32 (the
    one-launch kernel): each sequence's partial over its pairs from t = T-2
    down to 0, then the partials added over b in order. Above (the
    marginal pass): per chunk of ``crf_marginal_plan``'s pairs, a partial
    over the chunk's pairs in flat (b-major) order, the partials added in
    chunk order. da and db over b in order; dx elementwise."""
    B, T, C = x.shape
    dx = g[:, None, None] * (torch.exp(alphas + betas - log_z[:, None, None])
                             * mask[:, :, None])
    dtrans = torch.zeros(C, C)
    if C <= 32:
        for bb in range(B):
            acc = torch.zeros(C, C)
            for t in range(T - 2, -1, -1):
                e, w = _pair_term(x, mask, trans, alphas, betas, log_z, g,
                                  bb, t)
                if w != 0:
                    acc = _fma_f32(e, w, acc)
            dtrans = dtrans + acc
    else:
        plan = tcrf.crf_marginal_plan(B, T, C)
        pairs = B * (T - 1)
        for c in range(plan["chunks"]):
            acc = torch.zeros(C, C)
            for q in range(c * plan["chunk_len"],
                           min((c + 1) * plan["chunk_len"], pairs)):
                bb, t = divmod(q, T - 1)
                e, w = _pair_term(x, mask, trans, alphas, betas, log_z, g,
                                  bb, t)
                acc = _fma_f32(e, w, acc)  # a dead pair adds +-0
            dtrans = dtrans + acc
    da = torch.zeros(C)
    db = torch.zeros(C)
    for bb in range(B):
        da = da + g[bb] * (torch.exp(alphas[bb, 0] + betas[bb, 0]
                                     - log_z[bb]) * mask[bb, 0])
        db = db + g[bb] * torch.exp(alphas[bb, -1] + b - log_z[bb])
    return dx, dtrans, da, db


@pytest.mark.parametrize("B,T,C", [(5, 7, 9), (64, 12, 23), (8, 20, 40),
                                   (4, 9, 33)])
def test_marginal_order_holds_the_plain_backward(B, T, C):
    """Both backward layouts' summation orders, as plain code over the
    betas of ``crf_betas_plain`` (the chains' plain version), within the
    gradient tolerance of ``crf_bwd_plain``; forbidden transitions near
    0. At (8, 20, 40) the marginal pass's plan splits the 152 pairs into 5
    chunks; at (64, 12, 23) the one-launch kernel's 64 partials are
    added."""
    x, mask, trans, a, b, g = (torch.from_numpy(v)
                               for v in _inputs(B, T, C, B + T + C))
    mask[-1] = 0.0  # an all-padding row
    alphas, log_z = tcrf.crf_forward_plain(x, mask, trans, a, b)
    betas = tcrf.crf_betas_plain(x, mask, trans, b)
    got = _marginals_in_kernel_order(x, mask, trans, b, alphas, betas,
                                     log_z, g)
    want = tcrf.crf_bwd_plain(x, mask, trans, b, alphas, log_z, g)
    for name, gk, gp in zip(("dx", "dtrans", "da", "db"), got, want):
        _close_per_tensor(gk, gp, name)
    assert abs(float(got[1][0, 1])) < 1e-6
    if (B, T, C) == (8, 20, 40):
        assert tcrf.crf_marginal_plan(B, T, C)["chunks"] == 5


# ----------------------------------------------------------- the floor
@pytest.mark.parametrize("C", [1, 23, 40])
def test_chain_floor_plain_is_the_chains_recursion(C):
    """``chain_floor_plain`` runs the chains' recursions on the floor's
    fixed inputs (every row of the matrix r_j, x_j, the start): the betas
    within 1e-5 relative of a float64 log-sum-exp, the Viterbi's values
    equal to a float64 max-plus (exactly representable here), its last
    back-pointers the first argmax, and its best value
    ``crf_viterbi_plain``'s score on the same chain."""
    T = 40
    r, x, start = (v.double().numpy() for v in tcrf._floor_inputs(C))
    beta, alpha = start.copy(), start.copy()
    for _ in range(T):
        y = x + beta + r
        m = y.max()
        beta = np.full(C, m + np.log(np.exp(y - m).sum()))
        arg = int(np.argmax(alpha))
        alpha = alpha.max() + r + x
    got = tcrf.chain_floor_plain(T, C)
    np.testing.assert_allclose(got.numpy(), beta, rtol=1e-5)
    got_v = tcrf.chain_floor_plain(T, C, "viterbi")
    np.testing.assert_array_equal(got_v[:C].double().numpy(), alpha)
    assert (got_v[C:] == arg).all()
    rf, xf, sf = tcrf._floor_inputs(C)
    xs = torch.cat([sf[None], xf[None].expand(T, C)])[None]
    _, score = tcrf.crf_viterbi_plain(xs, torch.ones(1, T + 1),
                                      rf[None].expand(C, C), torch.zeros(C),
                                      torch.zeros(C))
    assert float(score[0]) == float(got_v[:C].max())


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("C", [1, 23, 32, 33, 256, 257, 1000])
def test_plan_variant_and_shared_memory_at_class_counts(C):
    """A warp a sequence up to C = 32; above, a block whose K lanes share
    each row (column) of the sums (max): K = 2 up to C = 512, then 1 (4 up
    to C = 256 for the backward when it reads exp(trans - max) from L2),
    with 32 ceil(C K / 32) threads, at most 1024. The
    backward's exp(trans - max) sits in shared memory where it fits at a
    row stride = K mod 32 (the K parts of 32 / K rows in 32 banks), else
    per-sequence copies in global memory; the Viterbi's trans at a stride
    = 32 / K mod 32, its back-pointers (a byte each to C = 256, two above)
    in shared memory at T = 80 at every C here; every block within the
    card's 227 KB."""
    T = 80
    plan = tcrf.crf_plan(T, C)
    bwd, vit = plan["bwd"], plan["viterbi"]
    warp = C <= 32
    K = 1 if warp or C > 512 else 2
    assert bwd["variant"] == vit["variant"] == ("warp" if warp else "block")
    assert vit["parts"] == K
    # the backward with exp(trans - max) from L2: 4 lanes a row to C = 256
    Kb = 4 if not warp and C <= 256 and not bwd["matrix_in_smem"] else K
    assert bwd["parts"] == Kb
    threads = (lambda k: 32 * -(-min(C * k, 1024) // 32))
    if warp:  # the one-launch backward: a chain warp and six workers
        assert bwd["threads"] == 256 and vit["threads"] == 128
        assert plan["floor"]["beta_threads"] == 32
    else:
        assert bwd["threads"] == threads(Kb) and vit["threads"] == threads(K)
        assert plan["floor"]["beta_threads"] == threads(Kb)
    assert vit["bp_bytes"] == (1 if C <= 256 else 2)
    assert vit["bp_in_smem"] and vit["scratch_per_row"] == 0
    if warp:
        assert bwd["smem"] == 4 * (C * (C | 1) + 2 * 32 * 32 + 64 + 8)
        assert vit["smem"] == 4 * 4 * 64 + 4 * T * C
        assert bwd["ld"] == C | 1 and vit["ld"] == C
    else:
        ld_e = C + (K - C) % 32
        ld_t = C + (32 // K - C) % 32
        assert ld_e % 32 == K % 32 and ld_t % 32 == (32 // K) % 32
        fits = 4 * 32 + 16 * C + 4 * C * ld_e <= build.SMEM_BYTES
        assert bwd["matrix_in_smem"] == fits
        assert bwd["smem"] == 4 * 32 + 16 * C + (
            4 * C * ld_e if fits else 4 * 8 * 32 * 33)
        assert bwd["ld"] == (ld_e if fits else 0)
        mat = 4 * 64 + 16 * C + 4 * C * ld_t <= build.SMEM_BYTES
        assert vit["matrix_in_smem"] == mat
        assert vit["smem"] == 4 * 64 + 16 * C + (4 * C * ld_t if mat else 0) \
            + T * C * vit["bp_bytes"]
    for p in (bwd, vit, plan["floor"]):
        assert 0 < p["smem"] <= build.SMEM_BYTES
    assert not bwd["giant"] and not vit["giant"]
    B = 64
    m = tcrf.crf_marginal_plan(B, T, C)
    assert m["tj"] == min(C, 32) and m["ti"] == 256 // m["tj"]
    assert m["tiles"] * m["ti"] * m["tj"] >= C * C
    assert m["chunks"] * m["chunk_len"] >= B * (T - 1)
    assert tcrf.bwd_work_floats(B, T, C) == (
        B * C * C + 2 * B * C if warp else
        B * T * C + 2 * B * C + (0 if bwd["matrix_in_smem"] else B * C * C)
        + m["chunks"] * C * C + m["tiles"])
    if C == 23:  # the tagger's: 3 tiles of 11 x 23 entries, 88 chunks
        assert (m["ti"], m["tj"], m["tiles"], m["chunks"]) == (11, 23, 3, 88)


@pytest.mark.parametrize("T,C,spill", [(80, 23, False), (3000, 23, True),
                                       (400, 300, True), (80, 1000, False)])
def test_plan_spills_viterbi_back_pointers_past_the_block(T, C, spill):
    """The back-pointers leave shared memory only where they outgrow it
    (a warp block's four sequences at C = 23, T = 3000; two bytes each at
    C = 300, T = 400): then each sequence gets T C bytes of scratch."""
    vit = tcrf.crf_plan(T, C)["viterbi"]
    assert vit["bp_in_smem"] == (not spill)
    assert vit["scratch_per_row"] == (
        -(-T * C * vit["bp_bytes"] // 16) * 16 if spill else 0)


@pytest.mark.parametrize("C,bwd_giant,vit_giant", [
    (12000, False, False), (12500, True, False), (14600, True, True)])
def test_plan_moves_the_vectors_to_scratch_at_any_class_count(C, bwd_giant,
                                                              vit_giant):
    """Above C ~ 12,400 (the backward: its vectors, the copy of x and the
    transpose tiles) and ~ 14,500 (the Viterbi) the per-class vectors move
    to global scratch, so no C is refused; the scratch sizes grow to
    match."""
    plan = tcrf.crf_plan(3, C)
    assert plan["bwd"]["giant"] == bwd_giant
    assert plan["viterbi"]["giant"] == vit_giant
    assert plan["bwd"]["smem"] <= build.SMEM_BYTES
    assert plan["viterbi"]["smem"] <= build.SMEM_BYTES
    if vit_giant:
        assert plan["viterbi"]["scratch_per_row"] >= 8 * C
    base = 5 * C + tcrf.crf_marginal_plan(1, 3, C)["chunks"] * C * C
    assert tcrf.bwd_work_floats(1, 3, C) >= base + (2 * C if bwd_giant
                                                    else 0)
    with pytest.raises(ValueError, match="C >= 1"):
        tcrf.crf_plan(3, 0)


@pytest.mark.parametrize("C", [1, 23, 40, 257])
def test_chain_floor_plain_alpha_is_the_forward_recursion(C):
    """The floor's alpha variant: T steps of ``crf_forward_plain``'s step
    with trans[i, j] = r_i from alpha_0 = the start, within 1e-5 relative
    of a float64 log-sum-exp (every column the same sum, plus x_j)."""
    T = 40
    r, x, start = (v.double().numpy() for v in tcrf._floor_inputs(C))
    alpha = start.copy()
    for _ in range(T):
        y = alpha + r
        m = y.max()
        alpha = m + np.log(np.exp(y - m).sum()) + x
    got = tcrf.chain_floor_plain(T, C, "alpha")
    np.testing.assert_allclose(got.numpy(), alpha, rtol=1e-5)
    with pytest.raises(ValueError, match="variant"):
        tcrf.chain_floor_plain(T, C, "gamma")


@pytest.mark.parametrize("C", [1, 23, 32, 33, 128, 232, 233, 238, 239, 240,
                               241, 256, 257, 1000, 14600, 29100])
def test_forward_plan_at_class_counts(C):
    """The forward's plan: a warp a sequence up to C = 32 (E [C, C] in
    shared memory beside the four warps' rows and red); above, a block a
    sequence, E at a column stride = 32 / K mod 32 beside the vectors
    alpha and p while it fits: K = 4 lanes a column up to C = 232, then 2
    up to C = 240; above, each block's copy of E in scratch, 4 lanes a
    column up to C = 256, 2 up to 512, then 1; the vectors in scratch too
    above C ~ 29,000. Scratch: none where E stays on chip (the tagger's
    shapes), one C x C copy a sequence (a block of four at C <= 32 with
    ``in_global``) above; ``in_global`` keeps the shared path's K. The
    floor's alpha threads are the forward's."""
    T, B = 80, 16
    plan = tcrf.crf_plan(T, C)
    fwd = plan["fwd"]
    if C <= 32:
        assert fwd["variant"] == "warp" and fwd["threads"] == 128
        assert fwd["smem"] == 4 * (128 + 32 + C * C)
        assert fwd["matrix_in_smem"] and fwd["ld"] == C
        assert plan["floor"]["alpha_threads"] == 32
        assert tcrf.fwd_work_floats(B, C) == 0
        assert tcrf.fwd_work_floats(B, C, True) == -(-B // 4) * C * C
        return
    ld = lambda K: C + (32 // K - C) % 32  # noqa: E731
    for K in (1, 2, 4):
        assert ld(K) % 32 == (32 // K) % 32 and ld(K) >= C
    red, vec = 4 * 32, 8 * C
    fits = lambda K: red + vec + 4 * C * ld(K) <= build.SMEM_BYTES  # noqa
    narrow = 1 if C > 512 else 2
    K = 4 if C <= 256 and fits(4) else narrow
    assert (K == 4) == (C <= 232)
    in_smem = fits(K)
    assert in_smem == (C <= 240)
    assert fwd["variant"] == "block" and fwd["matrix_in_smem"] == in_smem
    Kf = K if in_smem else (4 if C <= 256 else narrow)
    assert fwd["parts"] == Kf
    assert fwd["threads"] == 32 * -(-min(C * Kf, 1024) // 32)
    assert plan["floor"]["alpha_threads"] == fwd["threads"]
    giant = red + vec > build.SMEM_BYTES
    assert fwd["giant"] == giant == (C == 29100)
    assert fwd["ld"] == (ld(K) if in_smem else 0)
    assert fwd["smem"] == red + (0 if giant else vec) + (
        4 * C * ld(K) if in_smem else 0)
    assert 0 < fwd["smem"] <= build.SMEM_BYTES
    assert tcrf.fwd_work_floats(B, C) == (
        0 if in_smem else B * C * C + (2 * B * C if giant else 0))
    forced = tcrf._fwd_plan(C, in_global=True)
    assert forced["parts"] == Kf and not forced["matrix_in_smem"]
    assert tcrf.fwd_work_floats(B, C, True) >= B * C * C
