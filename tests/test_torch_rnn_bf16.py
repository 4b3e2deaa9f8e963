"""The bf16 forms of the LSTM and GRU sequence recurrences and their
reverse chains (``ops/lstm.py``, ``ops/gru.py``), on the CPU, against the
JAX package's bf16 computation.

Under ``compute_dtype=bfloat16`` the reference's Pallas kernels cannot run
(their ``h_new * m`` is f32, stored into a bf16 ref), so the JAX package's
bf16 semantics are its scans ``lstm_sequence_ref`` / ``gru_sequence_ref``
under ``jax.vjp``, which its CPU runs by default; the port's plain bf16
versions are held against those, forward and backward: forward and
reversed, masked tails, a carried h0 / c0, and the mixed call (f32 ``xs``
with bf16 weights, every recurrent layer after the first) against JAX's
promoted scan. Also: the output dtypes (ys f32, the state and residuals
bf16), the chain's kernel arrangement against one block, the float32
forms' arithmetic left as it was, and the bf16 kernel forms taking CUDA
tensors only (the card tests are in ``test_torch_cuda.py``).

Tolerances, per tensor, with ``big`` the largest |entry| of the JAX
result:
- values: bit-equal to JAX's (the same roundings); the mixed call, an
  f32 computation on both sides, |port - JAX| <= 1e-5 * big (read:
  2.5e-7 at most);
- gradients: |port - JAX| <= 2e-2 * big (read: 1.56e-2 at most, the
  mixed call's dW; bf16 keeps 8 bits, the port's chain sums in f32 where
  JAX rounds every operation, and ``dW`` is one f32-accumulated product
  where JAX accumulates it in bf16 step by step);
- and |port_bf16 - f32| <= 2 * |JAX_bf16 - f32| + 1e-3 * max|f32| (max
  norms), the f32 result being JAX's f32 scan: the port is no farther
  from f32 than twice the reference's own bf16 error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import gru as jgru
from paddle_tpu.ops import lstm as jlstm
from paddle_tpu_torch.ops import gru as tgru
from paddle_tpu_torch.ops import lstm as tlstm

BF = torch.bfloat16
B, H, T = 4, 16, 12


def _close(port, ref, f32, scale):
    """The two tolerances of the module note for one tensor."""
    port, ref, f32 = (np.asarray(a, np.float32) for a in (port, ref, f32))
    if not ref.size:
        return
    big = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= scale * big, (err, scale * big)
    own = float(np.abs(ref - f32).max())
    mine = float(np.abs(port - f32).max())
    assert mine <= 2 * own + 1e-3 * float(np.abs(f32).max()), (mine, own)


def _np(t):
    return t.detach().float().numpy()


def _j(a, dt):
    return jnp.asarray(a).astype(dt)


def _mask(case):
    m = np.ones((T, B), np.float32)
    if case in ("masked", "reversed"):
        m[T - 4:, 1] = 0
        m[T // 2:, 2] = 0
        m[1:, 3] = 0
    return m


def _lstm_operands(case, seed=0):
    rng = np.random.default_rng(seed)
    vals = dict(
        xs=rng.normal(size=(T, B, 4 * H)), w=rng.normal(size=(H, 4 * H)) * 0.3,
        gate_bias=rng.normal(size=(4 * H,)) * 0.3,
        check_i=rng.normal(size=(H,)) * 0.3,
        check_f=rng.normal(size=(H,)) * 0.3,
        check_o=rng.normal(size=(H,)) * 0.3,
        h0=rng.normal(size=(B, H)) * 0.3 if case == "carried"
        else np.zeros((B, H)),
        c0=rng.normal(size=(B, H)) * 0.3 if case == "carried"
        else np.zeros((B, H)))
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    cot = dict(dys=rng.normal(size=(T, B, H)), dhT=rng.normal(size=(B, H)),
               dcT=rng.normal(size=(B, H)))
    return vals, {k: v.astype(np.float32) for k, v in cot.items()}


_LSTM_ARGS = ("xs", "w", "gate_bias", "check_i", "check_f", "check_o", "h0",
              "c0")
# the mixed call: f32 xs and state (the layer's zeros follow xs), bf16
# weights
_MIXED_F32 = ("xs", "h0", "c0")


def _dtypes(case, names, jdt, f32):
    return {n: f32 if case == "mixed" and n in _MIXED_F32 else jdt
            for n in names}


def _jax_lstm(vals, cot, mask, dts, reverse):
    def f(*a):
        xs, w, gb, ci, cf, co, h0, c0 = a
        if reverse:
            ys, hT, cT = jlstm.lstm_sequence_ref(
                jnp.flip(xs, 0), jnp.flip(mask, 0), w, gb, ci, cf, co, h0,
                c0)
            return jnp.flip(ys, 0), hT, cT
        return jlstm.lstm_sequence_ref(xs, mask, w, gb, ci, cf, co, h0, c0)

    args = [_j(vals[n], dts[n]) for n in _LSTM_ARGS]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(tuple(_j(c, o.dtype) for c, o in zip(
        (cot["dys"], cot["dhT"], cot["dcT"]), out)))
    return out, grads


@pytest.mark.parametrize("case", ["plain", "reversed", "masked", "carried",
                                  "mixed"])
def test_lstm_bf16_matches_jax_scan_and_vjp(case):
    vals, cot = _lstm_operands(case)
    mask = _mask(case)
    reverse = case == "reversed"
    jdts = _dtypes(case, _LSTM_ARGS, jnp.bfloat16, jnp.float32)
    jout, jgrads = _jax_lstm(vals, cot, jnp.asarray(mask), jdts, reverse)
    fout, fgrads = _jax_lstm(vals, cot, jnp.asarray(mask),
                             {n: jnp.float32 for n in _LSTM_ARGS}, reverse)
    tdts = _dtypes(case, _LSTM_ARGS, BF, torch.float32)
    leaves = [torch.tensor(vals[n]).to(tdts[n]).requires_grad_()
              for n in _LSTM_ARGS]
    out = tlstm.lstm_sequence(leaves[0], torch.tensor(mask), *leaves[1:],
                              reverse=reverse)
    # dtypes as the reference's: ys f32; hT, cT bf16 (f32 when mixed)
    assert out[0].dtype == torch.float32
    state_dt = torch.float32 if case == "mixed" else BF
    assert out[1].dtype == out[2].dtype == state_dt
    for o, j in zip(out, jout):
        assert str(j.dtype) == str(o.dtype).replace("torch.", "")
    torch.autograd.backward(out, [torch.tensor(c).to(o.dtype) for c, o in zip(
        (cot["dys"], cot["dhT"], cot["dcT"]), out)])
    for o, j, f in zip(out, jout, fout):
        _close(_np(o), np.asarray(j, np.float32), np.asarray(f), 1e-5)
    if case != "mixed":  # the same roundings: the forward is bit-equal
        for o, j in zip(out, jout):
            np.testing.assert_array_equal(_np(o), np.asarray(j, np.float32))
    for n, leaf, j, f in zip(_LSTM_ARGS, leaves, jgrads, fgrads):
        assert leaf.grad.dtype == leaf.dtype, n
        _close(_np(leaf.grad), np.asarray(j, np.float32), np.asarray(f),
               2e-2)


def _gru_operands(case, seed=1):
    rng = np.random.default_rng(seed)
    vals = dict(xs=rng.normal(size=(T, B, 3 * H)),
                w=rng.normal(size=(H, 3 * H)) * 0.3,
                bias=rng.normal(size=(3 * H,)) * 0.3,
                h0=rng.normal(size=(B, H)) * 0.3 if case == "carried"
                else np.zeros((B, H)))
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    cot = dict(dys=rng.normal(size=(T, B, H)).astype(np.float32),
               dhT=rng.normal(size=(B, H)).astype(np.float32))
    return vals, cot


_GRU_ARGS = ("xs", "w", "bias", "h0")


def _jax_gru(vals, cot, mask, dts, reverse):
    def f(xs, w, bias, h0):
        wg, ws = w[:, :2 * H], w[:, 2 * H:]
        if reverse:
            ys, hT = jgru.gru_sequence_ref(jnp.flip(xs, 0), jnp.flip(mask, 0),
                                           wg, ws, bias, h0)
            return jnp.flip(ys, 0), hT
        return jgru.gru_sequence_ref(xs, mask, wg, ws, bias, h0)

    out, vjp = jax.vjp(f, *[_j(vals[n], dts[n]) for n in _GRU_ARGS])
    grads = vjp(tuple(_j(c, o.dtype) for c, o in zip(
        (cot["dys"], cot["dhT"]), out)))
    return out, grads


@pytest.mark.parametrize("case", ["plain", "reversed", "masked", "carried",
                                  "mixed"])
def test_gru_bf16_matches_jax_scan_and_vjp(case):
    vals, cot = _gru_operands(case)
    mask = _mask(case)
    reverse = case == "reversed"
    jdts = {n: jnp.float32 if case == "mixed" and n in ("xs", "h0")
            else jnp.bfloat16 for n in _GRU_ARGS}
    jout, jgrads = _jax_gru(vals, cot, jnp.asarray(mask), jdts, reverse)
    fout, fgrads = _jax_gru(vals, cot, jnp.asarray(mask),
                            {n: jnp.float32 for n in _GRU_ARGS}, reverse)
    leaves = [torch.tensor(vals[n]).to(
        torch.float32 if case == "mixed" and n in ("xs", "h0") else BF
    ).requires_grad_() for n in _GRU_ARGS]
    xs, w, bias, h0 = leaves
    out = tgru.gru_sequence(xs, torch.tensor(mask), w[:, :2 * H],
                            w[:, 2 * H:], bias, h0, reverse=reverse)
    assert out[0].dtype == torch.float32
    assert out[1].dtype == (torch.float32 if case == "mixed" else BF)
    torch.autograd.backward(out, [torch.tensor(c).to(o.dtype) for c, o in zip(
        (cot["dys"], cot["dhT"]), out)])
    for o, j, f in zip(out, jout, fout):
        _close(_np(o), np.asarray(j, np.float32), np.asarray(f), 1e-5)
    if case != "mixed":
        for o, j in zip(out, jout):
            np.testing.assert_array_equal(_np(o), np.asarray(j, np.float32))
    for n, leaf, j, f in zip(_GRU_ARGS, leaves, jgrads, fgrads):
        assert leaf.grad.dtype == leaf.dtype, n
        _close(_np(leaf.grad), np.asarray(j, np.float32), np.asarray(f),
               2e-2)


def test_residual_forms_keep_the_reference_dtypes():
    """The residual plain versions (the training forward): ys f32, the
    state chains and the activated gates bf16; the primal form's hT and
    cT bf16."""
    vals, _ = _lstm_operands("carried")
    mask = torch.tensor(_mask("masked"))
    a = {n: torch.tensor(v).to(BF) for n, v in vals.items()}
    ys, hs, cs, gates = tlstm.lstm_sequence_residual_plain(
        a["xs"], mask, a["w"], a["check_i"], a["check_f"], a["check_o"],
        a["h0"], a["c0"], gate_bias=a["gate_bias"])
    assert ys.dtype == torch.float32
    assert hs.dtype == cs.dtype == gates.dtype == BF
    ys2, hT, cT = tlstm.lstm_sequence_plain(
        a["xs"], mask, a["w"], a["check_i"], a["check_f"], a["check_o"],
        a["h0"], a["c0"], gate_bias=a["gate_bias"])
    assert torch.equal(ys, ys2) and torch.equal(hT, hs[-1])
    assert torch.equal(cT, cs[-1]) and hT.dtype == cT.dtype == BF
    g, _ = _gru_operands("carried")
    gt = {n: torch.tensor(v).to(BF) for n, v in g.items()}
    xs_b = gt["xs"] + gt["bias"]
    ys, hs, gates = tgru.gru_sequence_residual_plain(
        xs_b, mask, gt["w"][:, :2 * H], gt["w"][:, 2 * H:], gt["h0"])
    assert ys.dtype == torch.float32 and hs.dtype == gates.dtype == BF


@pytest.mark.parametrize("Bc,Hc", [(4, 64), (2, 40)])
def test_lstm_bf16_chain_kernel_arrangement(Bc, Hc):
    """``lstm_bwd_chain_plain`` over the kernel's blocks (``units`` of the
    H100's plan: the 16 partial products added in order, each block's
    elementwise chain) against one block: the same bf16 rounding points,
    the products summed in another order, so they agree within the
    gradient tolerance and return bf16."""
    rng = np.random.default_rng(3)
    Tc = 6
    f = lambda *s, k=1.0: torch.tensor(rng.normal(size=s) * k,
                                       dtype=torch.float32)
    mask = torch.ones(Tc, Bc)
    mask[3:, 0] = 0
    a = dict(xs=f(Tc, Bc, 4 * Hc).to(BF), w=f(Hc, 4 * Hc, k=0.2).to(BF),
             p=[f(Hc, k=0.3).to(BF) for _ in range(3)],
             h0=f(Bc, Hc, k=0.3).to(BF), c0=f(Bc, Hc, k=0.3).to(BF),
             gb=f(4 * Hc, k=0.3).to(BF))
    _, hs, cs, gates = tlstm.lstm_sequence_residual_plain(
        a["xs"], mask, a["w"], *a["p"], a["h0"], a["c0"], gate_bias=a["gb"])
    dys, dhT, dcT = f(Tc, Bc, Hc), f(Bc, Hc).to(BF), f(Bc, Hc).to(BF)
    units = tlstm.lstm_plan(Bc, Hc)["units"]
    assert units < Hc
    args = (dys, mask, gates, cs, a["c0"], a["w"], *a["p"], dhT, dcT)
    blocked = tlstm.lstm_bwd_chain_plain(*args, units=units)
    whole = tlstm.lstm_bwd_chain_plain(*args)
    for x, y in zip(blocked, whole):
        assert x.dtype == BF
        big = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= 2e-2 * big + 1e-3


def test_gru_bf16_chain_kernel_arrangement():
    """``gru_bwd_chain_plain`` over the H100's unit partition against one
    block: within the gradient tolerance, bf16 results."""
    rng = np.random.default_rng(4)
    Tc, Bc, Hc = 6, 4, 264
    f = lambda *s, k=1.0: torch.tensor(rng.normal(size=s) * k,
                                       dtype=torch.float32)
    mask = torch.ones(Tc, Bc)
    mask[2:, 1] = 0
    w = f(Hc, 3 * Hc, k=0.1).to(BF)
    wg, ws = w[:, :2 * Hc], w[:, 2 * Hc:]
    h0 = f(Bc, Hc, k=0.3).to(BF)
    _, hs, gates = tgru.gru_sequence_residual_plain(
        f(Tc, Bc, 3 * Hc).to(BF), mask, wg, ws, h0)
    units = tgru.gru_plan(Bc, Hc)["units"]
    assert units < Hc
    args = (f(Tc, Bc, Hc), mask, gates, h0, hs, wg, ws, f(Bc, Hc).to(BF))
    for x, y in zip(tgru.gru_bwd_chain_plain(*args, units=units),
                    tgru.gru_bwd_chain_plain(*args)):
        assert x.dtype == BF
        big = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= 2e-2 * big + 1e-3


def test_f32_paths_keep_their_arithmetic():
    """The f32 plain versions are the f32 forms as before: the bf16
    changes (the sigmoid spelling, the rounder, the mixed widening) leave
    float32 calls bit-equal to the f32 cell spelled out."""
    vals, _ = _lstm_operands("carried")
    a = {n: torch.tensor(v) for n, v in vals.items()}
    mask = torch.tensor(_mask("masked"))
    ys, hT, cT = tlstm.lstm_sequence(a["xs"], mask, a["w"], a["gate_bias"],
                                     a["check_i"], a["check_f"],
                                     a["check_o"], a["h0"], a["c0"])
    h, c, out = a["h0"], a["c0"], []
    xs_b = a["xs"] + a["gate_bias"]
    for t in range(T):
        g = xs_b[t] + h @ a["w"]
        gi, gig, gfg, gog = g.chunk(4, dim=-1)
        i = torch.tanh(gi)
        ig = torch.sigmoid(gig + c * a["check_i"])
        fg = torch.sigmoid(gfg + c * a["check_f"])
        cn = i * ig + c * fg
        og = torch.sigmoid(gog + cn * a["check_o"])
        hn = og * torch.tanh(cn)
        m = mask[t].unsqueeze(-1)
        h, c = torch.where(m > 0, hn, h), torch.where(m > 0, cn, c)
        out.append(hn * m)
    assert torch.equal(ys, torch.stack(out))
    assert torch.equal(hT, h) and torch.equal(cT, c)


def test_bf16_kernel_forms_take_cuda_tensors_only():
    """On the CPU the wrappers run the plain bf16 versions; the bf16
    kernel forms themselves refuse a CPU tensor (on the card they launch
    or raise: the per-step LSTM route and the two-launch GRU route, which
    have no bf16 form, raise there)."""
    plan = {"route": "persistent"}
    with pytest.raises(ValueError, match="no kernel for device"):
        tlstm._seq_args("lstm_seq", torch.zeros(2, 1, 16, dtype=BF),
                        *(torch.zeros(1),) * 8, plan)
    with pytest.raises(ValueError, match="no kernel for device"):
        tgru._seq_args("gru_seq", torch.zeros(2, 1, 12, dtype=BF),
                       *(torch.zeros(1),) * 4, plan)
    vals, _ = _lstm_operands("plain")
    a = [torch.tensor(vals[n]).to(BF) for n in _LSTM_ARGS]
    mask = torch.tensor(_mask("plain"))
    before = tlstm.lstm_seq.bf16_launches
    ys, hT, cT = tlstm.lstm_seq(a[0], mask, a[1], *a[3:], gate_bias=a[2])
    assert tlstm.lstm_seq.bf16_launches == before  # the plain version ran
    assert ys.dtype == torch.float32 and hT.dtype == BF
