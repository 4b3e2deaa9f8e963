"""The port's CUDA kernels (the LSTM recurrence in its primal and residual
forms and its backward on both routes (one cooperative launch per
sequence or reverse chain; a launch a step and a per-step backward above
the route line), the LSTM cell, the GRU recurrence in its
primal and residual forms and its backward on both routes (one
cooperative launch per sequence or reverse chain; two launches a step
and a per-step backward above the route line), the GRU cell on both
routes (one launch a step on thread block clusters; two launches), the
Momentum and Adam updates (one kernel launch for a step's list of
parameters), the CRF forward, backward and Viterbi kernels,
the flash-attention forward and backward kernels (the split-row path
above D = 1024 too), the CTC alpha and beta chains in both operand forms
(the wide chains above 16,384 states in both) and the fused posterior pass
(the sorted pass at 60,000 classes too)) against their plain PyTorch versions,
on the card; and the image layers and ResNet-50's three ways, card
against CPU (cuDNN's convolutions with TF32 off). Every test here is marked
``cuda`` and skips where there is no NVIDIA GPU: a CUDA kernel has no CPU
mode. The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-5 for the LSTM and GRU forms (the kernel
sums h @ W in another order than cuBLAS, over K=H and T steps of
recurrence; the gradients per tensor, relative to the tensor's largest
entry); the optimizer kernels' is stated at their test.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import rnn_cells
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops import ctc as tctc
from paddle_tpu_torch.ops import gru as tgru
from paddle_tpu_torch.ops import lstm as tlstm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return (f(T, B, 4 * H), mask, f(H, 4 * H, scale=H ** -0.5),
            f(H, scale=0.1), f(H, scale=0.1), f(H, scale=0.1),
            f(B, H, scale=0.5), f(B, H, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(20, 5, 40), (20, 64, 256), (3, 33, 96)])
def test_lstm_kernel_matches_plain_on_card(cuda_device, T, B, H):
    """Ragged batches, and widths that do not fill a 32 x 32 tile."""
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(T, B, H, seed=B + H)]
    before = tlstm.lstm_seq.launches
    got = tlstm.lstm_seq(*ins)
    torch.cuda.synchronize()
    assert tlstm.lstm_seq.launches == before + 1
    want = tlstm.lstm_sequence_plain(*ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_lstm_kernel_rejects_bad_inputs(cuda_device):
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(4, 2, 8, seed=0)]
    with pytest.raises(ValueError, match="float32"):
        tlstm.lstm_seq(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="shape"):
        tlstm.lstm_seq(ins[0], ins[1][:, :1].contiguous(), *ins[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("per_step", [True, False])
@pytest.mark.parametrize("T,B,H", [(20, 33, 40), (6, 5, 96)])
def test_lstm_residual_forward_and_backward_match_plain_on_card(
        cuda_device, T, B, H, per_step):
    """The residual forward kernel and the backward (the per-step kernel,
    T launches, with ``per_step=True``; else the reverse-chain kernel, one
    launch and no step) against their plain versions on the card, at
    widths that do not fill a tile."""
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(T, B, H, seed=3 * B + H)]
    xs, mask, w, pI, pF, pO, h0, c0 = ins
    before = (tlstm.lstm_seq_train.launches, tlstm.lstm_bwd_step.launches,
              tlstm.lstm_bwd_chain.launches)
    got = tlstm.lstm_seq_train(*ins, per_step=per_step)
    torch.cuda.synchronize()
    want = tlstm.lstm_sequence_residual_plain(*ins)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5)
    rng = np.random.default_rng(B)
    dys, dhT, dcT = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(cuda_device) for s in ((T, B, H), (B, H), (B, H)))
    _, hs, cs, gates = got
    res = (mask, w, pI, pF, pO, h0, c0, hs, cs, gates)
    got_b = tlstm.lstm_backward(*res, dys, dhT, dcT, per_step=per_step)
    torch.cuda.synchronize()
    assert tlstm.lstm_seq_train.launches == before[0] + 1
    if per_step:
        assert tlstm.lstm_bwd_step.launches == before[1] + T
        assert tlstm.lstm_bwd_chain.launches == before[2]
    else:
        assert tlstm.lstm_bwd_step.launches == before[1]
        assert tlstm.lstm_bwd_chain.launches == before[2] + 1
    want_b = tlstm.lstm_backward(*res, dys, dhT, dcT,
                                 step=tlstm.lstm_bwd_step_plain)
    for name, g, w_ in zip(("dxs", "dW", "dpI", "dpF", "dpO", "dh0", "dc0"),
                           got_b, want_b):
        # per tensor: the sums over T*B rows make elementwise rtol
        # meaningless for entries near zero
        err = (g - w_).abs().max().item()
        assert err <= 1e-4 * w_.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1025, 4099])
def test_optimizer_kernels_match_apply_one_on_card(cuda_device, n):
    """Momentum and Adam kernels against ``_apply_one`` on the same card
    tensors, at sizes with a scalar tail. The kernels spell every
    operation with a round-to-nearest intrinsic in the plain chain's
    order, so they agree to the last bit or within 1e-6 relative."""
    from paddle_tpu_torch.kernels import opt_update
    from paddle_tpu_torch.optim import Adam, Momentum
    rng = np.random.default_rng(n)
    p, g, m, v = (torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
                  .to(cuda_device) for _ in range(4))
    v = v.abs()
    mo = Momentum(momentum=0.9)
    before = opt_update.momentum.launches
    got = opt_update.momentum(mo, p, g, {"mom": m}, 0.05, 1e-3)
    assert opt_update.momentum.launches == before + 1
    want = mo._apply_one(p, g, {"mom": m}, 0.05, 1e-3, 0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    ad = Adam()
    got = opt_update.adam(ad, p, g, {"mom": m, "v": v}, 2e-3, 1e-3, 3)
    want = ad._apply_one(p, g, {"mom": m, "v": v}, 2e-3, 1e-3, 3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_training_kernels_reject_bad_inputs(cuda_device):
    from paddle_tpu_torch.kernels import opt_update
    from paddle_tpu_torch.optim import Adam
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(4, 2, 8, seed=0)]
    with pytest.raises(ValueError, match="float32"):
        tlstm.lstm_seq_train(ins[0].double(), *ins[1:])
    xs_nc = ins[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tlstm.lstm_seq_train(xs_nc, *ins[1:])
    B, H = 2, 8
    z = torch.zeros(B, H, device=cuda_device)
    step = [z, torch.ones(B, device=cuda_device),
            torch.zeros(B, 4 * H, device=cuda_device), z, z,
            *(torch.zeros(H, device=cuda_device) for _ in range(3)),
            z, z.clone(), z.clone(), torch.zeros(B, 4 * H,
                                                 device=cuda_device)]
    with pytest.raises(ValueError, match="float32"):
        tlstm.lstm_bwd_step(step[0].double(), *step[1:])
    p = torch.zeros(6, 4, device=cuda_device)
    slots = {"mom": torch.zeros_like(p), "v": torch.zeros_like(p)}
    with pytest.raises(ValueError, match="float32"):
        opt_update.adam(Adam(), p.double(), p.double(), slots, 0.1, 0.0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        opt_update.adam(Adam(), p.t(), p.t(), slots, 0.1, 0.0, 1)


def _opt_group(shapes, seed, device, offset=0):
    """Updates for ``apply_group``: (p, g, {"mom", "v"}, lr, decay) a
    tensor, each with its own lr and decay; with ``offset`` every tensor
    a view at that storage offset (off the 16-byte grid)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i, shape in enumerate(shapes):
        n = int(np.prod(shape))
        p, gr, m, v = (torch.randn(n + offset, generator=g, device=device)[
            offset:].view(shape) for _ in range(4))
        out.append((p, gr, {"mom": m, "v": v.abs()}, 2e-3 * (1 + i % 3),
                    1e-3 * (i % 2)))
    return out


def _for_kind(entries, kind):
    if kind == "adam":
        return entries
    return [(p, g, {"mom": s["mom"]}, lr, d) for p, g, s, lr, d in entries]


def _opt_of(kind):
    from paddle_tpu_torch.optim import Adam, Momentum
    return Adam() if kind == "adam" else Momentum(momentum=0.9)


def _path_lists():
    """{path: [parameter shapes]} of every path that trains on the card
    (``chip_smoke.path_param_shapes``, run from the repository's root)."""
    import chip_smoke
    return chip_smoke.path_param_shapes()


def _opt_group_cases():
    rng = np.random.default_rng(1)
    return dict(misaligned=([(7,), (1,), (1025,), (6778, 128)], 1),
                overflow=([(int(n),) for n in rng.integers(1, 5000,
                                                           size=1000)], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "momentum"])
@pytest.mark.parametrize("where", [
    "classifier", "seq2seq", "seq2seq_attention", "tagger", "acoustic",
    "lstm_decoder", "misaligned", "overflow"])
def test_grouped_optimizer_kernels_equal_apply_one_on_card(cuda_device,
                                                           kind, where):
    """One grouped update at each path's parameter list, a list of views
    at storage offset 1 and a list of 1000 tensors (three tables): every
    output bit-equal to ``_apply_one`` per tensor (the kernels take its
    roundings), two runs bit-equal, the inputs unchanged, one launch per
    table, and ``_apply_one`` never called for the list."""
    from paddle_tpu_torch.kernels import opt_update
    if where in ("misaligned", "overflow"):
        shapes, offset = _opt_group_cases()[where]
    else:
        shapes, offset = _path_lists()[where], 0
    opt = _opt_of(kind)
    entries = _for_kind(_opt_group(shapes, len(shapes), cuda_device, offset),
                        kind)
    want = [opt._apply_one(p, g, s, lr, d, 3) for p, g, s, lr, d in entries]
    before = [[t.clone() for t in (p, g, *s.values())]
              for p, g, s, _, _ in entries]

    def refuse(*args):
        raise AssertionError("_apply_one ran for an eligible CUDA list")

    counter = getattr(opt_update, kind)
    n0 = counter.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(opt), "_apply_one", refuse)
        got = opt_update.apply_group(opt, entries, 3)
        again = opt_update.apply_group(opt, entries, 3)
    torch.cuda.synchronize()
    tables = -(-len(entries) // opt_update.table_capacity())
    assert counter.launches - n0 == 2 * tables
    for (p2, s2), (p3, s3), (wp, ws) in zip(got, again, want):
        assert torch.equal(p2, wp) and torch.equal(p2, p3)
        assert p2.is_contiguous() and p2.shape == wp.shape
        for k in ws:
            assert torch.equal(s2[k], ws[k]) and torch.equal(s2[k], s3[k])
    for (p, g, s, _, _), b in zip(entries, before):
        for t, t0 in zip((p, g, *s.values()), b):
            assert torch.equal(t, t0)


def _table_case(case, cap):
    """(shapes, storage offset) of a coverage case: one size; views at
    offset 1 (scalar moves); 1000 tensors (three tables); a first table
    of empty tensors (no launch) before a second that holds elements."""
    if case == "offset":
        return [(7,), (1025,), (4097,), (1,)], 1
    if case == "overflow":
        rng = np.random.default_rng(3)
        return [(int(n),) for n in rng.integers(1, 5000, size=1000)], 0
    if case == "empty_table":
        return [(0,)] * cap + [(5,), (4096,)], 0
    return [(int(case),)], 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "momentum"])
@pytest.mark.parametrize("case", ["1", "7", "1025", "4096", "4097",
                                  "15360000", "offset", "overflow",
                                  "empty_table"])
def test_grouped_optimizer_kernels_write_every_element_on_card(
        cuda_device, kind, case):
    """The C entry's tables and the kernel's chunk walk: ``launch`` into
    outputs filled with NaN writes every element of every output, each
    bit-equal to ``_apply_one``, with one launch per table of
    ``table_capacity()`` tensors that holds elements."""
    from paddle_tpu_torch.kernels import opt_update
    cap = opt_update.table_capacity()
    shapes, offset = _table_case(case, cap)
    opt = _opt_of(kind)
    entries = _for_kind(_opt_group(shapes, 7, cuda_device, offset), kind)
    ins = [[p, g, *s.values()] for p, g, s, _, _ in entries]
    outs = [[torch.full_like(row[0], float("nan")) for _ in row[1:]]
            for row in ins]
    rates = [opt.alpha(lr, 3) if kind == "adam" else lr
             for _, _, _, lr, _ in entries]
    counter = getattr(opt_update, kind)
    n0 = counter.launches
    opt_update.launch(opt, kind, ins, outs, rates, [e[4] for e in entries])
    torch.cuda.synchronize()
    tables = sum(any(int(np.prod(sh)) for sh in shapes[lo:lo + cap])
                 for lo in range(0, len(shapes), cap))
    assert counter.launches - n0 == tables
    for (p, g, s, lr, d), o in zip(entries, outs):
        want_p, want_s = opt._apply_one(p, g, s, lr, d, 3)
        for got, want in zip(o, (want_p, *want_s.values())):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_optimizer_update_is_one_launch_a_step_on_card(cuda_device):
    """``Optimizer.update`` on the card: one Adam launch a step for every
    parameter (per-parameter lr, an l1 override, a prune mask), the same
    numbers as the update on the CPU (rtol 1e-6 / atol 1e-7: CPU torch's
    vectorised sqrt and division may round otherwise)."""
    from paddle_tpu_torch.core.registry import ParamSpec
    from paddle_tpu_torch.kernels import opt_update
    from paddle_tpu_torch.optim import Adam
    rng = np.random.default_rng(2)
    shapes = {"w": (64, 33), "b": (33,), "emb": (100, 16)}
    meta = {"w": ParamSpec(shape=(64, 33), learning_rate=0.5),
            "b": ParamSpec(shape=(33,), l1_rate=1e-3),
            "emb": ParamSpec(shape=(100, 16), sparsity_ratio=0.5)}
    start = {n: rng.normal(size=s).astype(np.float32)
             for n, s in shapes.items()}
    steps = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    results = []
    for dev in ("cpu", cuda_device):
        opt = Adam(learning_rate=0.01, l2_rate=1e-3)
        params = {n: torch.from_numpy(v).to(dev) for n, v in start.items()}
        state = opt.init(params, meta)
        params = opt.prune_params(params, state)
        n0 = opt_update.adam.launches
        for step in steps:
            grads = {n: torch.from_numpy(g).to(dev) for n, g in step.items()}
            params, state = opt.update(grads, state, params, meta)
        if dev != "cpu":
            assert opt_update.adam.launches - n0 == 3
        results.append({n: p.cpu() for n, p in params.items()})
    for n in shapes:
        torch.testing.assert_close(results[1][n], results[0][n], rtol=1e-6,
                                   atol=1e-7)


def _gru_inputs(T, B, H, seed, device):
    """xs [T,B,3H] (bias folded), a ragged mask, the two column slices of
    one w0 [H,3H] (non-contiguous views, as the layers pass them), h0."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.normal(size=s) * scale).astype(np.float32)).to(device)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = torch.from_numpy(
        (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(device)
    w0 = f(H, 3 * H, scale=H ** -0.5)
    return f(T, B, 3 * H), mask, w0[:, :2 * H], w0[:, 2 * H:], f(B, H,
                                                                   scale=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(20, 5, 40), (12, 50, 96), (3, 33, 64)])
def test_gru_kernels_match_plain_on_card(cuda_device, T, B, H):
    """Primal and residual GRU forward through non-contiguous w0 slices,
    ragged batches, widths that do not fill a tile; the backward step
    kernels against the plain step; then the whole backward through
    ``GruFunction`` in both directions against autograd of the plain
    loop."""
    xs, mask, wg, ws, h0 = _gru_inputs(T, B, H, B + H, cuda_device)
    assert not wg.is_contiguous() and not ws.is_contiguous()
    before = (tgru.gru_seq.launches, tgru.gru_seq_train.launches)
    got = tgru.gru_seq(xs, mask, wg, ws, h0)
    got_r = tgru.gru_seq_train(xs, mask, wg, ws, h0)
    torch.cuda.synchronize()
    assert (tgru.gru_seq.launches, tgru.gru_seq_train.launches) == (
        before[0] + 1, before[1] + 1)
    want = tgru.gru_sequence_plain(xs, mask, wg, ws, h0)
    want_r = tgru.gru_sequence_residual_plain(xs, mask, wg, ws, h0)
    for g, w in zip(list(got) + list(got_r), list(want) + list(want_r)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    _, hs, gates = got_r
    dys, dhT = torch.randn_like(hs), torch.randn_like(h0)
    # these shapes take the persistent route: one chain launch, no step
    before_b = (tgru.gru_bwd_step.launches, tgru.gru_bwd_chain.launches)
    got_b = tgru.gru_backward(mask, wg, ws, h0, hs, gates, dys, dhT)
    torch.cuda.synchronize()
    assert (tgru.gru_bwd_step.launches,
            tgru.gru_bwd_chain.launches) == (before_b[0], before_b[1] + 1)
    want_b = tgru.gru_backward(mask, wg, ws, h0, hs, gates, dys, dhT,
                               step=tgru.gru_bwd_step_plain)
    for name, g, w in zip(("dxs", "dWg", "dWs", "dh0"), got_b, want_b):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)
    bias = torch.zeros(3 * H, device=cuda_device)
    for reverse in (False, True):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (xs, wg, ws, h0)]
        ys, hT = tgru.gru_sequence(leaves[0], mask, leaves[1], leaves[2],
                                   bias, leaves[3], reverse=reverse)
        dys = torch.randn_like(ys)
        got_g = torch.autograd.grad((ys * dys).sum() + hT.sum(), leaves)
        plain = [t.detach().clone().requires_grad_(True)
                 for t in (xs, wg, ws, h0)]
        xs_p, m_p = ((plain[0].flip(0), mask.flip(0)) if reverse
                     else (plain[0], mask))
        ys_p, hT_p = tgru.gru_sequence_plain(xs_p, m_p, plain[1], plain[2],
                                             plain[3])
        ys_p = ys_p.flip(0) if reverse else ys_p
        torch.testing.assert_close(ys, ys_p, rtol=1e-4, atol=1e-5)
        want_g = torch.autograd.grad((ys_p * dys).sum() + hT_p.sum(), plain)
        for name, g, w in zip(("dxs", "dWg", "dWs", "dh0"), got_g, want_g):
            err = (g - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 512), (50, 96), (7, 40)])
def test_gru_cell_kernel_matches_plain_on_card(cuda_device, B, H):
    """The cell's kernel forward (training and inference entries) and its
    recompute backward, through non-contiguous w0 slices."""
    _, _, wg, ws, h = _gru_inputs(1, B, H, 7 * B + H, cuda_device)
    x = torch.randn(B, 3 * H, device=cuda_device)
    before = (rnn_cells.gru_cell.launches, rnn_cells.gru_cell_infer.launches)
    out_i = rnn_cells.gru_cell_infer(x, h, wg, ws)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, h, wg, ws)]
    out = rnn_cells.gru_cell(*leaves)
    torch.cuda.synchronize()
    assert (rnn_cells.gru_cell.launches,
            rnn_cells.gru_cell_infer.launches) == (before[0] + 1,
                                                   before[1] + 1)
    plain = [t.detach().clone().requires_grad_(True) for t in (x, h, wg, ws)]
    want = rnn_cells.gru_cell_plain(*plain)
    torch.testing.assert_close(out_i, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    dout = torch.randn_like(out)
    for g, w in zip(torch.autograd.grad(out, leaves, dout),
                    torch.autograd.grad(want, plain, dout)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() \
            + 1e-5


# (B, H): the paths' cells (seq2seq's batch, the beam search's 32 and 4
# rows, batch 1), ragged units and rows, the largest tile, and shapes off
# the cluster route (H % 4 != 0; a block of one row above the shared
# memory)
GRU_CELL_SHAPES = [(50, 512), (32, 512), (4, 512), (1, 512), (7, 40),
                   (50, 96), (200, 512), (5, 130), (2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("two_launch", [False, True])
@pytest.mark.parametrize("B,H", GRU_CELL_SHAPES)
def test_gru_cell_routes_match_plain_on_card(cuda_device, B, H, two_launch):
    """Each route at each shape (the cluster route where ``gru_cell_plan``
    puts the shape, two launches where forced or off the route): both
    entries against the plain math through non-contiguous w0 slices, one
    device launch a call on the cluster route and two on the other, two
    runs bit-equal, the recompute backward against autograd of the plain
    math."""
    _, _, wg, ws, h = _gru_inputs(1, B, H, 3 * B + H, cuda_device)
    x = torch.randn(B, 3 * H, device=cuda_device)
    steps = 2 if two_launch or rnn_cells.gru_cell_route(B, H) == \
        rnn_cells.TWO_LAUNCH else 1
    before = [(f.launches, f.step_launches)
              for f in (rnn_cells.gru_cell, rnn_cells.gru_cell_infer)]
    with torch.no_grad():
        out_i = rnn_cells.gru_cell_infer(x, h, wg, ws, two_launch=two_launch)
        out_2 = rnn_cells.gru_cell_infer(x, h, wg, ws, two_launch=two_launch)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, h, wg, ws)]
    out = rnn_cells.gru_cell(*leaves, two_launch=two_launch)
    torch.cuda.synchronize()
    after = [(f.launches, f.step_launches)
             for f in (rnn_cells.gru_cell, rnn_cells.gru_cell_infer)]
    assert after == [(before[0][0] + 1, before[0][1] + steps),
                     (before[1][0] + 2, before[1][1] + 2 * steps)]
    assert torch.equal(out_i, out_2)
    plain = [t.detach().clone().requires_grad_(True) for t in (x, h, wg, ws)]
    want = rnn_cells.gru_cell_plain(*plain)
    torch.testing.assert_close(out_i, want.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out.detach(), want.detach(), rtol=1e-4,
                               atol=1e-5)
    dout = torch.randn_like(out)
    for g, w in zip(torch.autograd.grad(out, leaves, dout),
                    torch.autograd.grad(want, plain, dout)):
        assert _max_err_ok(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(50, 512), (32, 512), (4, 512), (1, 512),
                                 (7, 40), (50, 96), (200, 512), (1, 528)])
def test_gru_cell_plan_matches_the_kernel_smem_on_card(cuda_device, B, H):
    """The plan's shared-memory arithmetic equals the kernel's own, and
    the card places at least one cluster of it."""
    plan = rnn_cells._card_plan(B, H, torch.cuda.current_device())
    assert plan["route"] == rnn_cells.CLUSTER
    assert rnn_cells.gru_cell_smem_of_kernel(
        H, plan["cluster"], plan["rows"]) == plan["smem"] <= \
        rnn_cells.SMEM_BYTES
    assert rnn_cells.gru_cell_max_clusters(
        H, plan["cluster"], plan["rows"]) >= 1


@pytest.mark.cuda
def test_gru_cell_kernel_rejects_bad_inputs(cuda_device):
    """A CPU tensor beside CUDA ones, a wrong dtype, a wrong shape and a
    transposed weight raise on both entries and both routes."""
    _, _, wg, ws, h = _gru_inputs(1, 3, 8, 0, cuda_device)
    x = torch.randn(3, 24, device=cuda_device)
    for entry in (rnn_cells.gru_cell, rnn_cells.gru_cell_infer):
        for two_launch in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                entry(x, h.cpu(), wg, ws, two_launch=two_launch)
            with pytest.raises(ValueError, match="float32"):
                entry(x.double(), h, wg, ws, two_launch=two_launch)
            with pytest.raises(ValueError, match="shape"):
                entry(x[:, :21], h, wg, ws, two_launch=two_launch)
            with pytest.raises(ValueError, match="contiguous columns"):
                entry(x, h, wg, ws.t(), two_launch=two_launch)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(32, 512), (50, 512), (1, 512), (7, 40)])
def test_lstm_cell_kernel_matches_plain_on_card(cuda_device, B, H):
    """The LSTM cell kernel (training and inference entries) against
    ``lstm_cell_plain`` with nonzero peepholes, h and c within rtol 1e-4 /
    atol 1e-5; the recompute backward of ``LstmCellFunction`` against
    autograd of the plain version; one launch counted per call."""
    g = torch.Generator(device=cuda_device).manual_seed(B + H)
    gates = torch.randn(B, 4 * H, generator=g, device=cuda_device)
    c_prev = torch.randn(B, H, generator=g, device=cuda_device)
    checks = [0.5 * torch.randn(H, generator=g, device=cuda_device)
              for _ in range(3)]
    ins = [gates, c_prev, *checks]
    before = (rnn_cells.lstm_cell.launches,
              rnn_cells.lstm_cell_infer.launches)
    with torch.no_grad():
        h_i, c_i = rnn_cells.lstm_cell_infer(*ins)
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    h, c = rnn_cells.lstm_cell(*leaves)
    torch.cuda.synchronize()
    assert (rnn_cells.lstm_cell.launches,
            rnn_cells.lstm_cell_infer.launches) == (before[0] + 1,
                                                    before[1] + 1)
    plain = [t.detach().clone().requires_grad_(True) for t in ins]
    w_h, w_c = rnn_cells.lstm_cell_plain(*plain)
    for got, want in ((h_i, w_h), (c_i, w_c), (h, w_h), (c, w_c)):
        torch.testing.assert_close(got, want.detach(), rtol=1e-4,
                                   atol=1e-5)
    dh, dc = torch.randn_like(h), torch.randn_like(c)
    for got, want in zip(torch.autograd.grad((h, c), leaves, (dh, dc)),
                         torch.autograd.grad((w_h, w_c), plain, (dh, dc))):
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.cuda
def test_lstm_cell_kernel_rejects_bad_inputs(cuda_device):
    """A CPU tensor beside CUDA ones, a wrong dtype and a peephole of
    another width raise."""
    gates = torch.randn(3, 16, device=cuda_device)
    c_prev = torch.randn(3, 4, device=cuda_device)
    p = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        rnn_cells.lstm_cell_infer(gates, c_prev.cpu(), p, p, p)
    with pytest.raises(ValueError, match="float32"):
        rnn_cells.lstm_cell_infer(gates.double(), c_prev, p, p, p)
    with pytest.raises(ValueError, match="shape"):
        rnn_cells.lstm_cell_infer(gates, c_prev, p[:3], p, p)


@pytest.mark.cuda
def test_lstm_step_beam_search_runs_the_cell_kernel_on_card(cuda_device):
    """An LSTM-step decoder's beam search on the card launches
    ``lstm_cell_infer`` and answers the CPU plain path's beams (tokens
    equal, scores within 1e-4 relative)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.generation import SequenceGenerator
    from paddle_tpu_torch.core.network import Network
    V, E, H = 50, 16, 32
    dsl.reset()
    src = dsl.data("src", size=H)
    boot = dsl.fc(src, size=H, act="tanh", name="boot")

    def step(prev_emb):
        h = dsl.memory(name="h", size=H, boot_layer=boot)
        c = dsl.memory(name="cst", size=H)
        gates = dsl.fc([prev_emb, h], size=4 * H, act="linear",
                       name="gates")
        out = dsl.lstm_step_layer(gates, c, name="h")
        dsl.get_output_layer(out, arg_name="state", size=H, name="cst")
        return dsl.fc(out, size=V, act="softmax", name="prob")

    dsl.beam_search(step, [dsl.GeneratedInput(
        size=V, embedding_name="emb", embedding_size=E)], bos_id=0,
        eos_id=1, beam_size=4, max_length=12, name="gen")
    graph = dsl.current_graph()
    rng = np.random.default_rng(0)
    specs = Network(graph, outputs=["gen"]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.5).astype(np.float32)
              for k, s in specs.items()}
    params["emb"] = rng.normal(size=(V, E)).astype(np.float32)
    srcv = rng.normal(size=(5, H)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        outer = Network(graph, outputs=["boot"]).apply(
            p, {"src": Argument(torch.from_numpy(srcv).to(dev))})
        before = rnn_cells.lstm_cell_infer.launches
        out[str(dev)] = [t.cpu() for t in SequenceGenerator(
            graph, "gen").generate(p, outer)]
        launched = rnn_cells.lstm_cell_infer.launches - before
        assert (launched > 0) == (str(dev) != "cpu")
    got, want = out[str(cuda_device)], out["cpu"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_gru_kernels_reject_bad_weights(cuda_device):
    """A transposed weight (columns not contiguous) or a weight of another
    shape raises instead of reading the wrong numbers."""
    xs, mask, wg, ws, h0 = _gru_inputs(4, 3, 8, 0, cuda_device)
    with pytest.raises(ValueError, match="contiguous columns"):
        tgru.gru_seq(xs, mask, wg, ws.t(), h0)
    with pytest.raises(ValueError, match="shape"):
        tgru.gru_seq_train(xs, mask, wg[:, :8], ws, h0)
    with pytest.raises(ValueError, match="contiguous columns"):
        rnn_cells.gru_cell_infer(xs[0], h0, wg, ws.t())
    with pytest.raises(ValueError, match="float32"):
        tgru.gru_seq(xs.double(), mask, wg, ws, h0)
    for two_launch in (False, True):
        with pytest.raises(ValueError, match="contiguous columns"):
            tgru.gru_seq_train(xs, mask, wg, ws.t(), h0,
                               two_launch=two_launch)
    _, hs, gates = tgru.gru_seq_train(xs, mask, wg, ws, h0)
    with pytest.raises(ValueError, match="contiguous columns"):
        tgru.gru_bwd_chain(torch.zeros_like(hs), mask, gates, h0, hs,
                           wg.t().contiguous().t(), ws, h0)
    with pytest.raises(ValueError, match="shape"):
        tgru.gru_bwd_chain(torch.zeros_like(hs), mask, gates, h0, hs, wg,
                           ws[:, :4], h0)


# (T, B, H): the seq2seq path's, the acoustic model's, batch 1, one step
# of one row, and an H above the route line (two-launch only)
GRU_ROUTE_SHAPES = [(50, 50, 512), (400, 16, 1024), (50, 1, 512),
                    (1, 1, 512), (3, 2, 1600)]


def _max_err_ok(got, want):
    return (got - want).abs().max().item() <= \
        1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", GRU_ROUTE_SHAPES)
def test_gru_routes_match_plain_on_card(cuda_device, T, B, H):
    """Both routes at the paths' shapes: the primal and residual forward
    against the plain loops, the backward (the chain on the persistent
    route, the per-step kernels on the other) against the plain step
    loop, two backward runs bit-equal, the launch counters, and every
    gradient through ``gru_sequence`` in both directions against autograd
    of the plain loop."""
    xs, mask, wg, ws, h0 = _gru_inputs(T, B, H, 5 * B + H + T, cuda_device)
    persistent = tgru.gru_route(B, H, tgru.device_sms(xs)) == \
        tgru.PERSISTENT
    assert persistent == (H != 1600)
    want = tgru.gru_sequence_plain(xs, mask, wg, ws, h0)
    want_r = tgru.gru_sequence_residual_plain(xs, mask, wg, ws, h0)
    rng = np.random.default_rng(T + B)
    dys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(
        np.float32)).to(cuda_device)
    dhT = torch.from_numpy(rng.normal(size=(B, H)).astype(
        np.float32)).to(cuda_device)
    for two_launch in (False, True):
        c0 = {f"{k}.{a}": getattr(f, a) for k, f in (
            ("seq", tgru.gru_seq), ("train", tgru.gru_seq_train),
            ("chain", tgru.gru_bwd_chain), ("step", tgru.gru_bwd_step))
            for a in ("launches", "step_launches")}
        got = tgru.gru_seq(xs, mask, wg, ws, h0, two_launch=two_launch)
        got_r = tgru.gru_seq_train(xs, mask, wg, ws, h0,
                                   two_launch=two_launch)
        _, hs, gates = got_r
        res = (mask, wg, ws, h0, hs, gates, dys, dhT)
        got_b = tgru.gru_backward(*res, two_launch=two_launch)
        again = tgru.gru_backward(*res, two_launch=two_launch)
        torch.cuda.synchronize()
        on_chain = persistent and not two_launch
        launches = 1 if on_chain else 2 * T
        assert tgru.gru_seq.launches == c0["seq.launches"] + 1
        assert tgru.gru_seq.step_launches == c0["seq.step_launches"] \
            + launches
        assert tgru.gru_seq_train.step_launches == \
            c0["train.step_launches"] + launches
        assert tgru.gru_bwd_chain.launches == c0["chain.launches"] + (
            2 if on_chain else 0)
        assert tgru.gru_bwd_step.launches == c0["step.launches"] + (
            0 if on_chain else 2 * T)
        for g, w in zip(list(got) + list(got_r), list(want) + list(want_r)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        want_b = tgru.gru_backward(*res, step=tgru.gru_bwd_step_plain)
        for name, g, g2, w in zip(("dxs", "dWg", "dWs", "dh0"), got_b,
                                  again, want_b):
            if on_chain:  # one launch, fixed sums, no atomics
                assert torch.equal(g, g2), name
            assert _max_err_ok(g, w), (name, two_launch)
    if T * B * H > 50 * 50 * 512:
        return  # the autograd reference below is a host loop of T steps
    bias = torch.zeros(3 * H, device=cuda_device)
    for reverse in (False, True):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (xs, wg, ws, h0)]
        ys, hT = tgru.gru_sequence(leaves[0], mask, leaves[1], leaves[2],
                                   bias, leaves[3], reverse=reverse)
        got_g = torch.autograd.grad((ys * dys).sum() + (hT * dhT).sum(),
                                    leaves)
        plain = [t.detach().clone().requires_grad_(True)
                 for t in (xs, wg, ws, h0)]
        xs_p, m_p = ((plain[0].flip(0), mask.flip(0)) if reverse
                     else (plain[0], mask))
        ys_p, hT_p = tgru.gru_sequence_plain(xs_p, m_p, plain[1], plain[2],
                                             plain[3])
        ys_p = ys_p.flip(0) if reverse else ys_p
        torch.testing.assert_close(ys, ys_p, rtol=1e-4, atol=1e-5)
        want_g = torch.autograd.grad((ys_p * dys).sum()
                                     + (hT_p * dhT).sum(), plain)
        for name, g, w in zip(("dxs", "dWg", "dWs", "dh0"), got_g, want_g):
            assert _max_err_ok(g, w), (name, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(50, 512), (16, 1024), (1, 512), (64, 256),
                                 (16, 1452), (5, 40)])
def test_gru_plan_matches_the_kernel_smem_on_card(cuda_device, B, H):
    """The route's shared-memory arithmetic equals the kernel's own."""
    plan = tgru.gru_plan(B, H)
    for kind, backward in (("fwd", False), ("bwd", True)):
        assert tgru.persistent_smem_of_kernel(
            B, H, plan["units"], plan[f"chunk_{kind}"], backward) == \
            plan[f"smem_{kind}"] <= tgru.SMEM_BYTES


@pytest.mark.cuda
def test_gru_persistent_launch_that_does_not_fit_raises(cuda_device):
    """A plan whose grid cannot be co-resident (one unit a block at
    H = 4096) is refused with the reason, not run."""
    T, B, H = 2, 2, 4096
    xs, mask, wg, ws, h0 = _gru_inputs(T, B, H, 1, cuda_device)
    ys = torch.empty(T, B, H, device=cuda_device)
    h = torch.empty(2, B, H, device=cuda_device)
    plan = dict(units=1, chunk_fwd=64)
    with pytest.raises(RuntimeError, match="does not fit on the card"):
        tgru._forward_persistent("gru_seq", plan, xs, mask, wg, ws, h0,
                                 wg.stride(0), ws.stride(0), h, ys, None,
                                 None)


# (T, B, H): the tagger's width, the classifier's at 8 steps, batch 1,
# one step, and an H above the route line (per-step only)
LSTM_ROUTE_SHAPES = [(12, 5, 40), (10, 64, 128), (8, 64, 1280),
                     (6, 1, 1280), (1, 3, 96), (3, 2, 1400)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", LSTM_ROUTE_SHAPES)
def test_lstm_routes_match_plain_on_card(cuda_device, T, B, H):
    """Both routes at one shape: the primal and residual forward against
    the plain loops, the backward (the chain on the persistent route, the
    per-step kernel on the other) against the plain step loop, two chain
    runs bit-equal, the launch counters, and every gradient through
    ``lstm_sequence`` in both directions against autograd of the plain
    loop."""
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(T, B, H, seed=5 * B + H + T)]
    xs, mask, w, pI, pF, pO, h0, c0 = ins
    persistent = tlstm.lstm_route(B, H, tlstm.device_sms(xs)) == \
        tlstm.PERSISTENT
    assert persistent == (H != 1400)
    want = tlstm.lstm_sequence_plain(*ins)
    want_r = tlstm.lstm_sequence_residual_plain(*ins)
    rng = np.random.default_rng(T + B)
    dys, dhT, dcT = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(cuda_device) for s in ((T, B, H), (B, H), (B, H)))
    for per_step in (False, True):
        c0_ = {f"{k}.{a}": getattr(f, a, 0) for k, f in (
            ("seq", tlstm.lstm_seq), ("train", tlstm.lstm_seq_train),
            ("chain", tlstm.lstm_bwd_chain), ("step", tlstm.lstm_bwd_step))
            for a in ("launches", "step_launches")}
        got = tlstm.lstm_seq(*ins, per_step=per_step)
        got_r = tlstm.lstm_seq_train(*ins, per_step=per_step)
        _, hs, cs, gates = got_r
        res = (mask, w, pI, pF, pO, h0, c0, hs, cs, gates, dys, dhT, dcT)
        got_b = tlstm.lstm_backward(*res, per_step=per_step)
        again = tlstm.lstm_backward(*res, per_step=per_step)
        torch.cuda.synchronize()
        on_chain = persistent and not per_step
        launches = 1 if on_chain else T
        assert tlstm.lstm_seq.launches == c0_["seq.launches"] + 1
        assert tlstm.lstm_seq.step_launches == c0_["seq.step_launches"] \
            + launches
        assert tlstm.lstm_seq_train.step_launches == \
            c0_["train.step_launches"] + launches
        assert tlstm.lstm_bwd_chain.launches == c0_["chain.launches"] + (
            2 if on_chain else 0)
        assert tlstm.lstm_bwd_step.launches == c0_["step.launches"] + (
            0 if on_chain else 2 * T)
        for g, w_ in zip(list(got) + list(got_r), list(want) + list(want_r)):
            torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5)
        want_b = tlstm.lstm_backward(*res, step=tlstm.lstm_bwd_step_plain)
        for name, g, g2, w_ in zip(("dxs", "dW", "dpI", "dpF", "dpO", "dh0",
                                    "dc0"), got_b, again, want_b):
            if on_chain:  # one launch, fixed sums, no atomics
                assert torch.equal(g, g2), name
            assert _max_err_ok(g, w_), (name, per_step)
    names = ("xs", "w", "pI", "pF", "pO", "h0", "c0")
    bias = torch.zeros(4 * H, device=cuda_device)
    for reverse in (False, True):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (xs, w, pI, pF, pO, h0, c0)]
        ys, hT, cT = tlstm.lstm_sequence(leaves[0], mask, leaves[1], bias,
                                         *leaves[2:], reverse=reverse)
        got_g = torch.autograd.grad((ys * dys).sum() + (hT * dhT).sum()
                                    + (cT * dcT).sum(), leaves)
        plain = [t.detach().clone().requires_grad_(True)
                 for t in (xs, w, pI, pF, pO, h0, c0)]
        xs_p, m_p = ((plain[0].flip(0), mask.flip(0)) if reverse
                     else (plain[0], mask))
        ys_p, hT_p, cT_p = tlstm.lstm_sequence_plain(xs_p, m_p, plain[1],
                                                     *plain[2:])
        ys_p = ys_p.flip(0) if reverse else ys_p
        torch.testing.assert_close(ys, ys_p, rtol=1e-4, atol=1e-5)
        want_g = torch.autograd.grad((ys_p * dys).sum() + (hT_p * dhT).sum()
                                     + (cT_p * dcT).sum(), plain)
        for name, g, w_ in zip(names, got_g, want_g):
            assert _max_err_ok(g, w_), (name, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(64, 1280), (16, 1280), (1, 1280),
                                 (64, 128), (64, 512), (32, 1280), (5, 40)])
def test_lstm_plan_matches_the_kernel_smem_on_card(cuda_device, B, H):
    """The route's shared-memory arithmetic equals the kernel's own."""
    plan = tlstm.lstm_plan(B, H)
    assert tlstm.persistent_smem_of_kernel(
        B, H, plan["units"], "fwd") == plan["smem_fwd"] <= tlstm.SMEM_BYTES
    assert tlstm.persistent_smem_of_kernel(
        B, H, plan["units"], "bwd") == plan["smem_bwd"] <= tlstm.SMEM_BYTES


@pytest.mark.cuda
def test_lstm_persistent_launch_that_does_not_fit_raises(cuda_device):
    """A plan whose grid cannot be co-resident (one unit a block at
    H = 4096) is refused with the reason, not run."""
    T, B, H = 2, 2, 4096
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(T, B, H, seed=1)]
    ys = torch.empty(T, B, H, device=cuda_device)
    hs = torch.empty(T, B, H, device=cuda_device)
    plan = dict(units=1)
    with pytest.raises(RuntimeError, match="does not fit on the card"):
        tlstm._forward_persistent("lstm_seq", plan, *ins, 4 * H, hs,
                                  ins[7].clone(), ys, None, None)


def _crf_inputs(B, T, C, seed, device):
    """x [B,T,C], a ragged mask with one length-1 row and one all-padding
    row, trans with two forbidden transitions (-1e4), a, b, and the
    cotangent g [B]."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(device)
    lens = rng.integers(1, T + 1, size=B)
    lens[0], lens[-1] = T, 0
    if B > 2:
        lens[1] = 1
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(device)
    trans = f(C, C)
    trans[0, 1] = trans[min(2, C - 1), C - 1] = -1e4
    return f(B, T, C), mask, trans, f(C), f(C), f(B)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C", [(64, 80, 23), (1, 80, 23), (5, 7, 9),
                                   (6, 12, 33), (4, 5, 96), (8, 20, 97),
                                   (8, 20, 128), (5, 12, 256), (4, 40, 257),
                                   (2, 20, 1000)])
def test_crf_kernels_match_plain_on_card(cuda_device, B, T, C):
    """The tagger's shape (B=64, T=80, C=23), its serving shape (B=1), and
    class counts below and across a warp's 32, up to 256 (the forward's E
    read from L2 above C = 238) and beyond: log Z and the alphas within
    rtol 1e-4 / atol 1e-5; every gradient per tensor within 1e-4 of its
    largest entry + 1e-5 (sums over steps and rows in another order),
    forbidden transitions finite and near 0; the Viterbi paths identical
    and their scores within 1e-5."""
    x, mask, trans, a, b, g = _crf_inputs(B, T, C, B * T + C, cuda_device)
    before = (tcrf.crf_alpha_fwd.launches, tcrf.crf_bwd.launches,
              tcrf.crf_viterbi.launches)
    w_alphas, w_log_z = tcrf.crf_forward_plain(x, mask, trans, a, b)
    alphas, log_z = tcrf.crf_alpha_fwd(x, mask, trans, a, b)
    got_b = tcrf.crf_bwd(x, mask, trans, b, alphas, log_z, g)
    path, score = tcrf.crf_viterbi(x, mask, trans, a, b)
    torch.cuda.synchronize()
    assert (tcrf.crf_alpha_fwd.launches, tcrf.crf_bwd.launches,
            tcrf.crf_viterbi.launches) == (before[0] + 1, before[1] + 1,
                                           before[2] + 1)
    torch.testing.assert_close(alphas, w_alphas, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(log_z, w_log_z, rtol=1e-4, atol=1e-5)
    want_b = tcrf.crf_bwd_plain(x, mask, trans, b, w_alphas, w_log_z, g)
    for name, gk, gp in zip(("dx", "dtrans", "da", "db"), got_b, want_b):
        assert torch.isfinite(gk).all(), name
        err = (gk - gp).abs().max().item()
        assert err <= 1e-4 * gp.abs().max().item() + 1e-5, (name, err)
    assert abs(got_b[1][0, 1].item()) < 1e-6
    # the all-padding row takes no unary marginal
    assert got_b[0][-1].abs().max().item() == 0.0
    w_path, w_score = tcrf.crf_viterbi_plain(x, mask, trans, a, b)
    assert torch.equal(path, w_path)
    torch.testing.assert_close(score, w_score, rtol=0, atol=1e-5)
    # two runs give the same bits (no float atomics)
    again = tcrf.crf_bwd(x, mask, trans, b, alphas, log_z, g)
    for g1, g2 in zip(got_b, again):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C", [(64, 80, 23), (5, 12, 33), (8, 20, 97),
                                   (8, 20, 128), (3, 9, 238)])
def test_crf_global_path_equals_shared_path(cuda_device, B, T, C):
    """At a C where the forward's matrix fits shared memory (C <= 238),
    its global-memory path (``in_global``: each block's copy of E read
    from L2, the same partition of every sum) gives the same bits."""
    x, mask, trans, a, b, g = _crf_inputs(B, T, C, B + T + C, cuda_device)
    alphas, log_z = tcrf.crf_alpha_fwd(x, mask, trans, a, b)
    g_alphas, g_log_z = tcrf.crf_alpha_fwd(x, mask, trans, a, b,
                                           in_global=True)
    assert torch.equal(alphas, g_alphas) and torch.equal(log_z, g_log_z)


@pytest.mark.cuda
def test_crf_kernels_reject_bad_inputs(cuda_device):
    """A CPU tensor into a CUDA path and a wrong dtype raise; a class
    count beyond 256, which the earlier forward refused, runs all three
    kernels, the forward held to its plain version."""
    x, mask, trans, a, b, g = _crf_inputs(3, 4, 5, 0, cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        tcrf.crf_alpha_fwd(x, mask.cpu(), trans, a, b)
    with pytest.raises(ValueError, match="float32"):
        tcrf.crf_viterbi(x.double(), mask, trans, a, b)
    with pytest.raises(ValueError, match="float32"):
        tcrf.crf_bwd(x, mask, trans, b, x, g.double(), g)
    x, mask, trans, a, b, g = _crf_inputs(2, 3, 257, 1, cuda_device)
    alphas, log_z = tcrf.crf_alpha_fwd(x, mask, trans, a, b)
    w_alphas, w_log_z = tcrf.crf_forward_plain(x, mask, trans, a, b)
    torch.testing.assert_close(alphas, w_alphas, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(log_z, w_log_z, rtol=1e-4, atol=1e-5)
    tcrf.crf_bwd(x, mask, trans, b, alphas, log_z, g)
    tcrf.crf_viterbi(x, mask, trans, a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C", [(64, 80, 23), (1, 80, 23), (3, 7, 1),
                                   (4, 9, 32), (4, 9, 33), (16, 80, 239),
                                   (16, 80, 256), (4, 40, 257),
                                   (2, 20, 1000), (2, 3000, 23),
                                   (1, 400, 300), (1, 3, 12500),
                                   (1, 3, 14600), (2, 5, 70000)])
def test_crf_plan_matches_the_kernels_on_card(cuda_device, B, T, C):
    """``crf_plan``, ``crf_marginal_plan`` and the scratch sizes the
    wrappers allocate equal ``csrc/crf.cu``'s own (``crf_plan_query``):
    the variant flags, threads, parts a row, matrix stride and shared
    memory of the forward, the beta chain and the Viterbi, the floors',
    and the marginal pass's grid."""
    plan = tcrf.crf_plan(T, C)
    for k, name in ((5, "fwd"), (0, "bwd"), (1, "viterbi")):
        p = plan[name]
        flags = ((p["variant"] == "block") | 2 * p["matrix_in_smem"]
                 | 4 * p.get("bp_in_smem", False) | 8 * p["giant"])
        assert [tcrf.plan_of_kernel(k, B, T, C, f)
                for f in (0, 1, 2, 4, 5)] == [
            p["smem"], flags, p["threads"], p["parts"], p["ld"]], name
    assert tcrf.plan_of_kernel(0, B, T, C, 3) == tcrf.bwd_work_floats(B, T, C)
    assert tcrf.plan_of_kernel(5, B, T, C, 3) == tcrf.fwd_work_floats(B, C)
    assert tcrf.plan_of_kernel(1, B, T, C, 3) == \
        B * plan["viterbi"]["scratch_per_row"]
    m = tcrf.crf_marginal_plan(B, T, C)
    assert [tcrf.plan_of_kernel(4, B, T, C, f) for f in (0, 1, 2, 3)] == [
        tcrf.MARG_SMEM, m["tiles"], m["chunks"], m["tj"]]
    for k, kind in ((2, "beta"), (3, "viterbi"), (6, "alpha")):
        assert [tcrf.plan_of_kernel(k, B, T, C, f) for f in (0, 2)] == [
            plan["floor"]["smem"], plan["floor"][f"{kind}_threads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C", [(2, 3000, 23), (1, 400, 300)])
def test_crf_viterbi_spills_its_back_pointers_on_card(cuda_device, B, T, C):
    """Where the T x C back-pointers outgrow the block (a warp's four
    sequences at C = 23, T = 3000; two bytes each at C = 300, T = 400) they
    go to scratch: the paths stay identical to the plain decode's."""
    assert not tcrf.crf_plan(T, C)["viterbi"]["bp_in_smem"]
    x, mask, trans, a, b, _ = _crf_inputs(B, T, C, T + C, cuda_device)
    path, score = tcrf.crf_viterbi(x, mask, trans, a, b)
    w_path, w_score = tcrf.crf_viterbi_plain(x, mask, trans, a, b)
    assert torch.equal(path, w_path)
    torch.testing.assert_close(score, w_score, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_crf_kernels_take_classes_beyond_shared_memory(cuda_device):
    """Above C ~ 29,000 (the forward), ~ 12,400 (the backward) and ~
    14,500 (the Viterbi) the per-class vectors move to global scratch: all
    three still hold the plain versions (B = 1, T = 3)."""
    for C, kind in ((29100, "fwd"), (12500, "bwd"), (14600, "viterbi")):
        assert tcrf.crf_plan(3, C)[kind]["giant"]
        if kind == "fwd":  # 847 M entries of trans: drawn on the card
            gen = torch.Generator(device=cuda_device).manual_seed(C)
            x, trans, a, b = (torch.randn(s, generator=gen,
                                          device=cuda_device)
                              for s in ((1, 3, C), (C, C), (C,), (C,)))
            mask = torch.ones((1, 3), device=cuda_device)
        else:
            x, mask, trans, a, b, g = _crf_inputs(1, 3, C, C, cuda_device)
            mask = torch.ones_like(mask)
        if kind == "fwd":
            got = tcrf.crf_alpha_fwd(x, mask, trans, a, b)
            want = tcrf.crf_forward_plain(x, mask, trans, a, b)
            for gk, gp in zip(got, want):
                torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-5)
        elif kind == "bwd":
            alphas, log_z = tcrf.crf_forward_plain(x, mask, trans, a, b)
            got = tcrf.crf_bwd(x, mask, trans, b, alphas, log_z, g)
            want = tcrf.crf_bwd_plain(x, mask, trans, b, alphas, log_z, g)
            for name, gk, gp in zip(("dx", "dtrans", "da", "db"), got, want):
                err = (gk - gp).abs().max().item()
                assert err <= 1e-4 * gp.abs().max().item() + 1e-5, (name, err)
        else:
            path, score = tcrf.crf_viterbi(x, mask, trans, a, b)
            w_path, w_score = tcrf.crf_viterbi_plain(x, mask, trans, a, b)
            assert torch.equal(path, w_path)
            torch.testing.assert_close(score, w_score, rtol=0, atol=1e-5)
        del x, trans
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 23, 40, 257])
@pytest.mark.parametrize("variant", tcrf.FLOOR_VARIANTS)
def test_crf_chain_floor_matches_plain_on_card(cuda_device, C, variant):
    """The chain-floor microkernel (the chains' own step functions, one
    block, no global memory) against ``chain_floor_plain`` over 50 steps:
    the Viterbi's values and back-pointers exactly, the betas and the
    alphas within rtol 1e-5 (the plain dot is a matmul)."""
    got = tcrf.crf_chain_floor(50, C, variant).cpu()
    want = tcrf.chain_floor_plain(50, C, variant)
    if variant == "viterbi":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _attn_inputs(B, N, Tq, Tk, D, seed, device, all_padding=False):
    """q, k, v, dO and a ragged kv mask (row 0 full; with ``all_padding``
    the last row has no real key)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(device)
    lens = rng.integers(1, Tk + 1, size=B)
    lens[0] = Tk
    if all_padding:
        lens[-1] = 0
    mask = torch.from_numpy(
        (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)).to(device)
    return (f(B, N, Tq, D), f(B, N, Tk, D), f(B, N, Tk, D), mask,
            f(B, N, Tq, D))


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", [
    (3, 2, 70, 133, 16, True, False),   # causal cross, Tq != Tk, ragged
    (4, 4, 50, 50, 128, False, True),   # the seq2seq path's head width
    (2, 2, 130, 130, 64, True, False),
    (2, 3, 9, 5, 8, False, False),
    (3, 4, 50, 50, 32, False, True),    # D = 32, an instance
    (2, 4, 200, 333, 40, True, False)])  # D = 40, padded to 64
def test_flash_kernels_match_plain_on_card(cuda_device, B, N, Tq, Tk, D,
                                           causal, all_padding):
    """The forward kernel within rtol 1e-4 / atol 1e-5 of
    ``blockwise_plain`` (o and the row statistics), the backward kernels'
    gradients per tensor within 1e-4 of the largest entry + 1e-5 of
    ``flash_bwd_plain`` and of autograd through ``mha_plain`` (sums over
    Tk and Tq in another order); two backward runs bit-equal; an
    all-padding row finite, with a zero dq."""
    q, k, v, mask, do = _attn_inputs(B, N, Tq, Tk, D, B * Tq + D,
                                     cuda_device, all_padding)
    before = (tattn.flash_fwd.launches, tattn.flash_bwd.launches)
    o, lse = tattn.flash_fwd(q, k, v, mask, causal)
    grads = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (tattn.flash_fwd.launches, tattn.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    w_o, w_lse = tattn.blockwise_plain(q, k, v, mask, causal)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, tattn.flash_bwd_plain(
        q, k, v, mask, w_o, w_lse, do, causal))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.mha_plain(*leaves, mask, causal)
    _assert_grads_close(grads, torch.autograd.grad((ref * do).sum(), leaves))
    if all_padding:
        assert grads[0][-1].abs().max().item() == 0.0
    again = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    for g1, g2 in zip(grads, again):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", [
    (2, 4, 64, 333, 64, False, True),   # (a) all-padding kv row, Tk > 256
    (2, 4, 333, 200, 64, True, False)])  # (b) causal, Tq > Tk
def test_flash_kernels_match_plain_on_rows_without_a_key(
        cuda_device, B, N, Tq, Tk, D, causal, all_padding):
    """Query rows that see no key get JAX's result, which
    ``blockwise_plain`` and ``flash_bwd_plain`` follow: sum_j v_j / Tk_pad
    (Tk padded to a multiple of min(256, Tk)), the row statistics
    (-1e9, log Tk_pad), a zero dq and a dv share of dO / Tk_pad; o, the
    statistics and every gradient within the tolerances above; two
    backward runs bit-equal."""
    q, k, v, mask, do = _attn_inputs(B, N, Tq, Tk, D, Tq + Tk, cuda_device,
                                     all_padding)
    o, lse = tattn.flash_fwd(q, k, v, mask, causal)
    grads = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    w_o, w_lse = tattn.blockwise_plain(q, k, v, mask, causal)
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, tattn.flash_bwd_plain(
        q, k, v, mask, w_o, w_lse, do, causal))
    vis = (mask[:, None, :] > 0).expand(B, Tq, Tk)
    if causal:
        qi = torch.arange(Tq, device=cuda_device)[:, None] + (Tk - Tq)
        vis = vis & (torch.arange(Tk, device=cuda_device)[None, :] <= qi)
    b, i = torch.nonzero(~vis.any(dim=-1), as_tuple=True)
    assert b.numel() > 0
    assert grads[0][b, :, i].abs().max().item() == 0.0
    assert (lse.reshape(2, B, N, Tq)[0][b, :, i] == -1e9).all()
    again = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    for g1, g2 in zip(grads, again):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
def test_attention_layer_runs_the_kernels_on_card(cuda_device):
    """The layer's strided head views reach the kernels (made contiguous
    in ``flash_attention``): forward and every gradient on the card
    against the same layer on the CPU (the plain versions)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.network import Network
    dsl.reset()
    x = dsl.data(name="x", size=64, is_sequence=True)
    out = dsl.multi_head_attention(x, num_heads=4, causal=True, name="att")
    net = Network(dsl.current_graph(), outputs=[out.name])
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s.shape).astype(np.float32) * 0.2
              for k, s in net.param_specs.items()}
    mask = torch.from_numpy((np.arange(37)[None, :] < np.array(
        [[37], [20], [0]])).astype(np.float32))  # ragged, one all padding
    xv = torch.from_numpy(rng.normal(size=(3, 37, 64)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(3, 37, 64)).astype(np.float32))
    results = []
    for dev in ("cpu", cuda_device):
        p = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
             for k, v in params.items()}
        before = tattn.flash_bwd.launches
        y = net.apply(p, {"x": Argument(xv.to(dev), mask.to(dev))})[
            out.name].value
        gs = torch.autograd.grad((y * ct.to(dev)).sum(), list(p.values()))
        if dev != "cpu":
            assert tattn.flash_bwd.launches == before + 1
        results.append((y.detach().cpu(), [g.cpu() for g in gs]))
    (y_cpu, g_cpu), (y_gpu, g_gpu) = results
    torch.testing.assert_close(y_gpu, y_cpu, rtol=1e-4, atol=1e-5)
    for g, w in zip(g_gpu, g_cpu):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() \
            + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,Tq,Tk,D,causal", [
    (16384, 4, 1, 1, 8, False),   # B * N = 65536, past a grid y of 65535
    (16384, 4, 3, 5, 8, True)])
def test_flash_kernels_take_more_than_65535_heads(cuda_device, B, N, Tq,
                                                  Tk, D, causal):
    """B * N lies on the grid's x: 65,536 heads give the plain results
    (o and the row statistics within rtol 1e-4 / atol 1e-5, every
    gradient within 1e-4 of its largest entry + 1e-5)."""
    q, k, v, mask, do = _attn_inputs(B, N, Tq, Tk, D, 5, cuda_device)
    o, lse = tattn.flash_fwd(q, k, v, mask, causal)
    grads = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    w_o, w_lse = tattn.blockwise_plain(q, k, v, mask, causal)
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, tattn.flash_bwd_plain(
        q, k, v, mask, w_o, w_lse, do, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_without_a_mask_match_plain_on_card(cuda_device,
                                                          causal):
    """No mask: the kernels take a null pointer (every key real) and give
    the plain versions' results without a mask; causal with Tq > Tk has
    rows that see no key."""
    q, k, v, _, do = _attn_inputs(2, 3, 150, 97, 64, 9, cuda_device)
    o, lse = tattn.flash_fwd(q, k, v, None, causal)
    grads = tattn.flash_bwd(q, k, v, None, o, lse, do, causal)
    torch.cuda.synchronize()
    w_o, w_lse = tattn.blockwise_plain(q, k, v, None, causal)
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, tattn.flash_bwd_plain(
        q, k, v, None, w_o, w_lse, do, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk", [(40, 70), (90, 37)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_with_leading_padding_match_plain_on_card(
        cuda_device, Tq, Tk, causal):
    """Masks whose first keys are padding (rows real from key 0, 9, and
    none): with causal the rows before a row's first real key see no key,
    a prefix the backward finds from the mask; o, the statistics and
    every gradient against the plain versions, two backward runs
    bit-equal."""
    q, k, v, _, do = _attn_inputs(3, 2, Tq, Tk, 32, Tq * Tk, cuda_device)
    first = torch.tensor([0, 9, Tk], device=cuda_device)
    mask = (torch.arange(Tk, device=cuda_device)[None, :]
            >= first[:, None]).float()
    o, lse = tattn.flash_fwd(q, k, v, mask, causal)
    grads = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    w_o, w_lse = tattn.blockwise_plain(q, k, v, mask, causal)
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, tattn.flash_bwd_plain(
        q, k, v, mask, w_o, w_lse, do, causal))
    again = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    for g1, g2 in zip(grads, again):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", tattn.HEAD_DIMS + (129, 256, 257, 1024, 1056,
                                                2048))
def test_flash_plan_matches_the_kernel_smem_on_card(cuda_device, D):
    """``flash_plan``'s shared-memory bytes are what each kernel requests
    (its own count, ``flash_smem``: an instance's, the wide-head path's
    above D = 128, or the split-row path's 0 above 1024), within a block's
    limit."""
    plan = tattn.flash_plan(D)
    for kernel in ("fwd", "dq", "dkdv"):
        assert tattn.flash_smem_of_kernel(kernel, D) == \
            plan["smem_" + kernel] <= tattn.build.SMEM_BYTES


@pytest.mark.cuda
def test_flash_kernels_reject_bad_inputs(cuda_device):
    """A non-contiguous input, a wrong dtype and a CPU mask all raise with
    the reason; D = 160, which the tensor-core kernels alone refused, runs
    on the wide path, and D = 1056, which the wide path refused, on the
    split-row path: both hold the plain versions (the split path's
    backward bit-equal over two runs)."""
    q, k, v, mask, do = _attn_inputs(2, 2, 8, 8, 16, 0, cuda_device)
    wide = _attn_inputs(2, 2, 8, 8, tattn.WIDE_MAX_D + 32, 0, cuda_device)
    o, lse = tattn.flash_fwd(*wide[:4])
    w_o, w_lse = tattn.blockwise_plain(*wide[:4])
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    grads = tattn.flash_bwd(*wide[:4], o, lse, wide[4])
    _assert_grads_close(grads, tattn.flash_bwd_plain(*wide[:4], w_o, w_lse,
                                                     wide[4]))
    assert all(torch.equal(a, b) for a, b in zip(grads, tattn.flash_bwd(
        *wide[:4], o, lse, wide[4])))
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_fwd(q.transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError, match="float32"):
        tattn.flash_fwd(q.double(), k, v, mask)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_fwd(q, k, v, mask.cpu())
    o, lse = tattn.flash_fwd(q, k, v, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_bwd(q, k, v, mask, o, lse, do.transpose(2, 3))
    q, k, v, mask, do = _attn_inputs(2, 2, 8, 8, 160, 0, cuda_device)
    o, lse = tattn.flash_fwd(q, k, v, mask)
    w_o, w_lse = tattn.blockwise_plain(q, k, v, mask)
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(tattn.flash_bwd(q, k, v, mask, o, lse, do),
                        tattn.flash_bwd_plain(q, k, v, mask, w_o, w_lse, do))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", [
    (2, 4, 300, 300, 256, False, True),  # an all-padding kv row, Tk > 256
    (2, 4, 300, 300, 256, True, True),
    (2, 2, 333, 200, 256, True, False),  # causal, Tq > Tk
    (3, 2, 70, 133, 160, True, False),
    (2, 1, 40, 57, 129, False, False),
    (2, 2, 50, 90, 384, False, True),
    (1, 2, 33, 47, 1024, True, False),
    # the split-row path (D > 1024)
    (1, 2, 64, 64, 1056, False, True),
    (1, 2, 64, 64, 2048, True, False),
    (1, 2, 80, 64, 2048, True, True)])  # causal, Tq > Tk, a padding row
def test_flash_wide_heads_match_plain_on_card(cuda_device, B, N, Tq, Tk, D,
                                             causal, all_padding):
    """Head widths above 128 take the wide-head path (one launch forward,
    two backward): o and the row statistics within rtol 1e-4 / atol 1e-5
    of ``blockwise_plain``, every gradient per tensor within 1e-4 of its
    largest entry + 1e-5 of ``flash_bwd_plain``, rows that see no key
    included (JAX's padded mean of v, a zero dq); two backward runs
    bit-equal."""
    q, k, v, mask, do = _attn_inputs(B, N, Tq, Tk, D, B * Tq + D,
                                     cuda_device, all_padding)
    before = (tattn.flash_fwd.launches, tattn.flash_bwd.launches)
    o, lse = tattn.flash_fwd(q, k, v, mask, causal)
    grads = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (tattn.flash_fwd.launches, tattn.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    w_o, w_lse = tattn.blockwise_plain(q, k, v, mask, causal)
    torch.testing.assert_close(o, w_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads, tattn.flash_bwd_plain(
        q, k, v, mask, w_o, w_lse, do, causal))
    if all_padding:
        assert grads[0][-1].abs().max().item() == 0.0
    again = tattn.flash_bwd(q, k, v, mask, o, lse, do, causal)
    for g1, g2 in zip(grads, again):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
def test_attention_layer_with_wide_heads_runs_the_kernels_on_card(
        cuda_device):
    """``multi_head_attention`` at size 512 with 2 heads (D = 256): the
    forward and every gradient on the card against the same layer on the
    CPU (the plain versions)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.network import Network
    dsl.reset()
    x = dsl.data(name="x", size=512, is_sequence=True)
    out = dsl.multi_head_attention(x, size=512, num_heads=2, name="att")
    net = Network(dsl.current_graph(), outputs=[out.name])
    rng = np.random.default_rng(5)
    params = {k: rng.normal(size=s.shape).astype(np.float32) * 0.05
              for k, s in net.param_specs.items()}
    mask = torch.from_numpy((np.arange(29)[None, :] < np.array(
        [[29], [11], [0]])).astype(np.float32))
    xv = torch.from_numpy(rng.normal(size=(3, 29, 512)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(3, 29, 512)).astype(np.float32))
    results = []
    for dev in ("cpu", cuda_device):
        p = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
             for k, v in params.items()}
        before = tattn.flash_bwd.launches
        y = net.apply(p, {"x": Argument(xv.to(dev), mask.to(dev))})[
            out.name].value
        gs = torch.autograd.grad((y * ct.to(dev)).sum(), list(p.values()))
        if dev != "cpu":
            assert tattn.flash_bwd.launches == before + 1
        results.append((y.detach().cpu(), [g.cpu() for g in gs]))
    (y_cpu, g_cpu), (y_gpu, g_gpu) = results
    torch.testing.assert_close(y_gpu, y_cpu, rtol=1e-4, atol=1e-5)
    for g, w in zip(g_gpu, g_cpu):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() \
            + 1e-5


def _ctc_inputs(B, T, C, L, seed, device):
    """The CTC kernels' operands from random log-probs [B,T,C] (blank C-1)
    and labels [B,L]: ragged frame counts (row 0 full, the rest padded at
    the tail) and transcripts; with B >= 4, row 1 an empty transcript, row
    2 repeated labels (no jump between equal ones) and row 3 infeasible
    (fewer frames than its labels need). Returns (emit, in_mask, valid_s,
    can_skip, ext_lens, g, log_probs [B,T,C], labels, lab_lens, in_lens)."""
    from paddle_tpu_torch.layers.chain import extended_labels
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    log_probs = torch.log_softmax(logits, dim=-1).to(device)
    labels = rng.integers(0, C - 1, size=(B, L))
    in_lens = rng.integers(max(T // 4, 1), T + 1, size=B)
    in_lens[0] = T
    lab_lens = np.minimum(rng.integers(1, L + 1, size=B), in_lens // 3 + 1)
    lab_lens[0] = L
    if B >= 4:
        lab_lens[1] = 0
        labels[2, 1::2] = labels[2, ::2][:len(labels[2, 1::2])]
        lab_lens[2] = L
        in_lens[2] = T
        lab_lens[3], in_lens[3] = L, max(L // 2, 1)
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32)).to(device)
    label_mask = torch.from_numpy((np.arange(L)[None, :] < lab_lens[:, None])
                                  .astype(np.float32)).to(device)
    labels = torch.from_numpy(labels).to(device)
    ext, ext_lens, valid_s, can_skip = extended_labels(labels, label_mask,
                                                       C - 1)
    S = ext.shape[1]
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(device)
    return (emit.contiguous(), in_mask, valid_s.float().contiguous(),
            can_skip.float().contiguous(), ext_lens.contiguous(), g,
            log_probs, labels, lab_lens, in_lens)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,L", [
    (16, 400, 29, 66),   # the acoustic model's shape, with the edge rows
    (1, 400, 29, 66),    # batch 1
    (5, 9, 6, 4),        # T = 2 L + 1 for the full rows
    (4, 700, 29, 320),   # S = 641: eight states a lane, 3 warps
    (2, 4400, 29, 2150),  # S = 4301: sixteen states a lane, 9 warps
    (2, 12500, 29, 6000)])  # S = 12,001, above the former limit of 8192
def test_ctc_kernels_match_plain_on_card(cuda_device, B, T, C, L):
    """alphas and ll within rtol 1e-4 / atol 1e-5 of the plain versions
    (their NEG entries equal: an unreachable state and the infeasible row's
    ll are -1e30 in both), demit per tensor within 1e-4 of its largest
    entry + 1e-5, every output finite, two backward runs bit-equal, and
    -ll on the feasible rows within 1e-4 relative of
    ``torch.nn.functional.ctc_loss``."""
    (emit, in_mask, valid_s, can_skip, ext_lens, g, log_probs, labels,
     lab_lens, in_lens) = _ctc_inputs(B, T, C, L, B * T + L, cuda_device)
    args = (emit, in_mask, valid_s, can_skip, ext_lens)
    before = (tctc.ctc_alpha_fwd.launches, tctc.ctc_bwd.launches)
    alphas, ll = tctc.ctc_alpha_fwd(*args)
    demit = tctc.ctc_bwd(*args, alphas, ll, g)
    torch.cuda.synchronize()
    assert (tctc.ctc_alpha_fwd.launches, tctc.ctc_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    w_alphas, w_ll = tctc.ctc_forward_plain(*args)
    for name, got, want in (("alphas", alphas, w_alphas), ("ll", ll, w_ll)):
        assert torch.isfinite(got).all(), name
        neg = want < -1e29
        assert torch.equal(got[neg], want[neg]), name
        assert (got[~neg] > -1e29).all(), name
        torch.testing.assert_close(got[~neg], want[~neg], rtol=1e-4,
                                   atol=1e-5, msg=name)
    want_d = tctc.ctc_bwd_plain(*args, w_alphas, w_ll, g)
    assert torch.isfinite(demit).all()
    err = (demit - want_d).abs().max().item()
    assert err <= 1e-4 * want_d.abs().max().item() + 1e-5, err
    assert torch.equal(demit, tctc.ctc_bwd(*args, alphas, ll, g))
    # torch's CTC loss on the rows with enough frames for their labels
    need = lab_lens + np.array([
        int((labels[b, 1:lab_lens[b]] == labels[b, :lab_lens[b] - 1])
            .sum().item()) if lab_lens[b] > 1 else 0 for b in range(B)])
    ok = torch.from_numpy(need <= in_lens).to(cuda_device)
    assert bool(ok.any())
    nll = torch.nn.functional.ctc_loss(
        log_probs.transpose(0, 1), labels, torch.from_numpy(in_lens),
        torch.from_numpy(lab_lens), blank=C - 1, reduction="none")
    torch.testing.assert_close(-ll[ok], nll[ok], rtol=1e-4, atol=0)
    if B >= 4:
        assert not bool(ok[3]) and ll[3].item() < -1e29  # infeasible


@pytest.mark.cuda
def test_ctc_kernels_reject_bad_inputs(cuda_device):
    """A CPU tensor into a CUDA path, a wrong dtype, int64 lengths and no
    state at all (S = 0) raise with the reason; so do the fused wrappers'
    float labels and a blank outside [0, C). Both forms take S = 16,385,
    one state past the lanes' 16 states over 32 warps, and 20,001 on the
    wide chains: the gathered alphas, ll and demit, and the fused ll and
    gradient, equal to the plain versions' bits."""
    emit, in_mask, valid_s, can_skip, ext_lens, g, log_probs, labels, \
        lab_lens, _ = _ctc_inputs(2, 6, 5, 2, 0, cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        tctc.ctc_alpha_fwd(emit, in_mask.cpu(), valid_s, can_skip, ext_lens)
    with pytest.raises(ValueError, match="float32"):
        tctc.ctc_alpha_fwd(emit.double(), in_mask, valid_s, can_skip,
                           ext_lens)
    with pytest.raises(ValueError, match="int32"):
        tctc.ctc_alpha_fwd(emit, in_mask, valid_s, can_skip, ext_lens.long())
    S = tctc.MAX_STATES + 1
    assert S == 16385
    none = torch.zeros(1, 2, 0, device=cuda_device)
    with pytest.raises(ValueError, match="states"):
        tctc.ctc_alpha_fwd(none, in_mask[:1, :2].contiguous(), none[:, 0],
                           none[:, 0], ext_lens[:1])
    for big_s in (S, 20001):
        assert tctc.ctc_plan(big_s)["fwd"] == "wide"
        gargs = _ctc_inputs(1, 60, 29, (big_s - 1) // 2, big_s,
                            cuda_device)[:5]
        assert gargs[0].shape[2] == big_s
        alphas, ll = tctc.ctc_alpha_fwd(*gargs)
        w_alphas, w_ll = tctc.ctc_forward_plain(*gargs)
        assert torch.equal(alphas, w_alphas) and torch.equal(ll, w_ll)
        g1 = torch.tensor([0.7], device=cuda_device)
        demit = tctc.ctc_bwd(*gargs, alphas, ll, g1)
        assert torch.equal(demit, tctc.ctc_bwd_plain(*gargs, w_alphas,
                                                     w_ll, g1))
        assert torch.equal(demit, tctc.ctc_bwd(*gargs, alphas, ll, g1))
    lm = (torch.arange(2, device=cuda_device)[None, :]
          < torch.from_numpy(lab_lens).to(cuda_device)[:, None]).float()
    with pytest.raises(ValueError, match="int32 or int64"):
        tctc.ctc_fused_fwd(log_probs, labels.float(), in_mask, lm, 4)
    with pytest.raises(ValueError, match="blank"):
        tctc.ctc_fused_fwd(log_probs, labels, in_mask, lm, 5)
    wide = torch.randint(0, 4, (1, (S - 1) // 2), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3)).to(
                             cuda_device)
    assert tctc.ctc_plan(S, 5)["fwd"] == "wide"
    args = (wide, in_mask[:1].contiguous(), torch.ones_like(wide).float(), 4)
    ll, alphas, betas = tctc.ctc_fused_fwd(log_probs[:1].contiguous(),
                                           *args, grad=True)
    w_alphas, w_betas, w_ll = tctc.ctc_fused_forward_plain(
        log_probs[:1].contiguous(), *args)
    for name, got, want in (("alphas", alphas, w_alphas),
                            ("betas", betas, w_betas), ("ll", ll, w_ll)):
        assert torch.equal(got, want), name
    g1 = g[:1].contiguous()
    assert torch.equal(
        tctc.ctc_fused_bwd(*args[:3], 4, 5, alphas, betas, ll, g1),
        tctc.ctc_fused_bwd_plain(*args[:3], 4, 5, w_alphas, w_betas, w_ll,
                                 g1))


def _fused_run(log_probs, labels, in_mask, label_mask, blank, g):
    """(ll, alphas, betas, d log_probs) of the fused kernels."""
    C = log_probs.shape[2]
    ll, alphas, betas = tctc.ctc_fused_fwd(log_probs, labels, in_mask,
                                           label_mask, blank, grad=True)
    dlp = tctc.ctc_fused_bwd(labels, in_mask, label_mask, blank, C, alphas,
                             betas, ll, g)
    return ll, alphas, betas, dlp


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,L", [
    (16, 400, 29, 66),   # the acoustic model's shape, with the edge rows
    (1, 400, 29, 66),    # batch 1
    (5, 9, 6, 4),        # T = 2 L + 1 for the full rows
    (4, 700, 29, 320),   # S = 641
    (2, 4400, 29, 2150),  # S = 4301
    (2, 12500, 29, 6000),  # S = 12,001, above the former limit of 8192
    (2, 50, 60000, 10),  # C = 60,000: the sorted posterior pass
    (1, 10500, 29, 10000),  # S = 20,001: the wide chains
    (1, 8500, 30000, 8200)])  # S = 16,401 and C = 30,000: both
def test_ctc_fused_kernels_match_plain_on_card(cuda_device, B, T, C, L):
    """The fused forward (both chains in one launch) and the posterior
    pass from the log-probs, int64 and int32 labels: alphas, betas and ll
    within rtol 1e-4 / atol 1e-5 of ``ctc_fused_forward_plain`` (NEG
    entries equal), d log_probs within 1e-4 of its largest entry + 1e-5 of
    ``ctc_fused_bwd_plain`` and of the plain composition (the gather,
    ``ctc_bwd_plain``, autograd's scatter), two backward runs bit-equal,
    the no-grad forward's ll the same bits, the loss (``negate``) and its
    gradient through an expanded cotangent the same bits as the kernels'
    with the sign taken outside, -ll on the feasible rows within
    1e-4 relative of ``torch.nn.functional.ctc_loss``, and ids >= C in the
    padded label slots giving the result of zeros there."""
    (_, in_mask, _, _, _, g, log_probs, labels, lab_lens,
     in_lens) = _ctc_inputs(B, T, C, L, B * T + L + 1, cuda_device)
    blank = C - 1
    lm = torch.from_numpy((np.arange(L)[None, :] < lab_lens[:, None])
                          .astype(np.float32)).to(cuda_device)
    before = (tctc.ctc_fused_fwd.launches, tctc.ctc_fused_bwd.launches)
    ll, alphas, betas, dlp = _fused_run(log_probs, labels, in_mask, lm,
                                        blank, g)
    torch.cuda.synchronize()
    assert (tctc.ctc_fused_fwd.launches, tctc.ctc_fused_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    w_alphas, w_betas, w_ll = tctc.ctc_fused_forward_plain(
        log_probs, labels, in_mask, lm, blank)
    for name, got, want in (("alphas", alphas, w_alphas),
                            ("betas", betas, w_betas), ("ll", ll, w_ll)):
        assert torch.isfinite(got).all(), name
        neg = want < -1e29
        assert torch.equal(got[neg], want[neg]), name
        assert (got[~neg] > -1e29).all(), name
        torch.testing.assert_close(got[~neg], want[~neg], rtol=1e-4,
                                   atol=1e-5, msg=name)
    want = tctc.ctc_fused_bwd_plain(labels, in_mask, lm, blank, C, w_alphas,
                                    w_betas, w_ll, g)
    # the plain composition: the gather's transpose of ctc_bwd_plain
    emit, valid_s, can_skip, ext_lens, _ = tctc._fused_operands(
        log_probs, labels, lm, blank)
    leaf = log_probs.detach().clone().requires_grad_(True)
    gathered = tctc._fused_operands(leaf, labels, lm, blank)[0]
    composed, = torch.autograd.grad(gathered, leaf, tctc.ctc_bwd_plain(
        emit, in_mask, valid_s, can_skip, ext_lens, w_alphas, w_ll, g))
    assert torch.isfinite(dlp).all()
    for ref in (want, composed):
        err = (dlp - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + 1e-5, err
    assert torch.equal(dlp, tctc.ctc_fused_bwd(labels, in_mask, lm, blank, C,
                                               alphas, betas, ll, g))
    assert torch.equal(ll, tctc.ctc_fused_fwd(log_probs, labels, in_mask, lm,
                                              blank))
    # the loss (-ll) with its sign taken in the kernels, and the cotangent
    # autograd's sum expands (stride 0)
    leaf = log_probs.detach().clone().requires_grad_(True)
    loss = tctc.ctc_ll_from_log_probs(leaf, labels, in_mask, lm, blank,
                                      negate=True)
    assert torch.equal(loss, -ll)
    assert torch.equal(torch.autograd.grad(loss.sum(), leaf)[0], _fused_run(
        log_probs, labels, in_mask, lm, blank, -torch.ones_like(g))[3])
    i32 = _fused_run(log_probs, labels.int(), in_mask, lm, blank, g)
    assert all(torch.equal(a, b) for a, b in zip(i32, (ll, alphas, betas,
                                                       dlp)))
    zeros, wild = labels.clone(), labels.clone()
    zeros[lm == 0], wild[lm == 0] = 0, C + 7
    z = _fused_run(log_probs, zeros, in_mask, lm, blank, g)
    w = _fused_run(log_probs, wild, in_mask, lm, blank, g)
    assert all(torch.equal(a, b) for a, b in zip(z, w))
    need = lab_lens + np.array([
        int((labels[b, 1:lab_lens[b]] == labels[b, :lab_lens[b] - 1])
            .sum().item()) if lab_lens[b] > 1 else 0 for b in range(B)])
    ok = torch.from_numpy(need <= in_lens).to(cuda_device)
    nll = torch.nn.functional.ctc_loss(
        log_probs.transpose(0, 1), labels, torch.from_numpy(in_lens),
        torch.from_numpy(lab_lens), blank=blank, reduction="none")
    torch.testing.assert_close(-ll[ok], nll[ok], rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [0, 29, 40000])
def test_ctc_plan_matches_the_kernel_smem_on_card(cuda_device, C):
    """``ctc_plan``'s shared-memory bytes are what the chains and the
    posterior pass request (their own count, ``ctc_smem``) on every route,
    at S from 1 past the lanes' limit and past the staged pass's."""
    for S in (1, 133, 481, 1025, 4301, 12001, 16384, 16385, 20001, 40001):
        plan = tctc.ctc_plan(S, C)
        assert tctc.ctc_smem_of_kernel("chain", S, C) == plan["smem_chain"]
        assert tctc.ctc_smem_of_kernel("grad", S, C) == plan["smem_grad"]
        assert (plan["fwd"] == "wide") == (S > tctc.MAX_STATES)
        assert (plan["bwd"] == "sorted") == (plan["smem_grad"] == 0)
    assert tctc.ctc_smem_of_kernel("chain", 0, C) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("beta", [False, True])
def test_ctc_chain_floor_matches_plain_on_card(cuda_device, P, beta):
    """The chain-floor microkernel (the chain's step and lane exchange in
    one warp) against ``chain_floor_plain`` over 50 frames: rtol 1e-5
    (the lanes' sums add in another order)."""
    got = tctc.ctc_chain_floor(50, P, beta)
    torch.testing.assert_close(got.cpu(), tctc.chain_floor_plain(50, P, beta),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ctc_layer_runs_the_kernels_on_card(cuda_device):
    """The ``warp_ctc`` layer's cost and its gradient into the pre-softmax
    scores on the card (the fused CTC kernels, launched once each; the
    gathered ones not at all) against the same layer on the CPU (the plain
    versions)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.network import Network
    dsl.reset()
    x = dsl.data(name="x", size=7, is_sequence=True)
    y = dsl.data(name="y", size=6, is_sequence=True)
    cost = dsl.warp_ctc_layer(input=x, label=y, blank=6, norm_by_times=True)
    net = Network(dsl.current_graph(), outputs=[cost.name])
    rng = np.random.default_rng(4)
    xv = torch.from_numpy(rng.normal(size=(3, 30, 7)).astype(np.float32))
    xm = torch.from_numpy((np.arange(30)[None, :] < np.array(
        [[30], [17], [9]])).astype(np.float32))
    yv = torch.from_numpy(rng.integers(0, 6, size=(3, 5)).astype(np.int32))
    ym = torch.from_numpy((np.arange(5)[None, :] < np.array(
        [[5], [0], [3]])).astype(np.float32))
    results = []
    for dev in ("cpu", cuda_device):
        leaf = xv.to(dev).requires_grad_(True)
        kernels = (tctc.ctc_fused_fwd, tctc.ctc_fused_bwd,
                   tctc.ctc_alpha_fwd, tctc.ctc_bwd)
        before = [k.launches for k in kernels]
        c = net.apply({}, {"x": Argument(leaf, xm.to(dev)),
                           "y": Argument(yv.to(dev), ym.to(dev))})[
            cost.name].value
        gx, = torch.autograd.grad(c.sum(), leaf)
        if dev != "cpu":
            assert [k.launches - n for k, n in zip(kernels, before)] == [
                1, 1, 0, 0]
        results.append((c.detach().cpu(), gx.cpu()))
    (c_cpu, g_cpu), (c_gpu, g_gpu) = results
    torch.testing.assert_close(c_gpu, c_cpu, rtol=1e-4, atol=1e-5)
    assert (g_gpu - g_cpu).abs().max().item() <= 1e-4 * g_cpu.abs().max(
    ).item() + 1e-5


# ------------------------------------------------------------ the image slice
def _image_graph(kind):
    """A one-layer image graph of the port's DSL (and its feed shapes):
    the layer kinds of ``tests/test_torch_image.py``."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.model_config import Input, LayerDef
    dsl.reset()
    x = dsl.data(name="x", size=4 * 9 * 7, channels=4, height=9, width=7)
    if kind == "conv":
        out = dsl.conv(input=x, num_filters=6, filter_size=3, stride=2,
                       padding=1, groups=2, name="c")
    elif kind == "depthwise":
        out = dsl.conv(input=x, num_filters=8, filter_size=3, padding=1,
                       groups=4, act="linear", bias_attr=False, name="c")
    elif kind == "convt":
        out = dsl.conv(input=x, num_filters=6, filter_size=3, stride=2,
                       padding=1, groups=2, act="linear", name="c",
                       layer_type="exconvt")
    elif kind in ("max", "avg"):
        out = dsl.img_pool(input=x, pool_size=3, stride=2, padding=1,
                           pool_type=f"{kind}-projection", name="p")
    elif kind == "spp":
        out = dsl._add(LayerDef(name="s", type="spp", bias=False,
                                inputs=[Input("x")],
                                attrs={"pyramid_height": 3}))
    elif kind in ("bn_train", "bn_test"):
        out = dsl.batch_norm(input=x, act="relu", name="bn")
    elif kind == "cmrnorm":
        out = dsl.img_cmrnorm(input=x, size=3, scale=0.5, name="n")
    else:  # channel-wise concat of two convs, then a pool
        a = dsl.conv(input=x, num_filters=3, filter_size=3, padding=1,
                     name="a")
        b = dsl.conv(input=x, num_filters=2, filter_size=1, name="b")
        out = dsl.img_pool(input=dsl.concat([a, b]), pool_size=2, stride=2,
                           name="p")
    return dsl.current_graph(), out.name


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv", "depthwise", "convt", "max", "avg",
                                  "spp", "bn_train", "bn_test", "cmrnorm",
                                  "concat"])
def test_image_layers_match_cpu_on_card(cuda_device, kind):
    """Each image layer on the card (cuDNN's convolutions with TF32 off,
    torch's pools) against the same layer on the CPU: the output within
    rtol 1e-4 / atol 1e-5, every gradient (the parameters and the input)
    within 1e-4 of its largest entry + 1e-5, and batch norm's state
    updates within rtol 1e-4 / atol 1e-5; nothing moves off the card."""
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.network import Network
    _no_tf32()
    graph, name = _image_graph(kind)
    net = Network(graph, outputs=[name])
    rng = np.random.default_rng(7)
    params = {k: np.abs(rng.normal(size=s.shape)).astype(np.float32) + 0.5
              if k.endswith(".w2") else
              rng.normal(size=s.shape).astype(np.float32) * 0.5
              for k, s in net.param_specs.items()}
    xv = rng.normal(size=(3, 9, 7, 4)).astype(np.float32)
    train = kind != "bn_test"
    results = []
    for dev in ("cpu", cuda_device):
        p = {k: torch.from_numpy(v).to(dev).requires_grad_(
            not net.param_specs[k].is_static) for k, v in params.items()}
        x = torch.from_numpy(xv).to(dev).requires_grad_(True)
        outs, upd = net.apply_with_state(p, {"x": Argument(x)}, train=train)
        y = outs[name].value
        assert y.device.type == torch.device(dev).type
        ct = torch.from_numpy(np.random.default_rng(8).normal(
            size=tuple(y.shape)).astype(np.float32)).to(dev)
        leaves = [t for t in p.values() if t.requires_grad] + [x]
        gs = torch.autograd.grad((y * ct).sum(), leaves)
        results.append((y.detach().cpu(), [g.cpu() for g in gs],
                        {k: u.cpu() for k, u in upd.items()}))
    (y0, g0, u0), (y1, g1, u1) = results
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-5)
    for g, w in zip(g1, g0):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() \
            + 1e-5
    assert sorted(u0) == sorted(u1) and (kind == "bn_train") == bool(u0)
    for k in u0:
        torch.testing.assert_close(u1[k], u0[k], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_resnet50_three_ways_match_cpu_on_card(cuda_device):
    """``resnet(50, classes=10, image_size=32, width=8)`` at batch 2 on the
    card against the port's CPU path, the same parameters
    (``init_params`` from a seeded generator) and feed: (a) ``train=True``,
    the output and the 106 state updates; (b) ``train=False`` on (a)'s
    moving statistics; (c) ``train=False`` at ``init_params``: NaN in the
    same places, equal values where finite. rtol 1e-4 / atol 1e-5."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.models import resnet
    _no_tf32()
    dsl.reset()
    _, out, _ = resnet(50, classes=10, image_size=32, width=8)
    net = Network(dsl.current_graph(), outputs=[out.name])
    params = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    image = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32, 32, 3)).astype(np.float32))

    def run(dev, p, train):
        with torch.no_grad():
            outs, upd = net.apply_with_state(
                {k: v.to(dev) for k, v in p.items()},
                {"image": Argument(image.to(dev))}, train=train)
        return outs[out.name].value.cpu(), {k: u.cpu() for k, u in
                                            upd.items()}

    (ya, ua), (ya_c, ua_c) = run(cuda_device, params, True), \
        run("cpu", params, True)
    torch.testing.assert_close(ya, ya_c, rtol=1e-4, atol=1e-5)
    assert sorted(ua) == sorted(ua_c) and len(ua) == 106
    for k in ua:
        torch.testing.assert_close(ua[k], ua_c[k], rtol=1e-4, atol=1e-5)
    yb, _ = run(cuda_device, {**params, **ua}, False)
    yb_c, _ = run("cpu", {**params, **ua_c}, False)
    assert torch.isfinite(yb_c).all()
    torch.testing.assert_close(yb, yb_c, rtol=1e-4, atol=1e-5)
    yc, _ = run(cuda_device, params, False)
    yc_c, _ = run("cpu", params, False)
    assert torch.equal(torch.isnan(yc), torch.isnan(yc_c))
    live = ~torch.isnan(yc_c)
    torch.testing.assert_close(yc[live], yc_c[live], rtol=1e-4, atol=1e-5)


# ------------------------------------------------- the rest of training
@pytest.mark.cuda
def test_dropout_mask_on_card_same_bits_from_one_seed(cuda_device):
    """Training-mode dropout's keep mask drawn on the card: the same bits
    from one step seed twice, another layer another mask, the keep
    fraction within 4 sigma of the binomial mean."""
    from paddle_tpu_torch.core import network
    ctx = network.Context(train=True, seed=2017)
    shape, rate = (64, 1280), 0.5
    a = network._dropout_mask(shape, rate, ctx, "drop", cuda_device)
    b = network._dropout_mask(shape, rate, ctx, "drop", cuda_device)
    assert a.is_cuda and torch.equal(a, b)
    assert not torch.equal(a, network._dropout_mask(shape, rate, ctx,
                                                    "other", cuda_device))
    n = a.numel()
    assert abs(float(a.sum()) - n * (1 - rate)) <= 4 * (
        n * rate * (1 - rate)) ** 0.5


@pytest.mark.cuda
def test_prefetched_feed_bit_equal_on_card(cuda_device):
    """The prefetch pipeline's feeds (pinned host memory, a non_blocking
    copy on a side stream, the consumer's stream waiting on its event)
    equal the synchronous feeder's on the card, bit for bit."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.prefetch import PrefetchPipeline
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    rng = np.random.default_rng(7)
    batches = [[(rng.integers(0, 1000, size=int(n)).tolist(),
                 int(rng.integers(0, 2)))
                for n in rng.integers(1, 101, size=64)] for _ in range(6)]
    feeder = DataFeeder({"words": integer_value_sequence(1000),
                         "label": integer_value(2)}, pad_multiple=100,
                        device=cuda_device)
    got = list(PrefetchPipeline(lambda: iter(batches), feeder=feeder,
                                depth=2))
    assert len(got) == len(batches)
    for feed, batch in zip(got, batches):
        want = feeder(batch)
        for k in want:
            assert feed[k].value.is_cuda
            assert torch.equal(feed[k].value, want[k].value)
            if want[k].mask is not None:
                assert torch.equal(feed[k].mask, want[k].mask)


@pytest.mark.cuda
def test_accumulated_gradient_matches_whole_batch_on_card(cuda_device):
    """A classifier batch of 64 rows as 2 microbatches of 32 on the card
    (the LSTM kernels, the f32 sum of the two backwards): every gradient
    within 1e-4 of the whole batch's largest entry + 1e-5, the loss
    within 1e-5 relative."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = lstm_text_classifier(vocab_size=1000, embed_dim=64, hidden=256,
                                num_layers=2, classes=2)[0]
    tr = SGD(cost, update_equation=Adam(), seed=3, device=cuda_device)
    rng = np.random.default_rng(5)
    feed = DataFeeder({"words": integer_value_sequence(1000),
                       "label": integer_value(2)}, pad_multiple=50,
                      device=cuda_device)(
        [(rng.integers(0, 1000, size=int(n)).tolist(),
          int(rng.integers(0, 2))) for n in rng.integers(1, 51, size=64)])
    _, loss, whole, _, _ = tr._grads(feed, seed=0)
    metrics, grads, _ = tr._accum_grads(feed, 2, seed=0)
    assert float(metrics["cost"]) == pytest.approx(float(loss), rel=1e-5)
    for name, w in whole.items():
        err = (grads[name] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, name
