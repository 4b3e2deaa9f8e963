"""The bf16 forms of the LSTM sequence kernels and of flash attention on
the tensor cores (``csrc/lstm_seq.cu``: ``lstm_bf16_kernel``,
``lstm_bf16_chain_kernel``; ``csrc/flash_attn.cu``: the ``_bf16``
kernels), on the CPU: their plans and the arithmetic of the backward's
split products.

- the LSTM bf16 plan (``lstm_plan(..., bf16=True)``): the float32 plan's
  units and grids, every (B, H) of the float32 persistent route on the
  bf16 route, each block within 232,448 bytes and the grids within 132
  SMs, the shared-memory arithmetic at the classifier's (64, 1280);
- flash's bf16 plan (``flash_plan(D, bf16=True)``) at every instance, and
  the head widths the bf16 form pads to;
- the bf16 backward's products of P and dS (not bf16 values) as two bf16
  terms, hi + lo: plain PyTorch with the kernels' split, against
  ``flash_bwd_plain`` at bf16 (f32 products) at a one-tile shape: at
  most 1 % of the elements beyond one bf16 ulp, none beyond 4 ulps of
  the largest entry; one term (P and dS rounded to bf16) misses that.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 17).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import lstm as tlstm
from paddle_tpu_torch.ops.build import H100_SMS, SMEM_BYTES

BF = torch.bfloat16


def test_lstm_bf16_plan_takes_every_f32_persistent_shape():
    """Every (B, H) the float32 persistent route takes (1 <= B <= 64,
    H % 4 == 0 up to past its line at 1280) is on the bf16 route too, with
    the same units and grids, both blocks within the card's limit and
    the chain's grid within its SMs."""
    taken = 0
    for B in (1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 48, 63, 64):
        for H in range(4, 1400, 4):
            f32 = tlstm.lstm_plan(B, H)
            bf = tlstm.lstm_plan(B, H, bf16=True)
            assert (bf["units"], bf["grid"], bf["grid_bwd"]) == (
                f32["units"], f32["grid"], f32["grid_bwd"])
            if f32["route"] != tlstm.PERSISTENT:
                continue
            taken += 1
            assert bf["route"] == tlstm.PERSISTENT, (B, H)
            assert max(bf["smem_fwd"], bf["smem_bwd"]) <= SMEM_BYTES
            assert bf["grid_bwd"] <= H100_SMS and bf["grid"] <= H100_SMS
    assert taken == 13 * 320  # H = 4 .. 1280 at every B


def test_lstm_bf16_smem_arithmetic_at_the_classifier():
    """At (64, 1280): 10 units, W's 40 gate columns as bf16 rows of 1280 +
    8 (5 n8 tiles, 103,040 bytes) and the 8 warps' sums [64][40] f32
    (81,920 bytes, above their rings' 65,536): 184,960 forward; the
    chain's 160 rows of W and 64 staged rows over 8 chunks of 40 (320 +
    8): 146,944. The exchange's stride is H rounded up to 16."""
    plan = tlstm.lstm_plan(64, 1280, bf16=True)
    assert plan["units"] == 10
    assert plan["smem_fwd"] == 2 * 40 * 1288 + 4 * 8 * 64 * 40 == 184960
    assert plan["smem_bwd"] == 2 * (160 + 64) * 328 == 146944
    assert [tlstm.bf16_ld(H) for H in (1280, 100, 12, 16)] == [
        1280, 112, 16, 16]
    assert [tlstm.chain_la(u) for u in tlstm.UNITS] == [8, 8, 16, 40]
    # batch 1: one m16 tile, W's rows the same
    assert tlstm.lstm_plan(1, 1280, bf16=True)["smem_fwd"] == \
        2 * 40 * 1288 + 4 * 8 * 16 * 40


@pytest.mark.parametrize("D", tatt.BF16_HEAD_DIMS)
def test_flash_bf16_plan(D):
    """bf16 tiles of D (+ 8 where D / 8 is even) elements a row; the
    forward's stages of 64 keys, dq's and dkdv's of 32 at D = 128 (64
    below); every block within the card's limit, two forward blocks an SM
    at D = 128."""
    plan = tatt.flash_plan(D, bf16=True)
    ld = D + 8
    assert plan["variant"] == "tensor_cores_bf16" and plan["ld"] == ld
    c = qc = 32 if D == 128 else 64
    assert (plan["kv_cols"], plan["dq_cols"], plan["q_cols"]) == (64, c, qc)
    tile = lambda rows: 2 * rows * ld  # noqa: E731
    assert plan["smem_fwd"] == tile(64) + 2 * (2 * tile(64) + 4 * 64)
    assert plan["smem_dq"] == 2 * tile(64) + 2 * (2 * tile(c) + 4 * c) + 256
    assert plan["smem_dkdv"] == 2 * tile(64) + 2 * (2 * tile(qc) + 12 * qc) \
        + 16
    assert max(plan["smem_" + k] for k in ("fwd", "dq", "dkdv")) \
        <= SMEM_BYTES
    if D == 128:
        assert plan["smem_fwd"] == 87552 and plan["blocks_per_sm_fwd"] == 2


def test_flash_bf16_widths():
    """The bf16 form's instances start at 16 (an mma's k): a narrower head
    pads to 16, the float32 form keeps its 8; 129 and above are not bf16
    instances."""
    assert [tatt.padded_width(D, bf16=True) for D in (1, 8, 9, 16, 40, 128)] \
        == [16, 16, 16, 16, 64, 128]
    assert tatt.padded_width(8) == 8
    with pytest.raises(ValueError):
        tatt.flash_plan(8, bf16=True)
    with pytest.raises(ValueError):
        tatt.flash_plan(256, bf16=True)


def _split(x):
    """x as the kernels' two bf16 terms (hi = bf16(x), lo = bf16(x - hi)),
    widened."""
    hi = x.to(BF).float()
    return hi, (x - hi).to(BF).float()


def _bwd_split(q, k, v, mask, o, lse, do, scale, terms):
    """The bf16 backward's arithmetic in plain PyTorch at one tile: the
    products of bf16 operands exact (f32 sums), P and dS in ``terms``
    bf16 terms (2: hi + lo, the kernels'; 1: rounded to bf16)."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bnqd,bnkd->bnqk", q, k) * scale
    live = (mask[:, None, None, :] > 0).expand_as(s)
    m, log_l = (t.reshape(s.shape[:3] + (1,)) for t in lse)
    p = torch.exp((s.masked_fill(~live, -1e9) - m) - log_l)
    delta = (do * o).sum(-1, keepdim=True)
    dp = torch.einsum("bnqd,bnkd->bnqk", do, v)
    ds = (p * (dp - delta)).masked_fill(~live, 0.0)

    def prod(eq, x, y):
        hi, lo = _split(x)
        out = torch.einsum(eq, hi, y)
        return out + torch.einsum(eq, lo, y) if terms == 2 else out

    dq = prod("bnqk,bnkd->bnqd", ds, k) * scale
    dk = prod("bnqk,bnqd->bnkd", ds, q) * scale
    dv = prod("bnqk,bnqd->bnkd", p, do)
    return tuple(t.to(BF) for t in (dq, dk, dv))


def _beyond_one_ulp(got, want):
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
        min=2.0 ** -126))) - 7)
    d = (got - want).abs()
    top = torch.exp2(torch.floor(torch.log2(want.abs().max())) - 7)
    return (d > ulp).float().mean().item(), (d.max() / top).item()


def test_flash_bf16_backward_split_keeps_the_plain_rounding_points():
    """At Tq = Tk = 8 (the card's short shape, one tile), the two-term
    products of P and dS give dq, dk, dv within the short-shape rule of
    ``flash_bwd_plain`` at bf16 (at most 1 % of the elements beyond one
    bf16 ulp, none beyond 4 ulps of the largest entry); rounding P and dS
    to bf16 instead parts in far more of them."""
    rng = np.random.default_rng(7)
    B, N, T, D = 2, 4, 8, 128
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, N, T, D))
                                    .astype(np.float32)).to(BF)
                   for _ in range(4))
    mask = torch.ones(B, T)
    mask[1, 5:] = 0.0
    o, lse = tatt.blockwise_plain(q, k, v, mask)
    want = tatt.flash_bwd_plain(q, k, v, mask, o, lse, do)
    scale = D ** -0.5
    two = _bwd_split(q, k, v, mask, o, lse, do, scale, terms=2)
    one = _bwd_split(q, k, v, mask, o, lse, do, scale, terms=1)
    for got, w in zip(two, want):
        share, top = _beyond_one_ulp(got, w)
        assert share <= 1e-2 and top <= 4, (share, top)
    assert max(_beyond_one_ulp(g, w)[0] for g, w in zip(one, want)) > 5e-2
