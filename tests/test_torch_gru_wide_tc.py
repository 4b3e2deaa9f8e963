"""The GRU sequence kernels' bf16 forms on the bf16 tensor cores
(``csrc/gru_seq.cu``: ``gru_bf16_kernel``, ``gru_bf16_chain_kernel``) and
the wide-head flash kernels on split-TF32 tensor cores (``csrc/
flash_attn.cu``: ``flash_wide_*_kernel``, 128 < D <= 1024), on the CPU:
their plans and their orders of sums.

- the GRU bf16 plan (``gru_plan(..., bf16=True)``): every (B, H) of the
  float32 persistent route on the bf16 route, each block within 232,448
  bytes, the grid within 132 SMs, the shared-memory arithmetic at the
  acoustic model's (16, 1024);
- the bf16 forms' order of sums in plain PyTorch (each product's K split
  into the 8 warps' k16 steps, the warps' f32 sums added in warp order,
  rounded once; every rounding point of the reference's scan): the
  forward against ``gru_sequence_plain`` at bf16 and JAX's
  ``gru_sequence_ref`` scan at bf16, the chain against
  ``gru_bwd_chain_plain`` at bf16: within 2e-2 of each tensor's largest
  entry, and at T = 3 at most 1 % of the elements beyond one bf16 ulp;
- the wide plan (``flash_plan``) at every D in (128, 1024];
- the wide kernels' forward order of sums in plain PyTorch (split TF32;
  D padded to chunks of 64 columns; each score one warp's sum over D, a
  chunk at a time, 32 columns a fresh accumulator; kv tiles of 64 keys,
  the online softmax with each row's sum over the 8 warps' keys added in
  warp order) against ``mha_plain`` (f32) and JAX's ``flash_attention``
  in interpret mode at D = 160 and 256, within 1e-5.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phases 7 and 17).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.ops import common
from paddle_tpu.ops import gru as jgru
from paddle_tpu.ops.attention import flash_attention
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import gru as tgru
from paddle_tpu_torch.ops.build import H100_SMS, SMEM_BYTES

BF = torch.bfloat16
WARPS = 8


# ------------------------------------------------------------ GRU plan
def test_gru_bf16_plan_takes_every_f32_persistent_shape():
    """Every (B, H) the float32 persistent route takes (B up to its line,
    H % 4 == 0 up to 1584) is on the bf16 route: an even number of units,
    at least the float32 plan's, the grid within the card's SMs and both
    blocks within its limit."""
    taken = 0
    for H in range(4, 1600, 4):
        for B in range(1, 1100):
            f32 = tgru.gru_plan(B, H)
            if f32["route"] != tgru.PERSISTENT:
                if B > 1:
                    break
                continue
            taken += 1
            bf = tgru.gru_plan(B, H, bf16=True)
            assert bf["route"] == tgru.PERSISTENT, (B, H)
            assert bf["units"] % 2 == 0 and bf["units"] >= f32["units"]
            assert bf["grid"] <= H100_SMS
            assert max(bf["smem_fwd"], bf["smem_bwd"]) <= SMEM_BYTES
    assert taken > 100000


def test_gru_bf16_smem_arithmetic_at_the_acoustic_model():
    """At (16, 1024): 8 units a block (128 blocks; 16 a block measured
    slower, 32 would not fit), the z, r and c columns as 24
    bf16 rows of 1024 + 8 (49,536 bytes), the warps' rings [8][4][16][16]
    bf16 (16,384, above their sums' 12,288) and the own units' state:
    forward 1,024 + 2 x (64 + 768), the chain 512 + 2 x (576 + 1,024); at
    16 units 48 rows (99,072), the sums [8][16][40] f32 (20,480) and
    forward 2,048 + 2 x (64 + 1,536), the chain 1,024 + 2 x (1,088 +
    2,048)."""
    plan = tgru.gru_plan(16, 1024, bf16=True)
    assert (plan["units"], plan["grid"]) == (8, 128)
    assert plan["smem_fwd"] == 49536 + 16384 + 1024 + 2 * (64 + 768)
    assert plan["smem_bwd"] == 49536 + 16384 + 512 + 2 * (576 + 1024)
    assert tgru.bf16_smem(16, 1024, 16, False) == \
        99072 + 20480 + 2048 + 2 * (64 + 1536)
    assert tgru.bf16_smem(16, 1024, 16, True) == \
        99072 + 20480 + 1024 + 2 * (1088 + 2048)
    # past 8 units only where the f32 plan's ask more (ceil(1452 / 132))
    wide = tgru.gru_plan(16, 1452, bf16=True)
    assert (wide["units"], wide["route"]) == (12, tgru.PERSISTENT)
    # a large batch at a wide H takes fewer m16 tiles a row group
    assert tgru.bf16_mtiles(163, 1060, 10) == 2
    assert tgru.bf16_mtiles(40, 1024, 16) == 4


# ---------------------------------------- the GRU bf16 forms' order of sums
def _rnd(x):
    return x.to(BF).float()


def _warp_product(a, w):
    """a [B, K] @ w [K, N] as the bf16 kernels sum it: K (rounded up to 16
    with zeros) in k16 steps, warp kw taking [kw nk / 8, (kw + 1) nk / 8),
    each warp's f32 sum, the 8 added in warp order; unrounded."""
    K = a.shape[1]
    nk = -(-K // 16)
    af, wf = a.float(), w.float()
    total = torch.zeros(a.shape[0], w.shape[1])
    for kw in range(WARPS):
        k0 = 16 * (kw * nk // WARPS)
        k1 = min(K, 16 * ((kw + 1) * nk // WARPS))
        if k1 > k0:
            total = total + af[:, k0:k1] @ wf[k0:k1]
    return total


def _sigmoid_bf16(x):
    return _rnd(1 / _rnd(1 + _rnd(torch.exp(-x))))


def _kernel_forward(xs_b, mask, wg, ws, h0):
    """The bf16 forward as ``gru_bf16_kernel`` computes it: (ys f32, hs,
    gates) with hs and gates bf16."""
    H = h0.shape[1]
    h = h0.float()
    ys, hs, gates = [], [], []
    for t in range(xs_b.shape[0]):
        x = xs_b[t].float()
        p1 = _rnd(_warp_product(h.to(BF), wg))
        z = _sigmoid_bf16(_rnd(x[:, :H] + p1[:, :H]))
        r = _sigmoid_bf16(_rnd(x[:, H:2 * H] + p1[:, H:]))
        rh = _rnd(r * h)
        c = _rnd(torch.tanh(_rnd(x[:, 2 * H:]
                                 + _rnd(_warp_product(rh.to(BF), ws)))))
        y = _rnd(h - _rnd(z * h)) + _rnd(z * c)
        m = mask[t][:, None]
        ys.append(y * m)
        h = torch.where(m > 0, _rnd(y), h)
        hs.append(h)
        gates.append(torch.cat([z, r, c], dim=-1))
    return (torch.stack(ys), torch.stack(hs).to(BF),
            torch.stack(gates).to(BF))


def _kernel_chain(dys, mask, gates, h0, hs, wg, ws, dhT):
    """The bf16 reverse chain as ``gru_bf16_chain_kernel`` computes it:
    (dxs, dh0) in bf16."""
    T, B, H = hs.shape
    g, hsf = gates.float(), hs.float()
    dh = dhT.float()
    dxs = torch.zeros(T, B, 3 * H)
    for t in range(T - 1, -1, -1):
        m = mask[t][:, None]
        z, r, c = g[t].split(H, dim=-1)
        hp = hsf[t - 1] if t else h0.float()
        dh_new = m * (dh + _rnd(dys[t]))
        dz = dh_new * (c - hp)
        da_c = _rnd((dh_new * z) * (1 - c * c))
        da_z = _rnd((dz * z) * (1 - z))
        dh = (1 - m) * dh + dh_new * (1 - z)
        drh = _rnd(_warp_product(da_c.to(BF), ws.t()))
        da_r = _rnd(((drh * hp) * r) * (1 - r))
        dh = dh + drh * r
        dh = dh + _rnd(_warp_product(da_z.to(BF), wg[:, :H].t()))
        dh = _rnd(dh + _rnd(_warp_product(da_r.to(BF), wg[:, H:].t())))
        dxs[t] = torch.cat([da_z, da_r, da_c], dim=-1)
    return dxs.to(BF), dh.to(BF)


def _gru_case(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s) * scale, dtype=torch.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = torch.tensor((np.arange(T)[:, None] < lens[None, :]),
                        dtype=torch.float32)
    w0 = f(H, 3 * H, scale=H ** -0.5).to(BF)
    return (f(T, B, 3 * H).to(BF), mask, w0, f(3 * H, scale=0.1).to(BF),
            f(B, H, scale=0.5).to(BF), f(T, B, H), f(B, H).to(BF))


def _ulps_beyond_one(got, want):
    """The share of elements of ``got`` more than one bf16 ulp (of
    ``want``'s value) from ``want``."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return float(((got - want).abs() > ulp).float().mean())


def _held(got, want, short):
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 2e-2 * w.abs().max().item()
        if short:
            assert _ulps_beyond_one(g, w) <= 0.01


# (T, B, H): the acoustic model's width at a short and a longer sequence,
# a batch over one m16 tile, and an H whose k16 steps leave warps idle
GRU_CASES = [(3, 16, 1024), (12, 16, 256), (6, 20, 256), (3, 5, 40)]


@pytest.mark.parametrize("T,B,H", GRU_CASES)
def test_gru_bf16_order_of_sums_holds_the_plain_forward_and_jax(T, B, H):
    """The kernel's forward (K split over 8 warps, summed in warp order,
    rounded once) against ``gru_sequence_plain`` and
    ``gru_sequence_residual_plain`` at bf16 and JAX's ``gru_sequence_ref``
    scan at bf16: within 2e-2 of each tensor's largest entry, at T = 3 at
    most 1 % of the elements beyond one ulp."""
    xs, mask, w0, bias, h0, _, _ = _gru_case(T, B, H, T + B + H)
    xs_b = xs + bias
    wg, ws = w0[:, :2 * H], w0[:, 2 * H:]
    got = _kernel_forward(xs_b, mask, wg, ws, h0)
    short = T == 3
    _held(got, tgru.gru_sequence_residual_plain(xs_b, mask, wg, ws, h0),
          short)
    ys_p, hT_p = tgru.gru_sequence_plain(xs_b, mask, wg, ws, h0)
    _held((got[0], got[1][-1]), (ys_p, hT_p), short)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    jys, jhT = jgru.gru_sequence_ref(j(xs), jnp.asarray(mask.numpy()),
                                     j(wg), j(ws), j(bias), j(h0))
    _held((got[0], got[1][-1]),
          (torch.tensor(np.asarray(jys, np.float32)),
           torch.tensor(np.asarray(jhT, np.float32))), short)


@pytest.mark.parametrize("T,B,H", GRU_CASES)
def test_gru_bf16_chain_order_of_sums_holds_the_plain_chain(T, B, H):
    """The kernel's reverse chain (its three products in the warps'
    order, today's rounding points) against ``gru_bwd_chain_plain`` at
    bf16: within 2e-2 of each tensor's largest entry, at T = 3 at most 1 %
    of the elements beyond one ulp."""
    xs, mask, w0, bias, h0, dys, dhT = _gru_case(T, B, H, 2 * T + B + H)
    wg, ws = w0[:, :2 * H], w0[:, 2 * H:]
    _, hs, gates = tgru.gru_sequence_residual_plain(xs + bias, mask, wg, ws,
                                                    h0)
    args = (dys, mask, gates, h0, hs, wg, ws, dhT)
    _held(_kernel_chain(*args), tgru.gru_bwd_chain_plain(*args), T == 3)


# ------------------------------------------------------------ wide plan
def test_wide_plan_at_every_wide_head():
    """Every D in (128, 1024] takes the wide path: D padded to whole
    chunks of 64 (at most 63 zero columns), an instance of 4, 8 or 16
    chunks that holds it, each kernel's block within the card's limit."""
    for D in range(129, tattn.WIDE_MAX_D + 1):
        plan = tattn.flash_plan(D)
        assert plan["variant"] == "wide"
        assert plan["padded"] == -(-D // 64) * 64
        assert plan["padded"] <= 64 * plan["instance"]
        assert plan["instance"] in (4, 8, 16)
        assert max(plan["smem_fwd"], plan["smem_dq"],
                   plan["smem_dkdv"]) <= SMEM_BYTES
        assert min(plan["blocks_per_sm_" + k]
                   for k in ("fwd", "dq", "dkdv")) >= 1
    assert tattn.flash_plan(1025)["variant"] == "split"


def test_wide_parts_fill_the_card_only_where_blocks_are_few():
    """A launch of the 16-chunk instance (D > 512) with fewer blocks than
    SMs splits its outputs' chunks into parts: [2, 2, 64, 64, 1024] (16
    blocks of 16 chunks) into 8, 10 chunks at 20 blocks into 4; a launch
    of more than 66 blocks into none, nor any launch of the 4- and
    8-chunk instances (D <= 512). Always a power of two, at most the
    chunks, within the SMs where it splits at all."""
    assert tattn.wide_parts(2 * 2 * 4, 1024) == 8
    assert tattn.wide_parts(4 * 5, 640) == 4
    assert tattn.wide_parts(12, 576) == 8           # 9 chunks, uneven
    assert tattn.wide_parts(6 * 5, 130) == 1
    assert tattn.wide_parts(1, 512) == 1
    assert tattn.wide_parts(2 * 4 * 19, 256) == 1   # [2, 4, 300, 300, 256]
    assert tattn.wide_parts(8 * 13, 160) == 1       # [2, 4, 200, 333, 160]
    assert tattn.wide_parts(67, 1024) == 1
    assert tattn.wide_parts(1, 1024, sms=132) == 16
    for blocks in range(1, 200):
        for D in (129, 256, 448, 512, 513, 640, 1000, 1024):
            parts = tattn.wide_parts(blocks, D)
            chunks = -(-D // 64)
            if chunks <= 8:
                assert parts == 1
                continue
            assert parts & (parts - 1) == 0 and parts <= chunks
            assert parts == 1 or blocks * parts <= H100_SMS
            assert 2 * parts > chunks or blocks * 2 * parts > H100_SMS


# ------------------------------------- the wide kernels' order of sums
def _wide_forward(q, k, v, mask, causal, scale):
    """The wide forward kernel's arithmetic in plain PyTorch: o and the
    row statistics [2, B*N, Tq]."""
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    dp = -(-D // 64) * 64
    q, k, v = (F.pad(t, (0, dp - D)) for t in (q, k, v))
    split = tattn.split_tf32_einsum
    acc = torch.zeros(B, N, Tq, dp)
    m = torch.full((B, N, Tq), -1e9)
    l_run = torch.zeros(B, N, Tq)
    qi = torch.arange(Tq)[:, None] + (Tk - Tq)
    for k0 in range(0, Tk, 64):
        kt, vt = k[:, :, k0:k0 + 64], v[:, :, k0:k0 + 64]
        width = kt.shape[2]
        s = torch.zeros(B, N, Tq, width)
        for d0 in range(0, dp, 32):
            s = s + split("bnqd,bnkd->bnqk", q[..., d0:d0 + 32],
                          kt[..., d0:d0 + 32])
        x = s * scale
        kj = k0 + torch.arange(width)
        hidden = ~(mask[:, None, None, k0:k0 + width] > 0)
        if causal:
            hidden = hidden | (kj[None, :] > qi)
        x = x.masked_fill(hidden, -1e9)
        m_new = torch.maximum(m, x.max(dim=-1).values)
        p = torch.exp(x - m_new[..., None])
        alpha = torch.exp(m - m_new)
        tile = torch.zeros_like(l_run)
        for w0 in range(0, width, 8):  # each warp's 8 keys, warp order
            tile = tile + p[..., w0:w0 + 8].sum(dim=-1)
        l_run = l_run * alpha + tile
        acc = acc * alpha[..., None] + split("bnqk,bnkd->bnqd", p, vt)
        m = m_new
    nokey = m == -1e9
    block = min(256, Tk)
    tk_pad = float(-(-Tk // block) * block)
    acc = torch.where(nokey[..., None], v.sum(dim=2, keepdim=True), acc)
    l_run = torch.where(nokey, torch.full_like(l_run, tk_pad), l_run)
    o = (acc / l_run[..., None])[..., :D]
    return o, torch.stack([m, torch.log(l_run)]).reshape(2, B * N, Tq)


def _flash_case(B, N, Tq, Tk, D, seed, all_padding):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.normal(size=s),  # noqa: E731
                                dtype=torch.float32)
    lens = rng.integers(1, Tk + 1, size=B)
    lens[0] = Tk
    if all_padding:
        lens[-1] = 0
    mask = torch.tensor(np.arange(Tk)[None, :] < lens[:, None],
                        dtype=torch.float32)
    return f(B, N, Tq, D), f(B, N, Tk, D), f(B, N, Tk, D), mask


# (B, N, Tq, Tk, D, causal, all_padding): ragged self-attention over two
# kv tiles; causal cross with Tq > Tk (its first rows see no key, Tk <
# 256: JAX's padded mean is mha_plain's uniform one); an all-padding kv
# row with Tk > 256 (against JAX only: Tk_pad = 512)
WIDE_CASES = [(2, 2, 70, 70, 160, False, False),
              (1, 2, 45, 30, 256, True, False),
              (2, 1, 20, 300, 256, False, True),
              (2, 2, 33, 90, 160, True, False)]


@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", WIDE_CASES)
def test_wide_order_of_sums_holds_mha_plain_and_jax(B, N, Tq, Tk, D, causal,
                                                    all_padding):
    """The wide forward's split TF32 in D chunks with warp-ordered partial
    scores: o within 1e-5 of JAX's ``flash_attention`` (interpret mode)
    and of ``mha_plain`` (where no row is divided by a padded Tk), the row
    statistics within 1e-5 of ``blockwise_plain``'s."""
    q, k, v, mask = _flash_case(B, N, Tq, Tk, D, B * Tq + Tk + D,
                                all_padding)
    scale = D ** -0.5
    o, lse = _wide_forward(q, k, v, mask, causal, scale)
    with common.force_mode("interpret"):
        j_o = np.asarray(flash_attention(
            *(jnp.asarray(t.numpy()) for t in (q, k, v, mask)),
            causal=causal))
    np.testing.assert_allclose(o.numpy(), j_o, rtol=1e-5, atol=1e-5)
    if not all_padding:
        torch.testing.assert_close(
            o, tattn.mha_plain(q, k, v, mask, causal), rtol=1e-5, atol=1e-5)
    _, w_lse = tattn.blockwise_plain(q, k, v, mask, causal)
    torch.testing.assert_close(lse, w_lse, rtol=1e-5, atol=1e-5)
