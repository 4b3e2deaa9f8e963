"""DeepSpeech2 as PaddlePaddle/models released it (``chip_smoke.py``'s
``_DS2R_MODEL``: two conv + batch norm(brelu) layers, ``block_expand``,
bidirectional batch-normed GRUs (relu) or simple RNNs (brelu), fc,
``warp_ctc`` and a softmax ``mixed`` over an identity projection), built
from the same config text by both DSLs at a tiny width: a 21 x 31
spectrogram, 4 filters, the release's strides (3 x 2, then 1 x 2) with
5 x 5 and 3 x 3 filters padded by half the filter, hidden 8, 2 layers, 6
classes. Both branches against the JAX package on the CPU: the
probabilities and the cost at 1e-5, every gradient at rtol 1e-4 / atol
1e-5, and 3 Adam steps (costs, parameters and the moving statistics
within 1e-4). ``block_expand``'s feature and position order with
non-square blocks, strides and padding, and its all-ones mask.

The JAX side runs its CTC kernel in interpret mode (``common.force_mode
("interpret")``); no other Pallas kernel lies on the path: the GRU's
``relu`` candidate takes its inline step in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config import model_config as jmc
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.ops import common
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer import events as jev
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config import model_config as tmc
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.optim import Adam as TAdam
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
HEIGHT, WIDTH, CHARS = 21, 31, 5
DIMS = dict(height=HEIGHT, width=WIDTH, chars=CHARS, filters=4, hidden=8,
            layers=2, convs=[(5, 5, 3, 2, 2, 2), (3, 3, 1, 2, 1, 1)])
STEPS, HOUT = 11, 6  # (31 + 4 - 5) // 3 + 1 columns; 21 -> 11 -> 6 rows


def _model():
    ns = {}
    exec(chip_smoke._DS2R_MODEL, ns)
    return ns["deep_speech2"]


def _build(use_gru):
    """(JAX cost, port cost): the same text through both DSLs."""
    model = _model()
    jdsl.reset()
    jcost = model(jdsl, jmc, use_gru=use_gru, **DIMS)[0]
    tdsl.reset()
    tcost = model(tdsl, tmc, use_gru=use_gru, **DIMS)[0]
    return jcost, tcost


def _samples(rng, n):
    """(spectrogram [HEIGHT * WIDTH], transcript): 12..31 frames, each its
    character's prototype plus noise for a stretch, then silence, padded
    with the silence prototype to WIDTH columns, transposed to frequency
    rows; up to 3 characters (one transcript empty)."""
    protos = np.random.default_rng(99).normal(size=(CHARS + 1, HEIGHT))
    out = []
    for i in range(n):
        t = int(rng.integers(12, WIDTH + 1))
        chars = rng.integers(0, CHARS, size=0 if i == 1 else int(
            rng.integers(1, 4)))
        ids = np.full(t, CHARS)
        m = t // max(len(chars), 1)
        for j, c in enumerate(chars):
            ids[j * m:j * m + int(rng.integers(1, m))] = c
        frames = protos[ids] + 0.5 * rng.normal(size=(t, HEIGHT))
        frames = np.concatenate([frames, np.repeat(
            protos[CHARS][None], WIDTH - t, axis=0)])
        out.append((frames.T.reshape(-1).astype(np.float32),
                    chars.tolist()))
    return out


def _feeding(types):
    return {"audio": types.dense_vector(HEIGHT * WIDTH),
            "text": types.integer_value_sequence(CHARS)}


def _params(jcost):
    rng = np.random.default_rng(0)
    specs = JNetwork(jcost.graph, outputs=[jcost.name]).param_specs
    out = {}
    for k, s in sorted(specs.items()):
        p = (rng.normal(size=s.shape) * 0.3).astype(np.float32)
        out[k] = np.abs(p) + 0.5 if k.endswith(".w2") else p
    return out


def _trainers(jcost, tcost, params, lr):
    jtr = JSGD(cost=jcost, update_equation=JAdam(learning_rate=lr),
               parameters={k: jnp.asarray(v) for k, v in params.items()})
    ttr = TSGD(cost=tcost, update_equation=TAdam(learning_rate=lr),
               parameters=params_from_numpy(params, device="cpu"),
               device="cpu")
    return jtr, ttr


@pytest.mark.parametrize("use_gru", [True, False], ids=["gru", "simple_rnn"])
def test_geometry_and_parameters_match_jax(use_gru):
    """Both graphs name the same layers and parameters, with the same
    shapes; the convs give 21 -> 11 -> 6 rows and 31 -> 11 -> 11 columns,
    so block_expand gives 11 steps of 4 * 6 features."""
    jcost, tcost = _build(use_gru)
    assert list(tcost.graph.layers) == list(jcost.graph.layers)
    jspec = JNetwork(jcost.graph, outputs=[jcost.name]).param_specs
    tnet = TNetwork(tcost.graph, outputs=[tcost.name])
    assert {k: tuple(s.shape) for k, s in jspec.items()} == \
        {k: tuple(s.shape) for k, s in tnet.param_specs.items()}
    assert {k: s.initial_std for k, s in jspec.items()} == \
        {k: s.initial_std for k, s in tnet.param_specs.items()}
    assert [(i.channels, i.height, i.width) for n, i in
            tnet.shape_infos.items() if n.endswith("_bn")
            and n.startswith("conv")] == [(4, 11, 11), (4, HOUT, STEPS)]
    assert tnet.shape_infos["conv2seq"].size == 4 * HOUT
    assert tnet.shape_infos["conv2seq"].is_sequence


@pytest.mark.parametrize("use_gru", [True, False], ids=["gru", "simple_rnn"])
def test_probabilities_cost_and_every_gradient_match_jax(use_gru):
    jcost, tcost = _build(use_gru)
    params = _params(jcost)
    batch = _samples(np.random.default_rng(1), 4)
    with common.force_mode("interpret"):
        jtr, ttr = _trainers(jcost, tcost, params, 1e-3)
        jfeed = JFeeder(_feeding(jtypes), pad_multiple=4)(batch)
        tfeed = TFeeder(_feeding(ttypes), pad_multiple=4,
                        device="cpu")(batch)
        jnet = JNetwork(jcost.graph, outputs=["cost", "probs"])
        tnet = TNetwork(tcost.graph, outputs=["cost", "probs"])
        jouts = jnet.apply(jtr.params, jfeed, train=True)
        touts = tnet.apply(ttr.params, tfeed, train=True)
        for name in ("probs", "cost", "conv2seq"):
            np.testing.assert_allclose(touts[name].value.detach().numpy(),
                                       np.asarray(jouts[name].value),
                                       **FWD_TOL, err_msg=name)
        assert touts["probs"].value.shape == (4, STEPS, CHARS + 1)

        def jloss(p):
            return jtr._total_cost(jtr.network.apply(p, jfeed, train=True),
                                   jtr._row_mask(jfeed))

        jl, jg = jax.jit(jax.value_and_grad(jloss))(jtr.params)
    _, tl, tg, _ = ttr.loss_and_grads(tfeed)
    np.testing.assert_allclose(float(tl), float(jl), **FWD_TOL)
    trained = sorted(k for k, s in tnet.param_specs.items()
                     if not s.is_static)
    assert sorted(tg) == trained  # JAX's grads hold the statistics' too
    for k in trained:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("use_gru", [True, False], ids=["gru", "simple_rnn"])
def test_adam_trajectory_matches_jax(use_gru):
    """3 Adam steps: each step's cost, then every parameter (the moving
    statistics folded in by the step included)."""
    jcost, tcost = _build(use_gru)
    params = _params(jcost)
    rng = np.random.default_rng(4)
    batches = [_samples(rng, 4) for _ in range(3)]
    jcosts, tcosts = [], []
    with common.force_mode("interpret"):
        jtr, ttr = _trainers(jcost, tcost, params, 1e-2)
        jtr.train(lambda: iter(batches),
                  feeder=JFeeder(_feeding(jtypes), pad_multiple=4),
                  num_passes=1, event_handler=lambda e: jcosts.append(
                      e.cost) if isinstance(e, jev.EndIteration) else None)
    ttr.train(lambda: iter(batches),
              feeder=TFeeder(_feeding(ttypes), pad_multiple=4, device="cpu"),
              num_passes=1, event_handler=lambda e: tcosts.append(
                  e.cost) if isinstance(e, tev.EndIteration) else None)
    assert len(tcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    assert sorted(ttr.params) == sorted(jtr.params)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(ttr.params[k].numpy(), np.asarray(v),
                                   **RUN_TOL, err_msg=k)


@pytest.mark.parametrize("block,stride,pad", [((3, 2), (2, 1), (1, 0)),
                                              ((1, 5), (1, 1), (0, 0)),
                                              ((2, 3), (3, 2), (2, 1))])
def test_block_expand_order_and_all_ones_mask(block, stride, pad):
    """Features in (C, block_y, block_x) order and positions row-major over
    (out_y, out_x), against JAX and against an explicit loop over the
    zero-padded NCHW image; every step real (all-ones mask) for every row
    of the batch."""
    (bx, by), (sx, sy), (px, py) = block, stride, pad
    C, H, W = 3, 5, 7
    x = np.random.default_rng(bx * 7 + by).normal(
        size=(2, C * H * W)).astype(np.float32)

    def build(dsl, mc):
        dsl.reset()
        d = dsl.data(name="x", size=C * H * W, channels=C, height=H, width=W)
        return dsl.block_expand_layer(input=d, block_x=bx, block_y=by,
                                      stride_x=sx, stride_y=sy, padding_x=px,
                                      padding_y=py, name="seq")
    build(jdsl, jmc)
    jout = JNetwork(jdsl.current_graph(), outputs=["seq"]).apply(
        {}, {"x": JArgument(value=jnp.asarray(x))})["seq"]
    build(tdsl, tmc)
    tout = TNetwork(tdsl.current_graph(), outputs=["seq"]).apply(
        {}, {"x": TArgument(value=torch.from_numpy(x))})["seq"]
    img = np.pad(x.reshape(2, C, H, W), ((0, 0), (0, 0), (py, py), (px, px)))
    oh = (H + 2 * py - by) // sy + 1
    ow = (W + 2 * px - bx) // sx + 1
    want = np.stack([img[:, :, i * sy:i * sy + by, j * sx:j * sx + bx]
                     .reshape(2, -1) for i in range(oh) for j in range(ow)],
                    axis=1)
    np.testing.assert_array_equal(tout.value.numpy(), want)
    np.testing.assert_allclose(np.asarray(jout.value), want, atol=1e-6)
    np.testing.assert_array_equal(tout.mask.numpy(), np.ones((2, oh * ow)))
    np.testing.assert_array_equal(np.asarray(jout.mask), tout.mask.numpy())
