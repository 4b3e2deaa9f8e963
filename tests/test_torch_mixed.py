"""The port's ``mixed`` layer (``layers/common.py``) against the JAX
package's, on the CPU: each projection (full_matrix, trans_full_matrix,
identity, dot_mul, table with ids and with ``dense_argmax_ids``, scaling,
slice, context over sequences and over non-sequence rows, with static and
trainable padding, conv and convt with non-square filters, strides and
groups) and each operator (dot_mul_op, conv_op, convt_op), several in one
layer, the image/flat split (a conv output keeps its geometry; conv and
flat terms in one layer refuse in both packages), and ``concat2`` over
flat and conv projections. Forward at rtol/atol 1e-5; the gradients of a
fixed random weighting of the output with respect to every trained
parameter and float input at rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config import model_config as jmc
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config import model_config as tmc
from paddle_tpu_torch.core.network import Network as TNetwork

from test_torch_layer_matrix import FWD_TOL, GRAD_TOL, run_pair

B = 3
RNG = np.random.default_rng(0)


def _dense(d, b=B, seed=0):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _seq(d, t=5, seed=0):
    r = np.random.default_rng(seed)
    mask = np.ones((B, t), np.float32)
    mask[1, 3:] = 0
    mask[2, 1:] = 0
    v = r.normal(size=(B, t, d)).astype(np.float32) * mask[..., None]
    return v, mask


def _img(c, h, w, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, h, w, c)).astype(np.float32)


# name -> (data layers [(name, size, kwargs)], layer size, projections,
# operators, feed {name: (value, mask)})
CASES = {
    "full_matrix": ([("a", 6, {})], 4, [{"type": "full_matrix"}], None,
                    {"a": (_dense(6), None)}),
    "trans_full_matrix": ([("a", 6, {})], 4,
                          [{"type": "trans_full_matrix"}], None,
                          {"a": (_dense(6), None)}),
    "identity_and_dot_mul": ([("a", 4, {}), ("b", 4, {})], 4,
                             [{"type": "identity"}, {"type": "dot_mul"}],
                             None, {"a": (_dense(4), None),
                                    "b": (_dense(4, seed=1), None)}),
    "table_ids": ([("a", 7, {"is_sequence": True})], 4,
                  [{"type": "table", "vocab_size": 7}], None,
                  {"a": (np.array([[0, 3, 6, 2, 1], [5, 5, 4, 0, 0],
                                   [1, 0, 0, 0, 0]], np.int32),
                         _seq(1)[1])}),
    "table_dense_argmax": ([("a", 5, {})], 3,
                           [{"type": "table", "vocab_size": 5,
                             "dense_argmax_ids": True}], None,
                           {"a": (_dense(5), None)}),
    "scaling": ([("a", 4, {})], 4, [{"type": "scaling"}], None,
                {"a": (_dense(4), None)}),
    "slice": ([("a", 8, {})], 5,
              [{"type": "slice", "slices": [(0, 2), (5, 8)]}], None,
              {"a": (_dense(8), None)}),
    "context_static": ([("a", 3, {"is_sequence": True})], 9,
                       [{"type": "context", "context_start": -1,
                         "context_length": 3}], None,
                       {"a": _seq(3)}),
    "context_trainable": ([("a", 3, {"is_sequence": True})], 12,
                          [{"type": "context", "context_start": -2,
                            "context_length": 4,
                            "trainable_padding": True}], None,
                          {"a": _seq(3, seed=2)}),
    "context_ahead_no_pad": ([("a", 3, {"is_sequence": True})], 6,
                             [{"type": "context", "context_start": 0,
                               "context_length": 2}], None,
                             {"a": _seq(3, seed=3)}),
    "context_non_sequence": ([("a", 3, {})], 9,
                             [{"type": "context", "context_start": -1,
                               "context_length": 3,
                               "trainable_padding": True}], None,
                             {"a": (_dense(3), None)}),
    "sequence_sum": ([("a", 3, {"is_sequence": True}),
                      ("b", 4, {"is_sequence": True})], 4,
                     [{"type": "full_matrix"}, {"type": "identity"}], None,
                     {"a": _seq(3), "b": _seq(4, seed=1)}),
    "conv": ([("x", 2 * 6 * 7, {"channels": 2, "height": 6, "width": 7})],
             None, [{"type": "conv", "filter_size": 3, "filter_size_y": 2,
                     "num_filters": 4, "stride": 2, "stride_y": 1,
                     "padding": 1, "padding_y": 0, "num_channels": 2}],
             None, {"x": (_img(2, 6, 7), None)}),
    "conv_groups_flat_input": ([("x", 4 * 5 * 5, {})], None,
                               [{"type": "conv", "filter_size": 3,
                                 "num_filters": 6, "padding": 1,
                                 "groups": 2, "num_channels": 4}], None,
                               {"x": (_dense(100), None)}),
    "convt": ([("x", 3 * 4 * 5, {"channels": 3, "height": 4, "width": 5})],
              None, [{"type": "convt", "filter_size": 3, "filter_size_y": 2,
                      "num_filters": 2, "stride": 2, "padding": 1,
                      "padding_y": 0, "num_channels": 3}], None,
              {"x": (_img(3, 4, 5), None)}),
    "dot_mul_op": ([("a", 4, {}), ("b", 4, {}), ("c", 5, {})], 4,
                   [{"type": "identity_op_arg"}, {"type": "identity_op_arg"},
                    {"type": "full_matrix"}],
                   [{"type": "dot_mul_op", "input_indices": [0, 1],
                     "scale": 0.5}],
                   {"a": (_dense(4), None), "b": (_dense(4, seed=1), None),
                    "c": (_dense(5, seed=2), None)}),
    "conv_op": ([("x", 2 * 5 * 6, {"channels": 2, "height": 5, "width": 6}),
                 ("f", 3 * 2 * 2 * 3, {})], None,
                [{"type": "identity_op_arg"}, {"type": "identity_op_arg"}],
                [{"type": "conv_op", "input_indices": [0, 1],
                  "filter_size": 3, "filter_size_y": 2, "num_filters": 3,
                  "stride": 1, "stride_y": 2, "padding": 1,
                  "num_channels": 2}],
                {"x": (_img(2, 5, 6), None), "f": (_dense(36, seed=4),
                                                   None)}),
    "convt_op": ([("x", 2 * 3 * 4, {"channels": 2, "height": 3, "width": 4}),
                  ("f", 3 * 2 * 3 * 3, {})], None,
                 [{"type": "identity_op_arg"}, {"type": "identity_op_arg"}],
                 [{"type": "convt_op", "input_indices": [0, 1],
                   "filter_size": 3, "num_filters": 3, "stride": 2,
                   "padding": 1, "num_channels": 2}],
                 {"x": (_img(2, 3, 4), None), "f": (_dense(54, seed=5),
                                                    None)}),
}


def _pair(data, size, projs, ops, type_="mixed", bias=True, act="tanh"):
    """Both packages' networks of one mixed (or concat2) layer "out"."""
    nets = []
    for dsl, mc, Net in ((jdsl, jmc, JNetwork), (tdsl, tmc, TNetwork)):
        dsl.reset()
        for name, s, kw in data:
            dsl.data(name=name, size=s, **kw)
        attrs = {"projections": [dict(p) for p in projs]}
        if ops:
            attrs["operators"] = [dict(o) for o in ops]
        dsl._add(mc.LayerDef(name="out", type=type_, size=size, act=act,
                             bias=bias, attrs=attrs,
                             inputs=[mc.Input(n) for n, _, _ in data]))
        nets.append(Net(dsl.current_graph(), outputs=["out"]))
    jnet, tnet = nets
    assert {k: tuple(s.shape) for k, s in jnet.param_specs.items()} == \
        {k: tuple(s.shape) for k, s in tnet.param_specs.items()}
    assert vars(jnet.shape_infos["out"]) == vars(tnet.shape_infos["out"])
    params = {k: (RNG.normal(size=s.shape) * 0.5).astype(np.float32)
              for k, s in sorted(jnet.param_specs.items())}
    return jnet, tnet, params


def _check(jnet, tnet, feed, params):
    tout, jout, grads = run_pair(jnet, tnet, "out", feed, params)
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_allclose(tout.detach().numpy(), jout, **FWD_TOL)
    assert grads
    for n, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=n)
    return tnet.shape_infos["out"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_projection_or_operator_matches_jax(case):
    data, size, projs, ops, feed = CASES[case]
    jnet, tnet, params = _pair(data, size, projs, ops)
    info = _check(jnet, tnet, feed, params)
    image = case.startswith("conv")
    # the image/flat split: conv terms give the output image geometry
    assert (info.channels is not None) == image


@pytest.mark.parametrize("case", ["conv_plus_flat", "conv_op_plus_dot_mul"])
def test_conv_and_flat_terms_refuse_in_both(case):
    if case == "conv_plus_flat":
        data = [("x", 2 * 4 * 4, {"channels": 2, "height": 4, "width": 4}),
                ("a", 5, {})]
        projs = [{"type": "conv", "filter_size": 3, "num_filters": 2,
                  "padding": 1, "num_channels": 2}, {"type": "full_matrix"}]
        ops = None
    else:
        data = [("x", 2 * 4 * 4, {"channels": 2, "height": 4, "width": 4}),
                ("f", 2 * 2 * 9, {}), ("a", 4, {}), ("b", 4, {})]
        projs = [{"type": "identity_op_arg"}] * 4
        ops = [{"type": "conv_op", "input_indices": [0, 1],
                "filter_size": 3, "num_filters": 2, "padding": 1,
                "num_channels": 2},
               {"type": "dot_mul_op", "input_indices": [2, 3]}]
    jnet, tnet, params = _pair(data, 4, projs, ops)
    feed = {n: (_dense(s, seed=i) if not kw else
                _img(kw["channels"], kw["height"], kw["width"]), None)
            for i, (n, s, kw) in enumerate(data)}
    with pytest.raises(NotImplementedError, match="cannot combine"):
        run_pair(jnet, tnet, "out", feed, params, grads=False)
    # the JAX executor wraps the layer's error with its layer stack
    with pytest.raises(Exception, match="cannot combine") as err:
        jnet.apply({k: jnp.asarray(v) for k, v in params.items()},
                   {k: JArgument(value=jnp.asarray(v))
                    for k, (v, _) in feed.items()})
    assert isinstance(err.value.__cause__, NotImplementedError)


@pytest.mark.parametrize("conv", [False, True], ids=["flat", "conv"])
def test_concat2_matches_jax(conv):
    if conv:
        data = [("x", 2 * 5 * 5, {"channels": 2, "height": 5, "width": 5}),
                ("y", 3 * 5 * 5, {"channels": 3, "height": 5, "width": 5})]
        projs = [{"type": "conv", "filter_size": 3, "num_filters": 2,
                  "padding": 1, "num_channels": 2},
                 {"type": "conv", "filter_size": 1, "num_filters": 3,
                  "num_channels": 3}]
        feed = {"x": (_img(2, 5, 5), None), "y": (_img(3, 5, 5, 1), None)}
    else:
        data = [("a", 6, {}), ("b", 4, {}), ("c", 3, {"is_sequence": False})]
        projs = [{"type": "full_matrix", "size": 4},
                 {"type": "identity", "size": 4},
                 {"type": "dot_mul", "size": 3}]
        feed = {"a": (_dense(6), None), "b": (_dense(4, seed=1), None),
                "c": (_dense(3, seed=2), None)}
    jnet, tnet, params = _pair(data, None, projs, None, type_="concat2")
    info = _check(jnet, tnet, feed, params)
    assert info.channels == (5 if conv else None)
