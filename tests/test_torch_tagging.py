"""The port's sequence-tagging slice against the JAX package, on the CPU:
``bilstm_crf_tagger`` at a tiny width (vocab 50, embed 12, hidden 12, 5
labels: IOB over 2 chunk types plus O), with the reference demo's
labelled ``crf_decoding_layer`` sharing the transitions and its two
evaluators, ``sum`` (the share of sentences decoded wrong) and ``chunk``
(chunk F1). Parameters carry across by name (``compat/from_jax.py``);
batches have ragged lengths and some are row-padded by the feeder's batch
bucket.

The JAX side runs under ``force_mode("interpret")``, so its Pallas CRF
kernel and custom_vjp and its LSTM kernel are taken.

- the graph: layer names and types, parameter names and shapes (the CRF
  transitions shared by name), the evaluator entries;
- the loss and every parameter gradient of one batch; the decode;
- a 3-step Adam trajectory, then ``test()``: cost, ``error`` and
  ``chunk_f1`` against the JAX ``SGD.test`` on the same batches;
- ``--job train|test|merge|serve`` on ``--device cpu`` through a config
  file, the served ids equal to the plain path's;
- a JAX-merged PTM1 tagger served by the port with the JAX predictor's
  decoded ids over the padded batch.

Tolerances: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 (f32 sums in
other orders through two recurrences and the CRF); trajectories rtol/atol
1e-4; decoded ids and evaluator values equal (1e-6).
"""

import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config.model_config import ParamAttr as JParamAttr
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.models.tagging import bilstm_crf_tagger as j_tagger
from paddle_tpu.ops import common
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.serving import ServingClient
from paddle_tpu.serving import ServingPredictor as JPredictor
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer import events as jev
from paddle_tpu.trainer.merge_model import merge_model as j_merge_model
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config.model_config import ParamAttr as TParamAttr
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.models.tagging import bilstm_crf_tagger as t_tagger
from paddle_tpu_torch.optim import Adam as TAdam
from paddle_tpu_torch.serving import ServingPredictor as TPredictor
from paddle_tpu_torch.trainer import cli
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.metrics import build_from_configs
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

V, E, H, L, T = 50, 12, 12, 5, 8
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
BUCKETS = [4]
MODEL = dict(vocab_size=V, embed_dim=E, hidden=H, num_labels=L)
SERVE = dict(batch_buckets=[1, 2, 4], length_buckets=[8])


@pytest.fixture(autouse=True)
def _jax_kernels():
    """The JAX Pallas kernels of the slice (CRF, LSTM) in interpret mode."""
    with common.force_mode("interpret"):
        yield


def _build(dsl, tagger, attr_cls):
    """The tagger plus the reference demo's evaluation branch: a labelled
    ``crf_decoding_layer`` on the same transitions, ``sum`` over its error
    indicator and ``chunk`` F1 over its decoded ids."""
    cost, decoded, _ = tagger(**MODEL)
    emission, label = dsl.LayerOutput("emission", L), dsl.LayerOutput(
        "label", L)
    checked = dsl.crf_decoding_layer(input=emission, size=L, label=label,
                                     param_attr=attr_cls(
                                         name="crf_transitions"),
                                     name="crf_check")
    dsl.evaluator("sum", checked, name="error")
    dsl.evaluator("chunk", checked, label=label, name="chunk_f1",
                  chunk_scheme="IOB", num_chunk_types=(L - 1) // 2)
    return cost, decoded


def _samples(rng, n):
    """(words, tags): tag = word % L, a rule the tagger can learn."""
    out = []
    for _ in range(n):
        w = rng.integers(0, V, size=int(rng.integers(1, T + 1)))
        out.append((w.tolist(), (w % L).tolist()))
    return out


def _batches(seed, sizes=(4, 3, 4)):
    rng = np.random.default_rng(seed)
    return [_samples(rng, n) for n in sizes]


def _feeding(types):
    return {"word": types.integer_value_sequence(V),
            "label": types.integer_value_sequence(L)}


def _jfeeder():
    return JFeeder(_feeding(jtypes), pad_multiple=T, batch_buckets=BUCKETS)


def _tfeeder():
    return TFeeder(_feeding(ttypes), pad_multiple=T, batch_buckets=BUCKETS,
                   device="cpu")


@pytest.fixture(scope="module")
def model():
    """(JAX cost, port cost, shared numpy parameters), every parameter
    random, the LSTM biases and peepholes included."""
    jdsl.reset()
    jcost, jdec = _build(jdsl, j_tagger, JParamAttr)
    tdsl.reset()
    tcost, _ = _build(tdsl, t_tagger, TParamAttr)
    rng = np.random.default_rng(0)
    specs = JNetwork(jcost.graph, outputs=[jcost.name, jdec.name]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
              for k, s in specs.items()}
    return jcost, tcost, params


def _jsgd(model, opt):
    jcost, _, params = model
    return JSGD(cost=jcost, update_equation=opt, extra_layers=["crf_decode"],
                parameters={k: jnp.asarray(v) for k, v in params.items()})


def _tsgd(model, opt):
    _, tcost, params = model
    return TSGD(cost=tcost, update_equation=opt, extra_layers=["crf_decode"],
                parameters=params_from_numpy(params, device="cpu"),
                device="cpu")


def test_graph_parameters_and_evaluators_match_jax(model):
    jcost, tcost, params = model
    jg, tg = jcost.graph, tcost.graph
    assert list(tg.layers) == list(jg.layers)
    for name, jl in jg.layers.items():
        tl = tg.layers[name]
        assert (tl.type, tl.size, tl.act, tl.input_names(), tl.bias) == (
            jl.type, jl.size, jl.act, jl.input_names(), jl.bias), name
    assert tg.evaluators == jg.evaluators
    outs = ["crf_cost", "crf_decode", "crf_check"]
    jspecs = JNetwork(jg, outputs=outs).param_specs
    tspecs = TNetwork(tg, outputs=outs).param_specs
    assert sorted(tspecs) == sorted(jspecs) == sorted(params)
    for k, spec in jspecs.items():
        assert tuple(tspecs[k].shape) == tuple(spec.shape), k
    # the three CRF layers share one (C+2, C) parameter by name
    assert tspecs["crf_transitions"].shape == (L + 2, L)
    assert not any(k.startswith("_crf") for k in tspecs)
    # the trainer grows its sub-graph to the evaluation branch
    tr = _tsgd(model, TAdam())
    assert "crf_check" in tr.network.order
    assert [e.name for e, _, _ in tr._host_evals] == ["error", "chunk_f1"]


def test_loss_every_gradient_and_decode_match_jax(model):
    jtr = _jsgd(model, JAdam())
    ttr = _tsgd(model, TAdam())
    batch = _batches(5, sizes=(3,))[0]  # row-padded to the bucket of 4
    jfeed, tfeed = _jfeeder()(batch), _tfeeder()(batch)

    def jloss(p):
        return jtr._total_cost(jtr.network.apply(p, jfeed, train=True),
                               jtr._row_mask(jfeed))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jtr.params)
    _, tl, tg, _ = ttr.loss_and_grads(tfeed)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)
    names = ["crf_decode", "crf_check"]
    jout = jtr.forward(jfeed, names)
    tout = ttr.forward(tfeed, names)
    for n in names:
        np.testing.assert_array_equal(tout[n].value.numpy(),
                                      np.asarray(jout[n].value))
    np.testing.assert_array_equal(tout["crf_check"].state["ids"].numpy(),
                                  np.asarray(jout["crf_check"].state["ids"]))


def test_adam_trajectory_and_test_evaluators_match_jax(model):
    """3 Adam steps, then ``test()`` on 2 batches: the cost of every step,
    the final parameters, the test cost and the ``error`` and
    ``chunk_f1`` evaluators (live rows only) equal JAX's."""
    batches = _batches(9)
    jtr = _jsgd(model, JAdam(learning_rate=5e-3))
    ttr = _tsgd(model, TAdam(learning_rate=5e-3))
    jcosts, tcosts, jpass, tpass = [], [], [], []

    def handler(costs, ends, events):
        return lambda e: (costs.append(e.cost) if isinstance(
            e, events.EndIteration) else ends.append(e.evaluator)
            if isinstance(e, events.EndPass) else None)

    jtr.train(lambda: iter(batches), feeder=_jfeeder(), num_passes=1,
              event_handler=handler(jcosts, jpass, jev))
    ttr.train(lambda: iter(batches), feeder=_tfeeder(), num_passes=1,
              event_handler=handler(tcosts, tpass, tev))
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(ttr.params[k].numpy(), np.asarray(v),
                                   **RUN_TOL, err_msg=k)
    assert set(tpass[0]) == set(jpass[0]) == {"error", "chunk_f1"}
    assert tpass[0] == pytest.approx(jpass[0], abs=1e-6)
    test_batches = _batches(21, sizes=(4, 2))
    jres = jtr.test(lambda: iter(test_batches), feeder=_jfeeder())
    tres = ttr.test(lambda: iter(test_batches), feeder=_tfeeder())
    np.testing.assert_allclose(tres.cost, jres.cost, **RUN_TOL)
    assert set(tres.evaluator) == {"error", "chunk_f1"}
    assert tres.evaluator == pytest.approx(jres.evaluator, abs=1e-6)


def test_unported_evaluator_types_raise_naming_themselves():
    with pytest.raises(NotImplementedError, match="'auc'"):
        build_from_configs([{"type": "auc", "input_layers": ["x", "y"]}])
    assert build_from_configs([{"type": "no_such_type",
                                "input_layers": ["x"]}]) == []


_CONF = textwrap.dedent(f"""
    import numpy as np
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.model_config import ParamAttr
    from paddle_tpu_torch.data.types import integer_value_sequence
    from paddle_tpu_torch.models.tagging import bilstm_crf_tagger
    from paddle_tpu_torch.optim import Adam
    cost, decoded, _ = bilstm_crf_tagger(vocab_size={V}, embed_dim={E},
                                         hidden={H}, num_labels={L})
    checked = dsl.crf_decoding_layer(
        input=dsl.LayerOutput("emission", {L}), size={L},
        label=dsl.LayerOutput("label", {L}),
        param_attr=ParamAttr(name="crf_transitions"), name="crf_check")
    dsl.evaluator("sum", checked, name="error")
    dsl.evaluator("chunk", checked, label=dsl.LayerOutput("label", {L}),
                  name="chunk_f1", chunk_scheme="IOB",
                  num_chunk_types={(L - 1) // 2})
    outputs = [decoded]
    optimizer = Adam(learning_rate=1e-2)
    feeding = {{"word": integer_value_sequence({V}),
               "label": integer_value_sequence({L})}}

    def train_reader():
        rng = np.random.default_rng(0)
        for _ in range(3):
            batch = []
            for _ in range(4):
                w = rng.integers(0, {V}, size=int(rng.integers(1, {T + 1})))
                batch.append((w.tolist(), (w % {L}).tolist()))
            yield batch

    test_reader = train_reader
""")

_SERVE_CONF = textwrap.dedent(f"""
    from paddle_tpu_torch.data.types import integer_value_sequence
    from paddle_tpu_torch.models.tagging import bilstm_crf_tagger
    cost, decoded, _ = bilstm_crf_tagger(vocab_size={V}, embed_dim={E},
                                         hidden={H}, num_labels={L})
    outputs = [decoded]
    feeding = {{"word": integer_value_sequence({V})}}
""")


def test_cli_train_test_merge_serve_on_cpu(tmp_path, capsys):
    """train, test and merge through ``cli.main`` in this process; serve
    as its own process, with a config whose feeding is the word slot
    alone, answering Viterbi ids over the padded batch."""
    conf, serve_conf = tmp_path / "conf.py", tmp_path / "serve_conf.py"
    conf.write_text(_CONF)
    serve_conf.write_text(_SERVE_CONF)
    save_dir, model = tmp_path / "ckpt", tmp_path / "tagger.ptmodel"

    def _cli(*args):
        assert cli.main(list(args)) == 0
        return capsys.readouterr().out

    out = _cli("--config", str(conf), "--job", "train", "--device", "cpu",
               "--num_passes", "3", "--save_dir", str(save_dir))
    passes = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    costs = [float(p.split("cost=")[1].split()[0]) for p in passes]
    assert len(costs) == 3 and costs[-1] < costs[0]
    assert all("chunk_f1=" in p and "error=" in p for p in passes)
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    assert summary["steps"] == 9
    for name in ("crf_alpha_fwd", "crf_bwd", "crf_viterbi"):
        assert summary["kernels"][name] == {"launches": 0}  # plain on CPU
    out = _cli("--config", str(conf), "--job", "test", "--device", "cpu",
               "--save_dir", str(save_dir))
    line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    assert "chunk_f1=" in line and "error=" in line
    assert "crf_viterbi" in json.loads(next(
        ln for ln in out.splitlines()
        if ln.startswith("test_summary "))[13:])["kernels"]
    _cli("--config", str(conf), "--job", "merge", "--device", "cpu",
         "--save_dir", str(save_dir), "--model_path", str(model))

    rows = _samples(np.random.default_rng(3), 3)
    words = [[w] for w, _ in rows]
    want, _ = TPredictor.from_merged(
        str(model), {"word": ttypes.integer_value_sequence(V)},
        device="cpu", **SERVE).predict_rows(words)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", "--config",
         str(serve_conf), "--job", "serve", "--init_model_path", str(model),
         "--device", "cpu", "--max_batch", "4",
         "--serving_length_buckets", "8", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), proc.stderr.read()
        client = ServingClient(port=int(line.split()[2].rsplit(":", 1)[1]))
        got = [client.score(w)["outputs"]["crf_decode"] for w in words[:1]]
        got += [r["outputs"]["crf_decode"] for r in client.score_rows(words)]
        assert client.healthz()["kernels"]["crf_viterbi"] == {"launches": 0}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    # [T, 1] int ids per row, the padded steps included
    np.testing.assert_array_equal(np.asarray(got[0]), want["crf_decode"][0])
    np.testing.assert_array_equal(np.asarray(got[1:]),
                                  want["crf_decode"][:3])
    assert want["crf_decode"].dtype == np.int32


def test_port_serves_jax_merged_tagger_like_jax(model, tmp_path):
    """A PTM1 file merged by the JAX package with ``outputs=[crf_decode]``:
    the port's predictor returns the JAX predictor's decoded ids over the
    padded batch, bucket for bucket."""
    jcost, _, params = model
    path = tmp_path / "jax_tagger.ptmodel"
    j_merge_model(str(path), jcost.graph, params, outputs=["crf_decode"])
    port = TPredictor.from_merged(
        str(path), {"word": ttypes.integer_value_sequence(V)}, device="cpu",
        **SERVE)
    ref = JPredictor.from_merged(
        str(path), {"word": jtypes.integer_value_sequence(V)}, **SERVE)
    rng = np.random.default_rng(7)
    for n in (1, 3, 4):
        rows = [[w] for w, _ in _samples(rng, n)]
        got, ginfo = port.predict_rows(rows)
        want, winfo = ref.predict_rows(rows)
        assert ginfo["bucket"] == winfo["bucket"]
        assert got["crf_decode"].dtype == want["crf_decode"].dtype
        np.testing.assert_array_equal(got["crf_decode"], want["crf_decode"])
