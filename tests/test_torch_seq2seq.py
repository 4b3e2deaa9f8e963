"""The port's seq2seq training slice against the JAX package, on the CPU:
``seq2seq_attention`` at a tiny width (source dict 20, target dict 12,
embed 16, hidden 16; as ``tests/test_seq_models.py`` builds it), the same
parameters carried across by name and the same batches (ragged source and
target lengths up to 6, some batches row-padded by the feeder's batch
bucket, so dead rows cross the encoder and the recurrent group).

The JAX side runs under ``force_mode("interpret")`` and ``fused_rnn(True)``,
so its Pallas kernels are taken: ``ops/gru.py:_gru_kernel`` (the
bidirectional encoder), ``kernels/rnn_cells.py:_gru_cell_kernel`` (the
decoder's ``gru_step`` inside the group's ``lax.scan``) and, with
``seq_parallel``, ``ops/attention.py:_flash_kernel``.

- the graph: layer names and types, parameter names and shapes, the
  group's auto-names;
- the layers the slice adds (sequence_softmax, scaling, expand, addto,
  concat, sum/average/sqrt/max/first/last pooling) and the recurrent
  group's own features (reverse, a constant-initialised memory, a static
  input, a second out-link), forward and gradients;
- the loss and every parameter gradient of one batch, and the eval
  forward;
- a 5-step Adam trajectory and ``test()``;
- checkpoints both ways (the JAX ``Checkpointer`` reads a port save
  directory);
- the CLI: ``--job train`` then ``--job test`` on ``--device cpu``;
- the model with ``seq_parallel="ring"`` (the encoder self-attention
  block, 2 heads of 8; JAX's flash kernel interpreted too): graph and
  parameter names, the loss and every gradient, and the CLI;
- generation: the generating graph and its parameter names (the training
  graph's), beams equal to JAX's ``SequenceGenerator`` (chunked and full
  scan), and ``--job merge`` of a generating config from a training save
  dir, read back by both packages and served (``kind="generate"``).

Tolerances: forward rtol/atol 1e-5; loss rtol 1e-5; gradients rtol 1e-4 /
atol 1e-5 (f32 sums in other orders, through both recurrences);
trajectories and checkpoints rtol/atol 1e-4 (those differences compounded
over up to 5 Adam updates).
"""

import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as jkernels
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.dist.checkpoint import Checkpointer as JCheckpointer
from paddle_tpu.models.seq2seq import seq2seq_attention as j_seq2seq
from paddle_tpu.ops import common
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer import events as jev
from paddle_tpu.trainer.checkpoint import save_params as j_save_params
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.models.seq2seq import seq2seq_attention as t_seq2seq
from paddle_tpu_torch.optim import Adam as TAdam
from paddle_tpu_torch.trainer import cli
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.checkpoint import load_params, save_generation
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

SV, TV, E, H, T = 20, 12, 16, 16, 6
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
BUCKETS = [4]
MODEL = dict(src_vocab=SV, trg_vocab=TV, embed_dim=E, hidden=H)
# the encoder self-attention block: 2 heads of 8 over the 16-wide embedding
HEADS = 2


@pytest.fixture(autouse=True)
def _jax_kernels():
    """Both JAX Pallas kernels of the slice, in interpret mode."""
    with common.force_mode("interpret"), jkernels.fused_rnn(True):
        yield


def _batches(seed, sizes=(4, 3, 4, 4, 2)):
    """(source, target_words, target_next) samples: the target is the
    source reversed (ids shifted past 0 = <s> and 1 = </s>), lengths 1-6."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        batch = []
        for _ in range(n):
            src = rng.integers(2, SV, size=int(rng.integers(1, T + 1)))
            trg = [2 + int(i) % (TV - 2) for i in src[::-1]]
            batch.append((src.tolist(), [0] + trg[:-1], trg))
        out.append(batch)
    return out


def _feeding(types):
    return {"source_words": types.integer_value_sequence(SV),
            "target_words": types.integer_value_sequence(TV),
            "target_next": types.integer_value_sequence(TV)}


def _jfeeder():
    return JFeeder(_feeding(jtypes), pad_multiple=T, batch_buckets=BUCKETS)


def _tfeeder():
    return TFeeder(_feeding(ttypes), pad_multiple=T, batch_buckets=BUCKETS,
                   device="cpu")


@pytest.fixture(scope="module")
def model():
    """(JAX cost, port cost, shared numpy parameters), every parameter
    random, the zero-initialised biases included."""
    jdsl.reset()
    jcost, _, _ = j_seq2seq(**MODEL)
    tdsl.reset()
    tcost, _, _ = t_seq2seq(**MODEL)
    rng = np.random.default_rng(0)
    jtr = JSGD(cost=jcost, update_equation=JAdam(), seed=1)
    params = {k: (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
              for k, v in jtr.params.items()}
    return jcost, tcost, params


def _jsgd(model, opt, params=None):
    jcost, _, base = model
    return JSGD(cost=jcost, update_equation=opt,
                parameters={k: jnp.asarray(v) for k, v in
                            (params or base).items()})


def _tsgd(model, opt, params=None):
    _, tcost, base = model
    return TSGD(cost=tcost, update_equation=opt, parameters=params or base,
                device="cpu")


def _assert_params_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **tol, err_msg=k)


def test_graph_and_parameter_names_match_jax(model):
    jcost, tcost, _ = model
    jg, tg = jcost.graph, tcost.graph
    assert list(tg.layers) == list(jg.layers)
    for name, jl in jg.layers.items():
        tl = tg.layers[name]
        assert (tl.type, tl.size, tl.act, tl.input_names()) == (
            jl.type, jl.size, jl.act, jl.input_names()), name
    group = tg.layers["decoder_group"]
    assert group.attrs["ins"] == jg.layers["decoder_group"].attrs["ins"]
    assert list(group.attrs["sub_model"].layers) == list(
        jg.layers["decoder_group"].attrs["sub_model"].layers)
    jspecs = JNetwork(jg, outputs=[jcost.name]).param_specs
    tspecs = TNetwork(tg, outputs=[tcost.name]).param_specs
    assert sorted(tspecs) == sorted(jspecs)
    for k, spec in jspecs.items():
        assert tuple(tspecs[k].shape) == tuple(spec.shape), k
        assert (tspecs[k].init, tspecs[k].sparse_grad) == (
            spec.init, spec.sparse_grad), k
    assert "_gru_decoder.w0" in tspecs and "_dec_in.w1" in tspecs


def _layer_graph(dsl, pooling_type):
    x = dsl.data(name="x", size=4, is_sequence=True)
    v = dsl.data(name="v", size=4)
    w = dsl.fc(input=x, size=1, act="sequence_softmax", name="w",
               bias_attr=False)
    scaled = dsl.scaling_layer(x, w, name="scaled")
    expanded = dsl.expand(v, x, name="expanded")
    comb = dsl.addto([expanded, x], act="tanh", name="comb", bias_attr=True)
    cat = dsl.concat([comb, scaled], name="cat")
    return dsl.pooling(input=cat, pooling_type=pooling_type, name="pooled")


@pytest.mark.parametrize("pooling_type",
                         ["sum", "average", "sqrt", "max", "first", "last"])
def test_slice_layers_match_jax(pooling_type):
    rng = np.random.default_rng(len(pooling_type))
    jdsl.reset()
    jout = _layer_graph(jdsl, pooling_type)
    tdsl.reset()
    tout = _layer_graph(tdsl, pooling_type)
    jnet = JNetwork(jout.graph, outputs=[jout.name])
    tnet = TNetwork(tout.graph, outputs=[tout.name])
    params = {k: (rng.normal(size=s.shape) * 0.5).astype(np.float32)
              for k, s in jnet.param_specs.items()}
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                    np.float32)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    v = rng.normal(size=(3, 4)).astype(np.float32)
    ct = rng.normal(size=(3, 8)).astype(np.float32)

    def jloss(p):
        outs = jnet.apply(p, {"x": JArgument(jnp.asarray(x),
                                             jnp.asarray(mask)),
                              "v": JArgument(jnp.asarray(v))})
        return jnp.sum(outs["pooled"].value * ct), outs

    (jl, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(p) for k, p in params.items()})
    tp = {k: torch.from_numpy(p).requires_grad_(True)
          for k, p in params.items()}
    touts = tnet.apply(tp, {"x": TArgument(torch.from_numpy(x),
                                           torch.from_numpy(mask)),
                            "v": TArgument(torch.from_numpy(v))})
    for name in ("w", "scaled", "expanded", "comb", "cat", "pooled"):
        np.testing.assert_allclose(touts[name].value.detach().numpy(),
                                   np.asarray(jouts[name].value), **FWD_TOL,
                                   err_msg=name)
    tl = (touts["pooled"].value * torch.from_numpy(ct)).sum()
    tg = torch.autograd.grad(tl, list(tp.values()))
    for k, g in zip(tp, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), **GRAD_TOL,
                                   err_msg=k)


def _group_graph(dsl, reverse):
    x = dsl.data(name="x", size=5, is_sequence=True)
    st = dsl.data(name="st", size=3)

    def step(x_t, s):
        mem = dsl.memory(name="h", size=6, boot_with_const_value=0.1)
        h = dsl.fc(input=[x_t, mem, s], size=6, act="tanh", name="h")
        o = dsl.fc(input=h, size=4, act="softmax", name="o")
        return o, h

    return dsl.recurrent_group(step, [x, dsl.StaticInput(st)],
                               reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_group_features_match_jax(reverse):
    """Auto-names, a constant-initialised memory, a static input, a second
    out-link (``group_output``), ``reverse`` and padded steps: outputs and
    every parameter gradient against the JAX ``lax.scan`` group."""
    jdsl.reset()
    jo, jh = _group_graph(jdsl, reverse)
    tdsl.reset()
    to, th = _group_graph(tdsl, reverse)
    assert (to.name, th.name) == (jo.name, jh.name) == (
        "__recurrent_group_0__", "__recurrent_group_0__@out_h")
    jnet = JNetwork(jo.graph, outputs=[jo.name, jh.name])
    tnet = TNetwork(to.graph, outputs=[to.name, th.name])
    assert sorted(tnet.param_specs) == sorted(jnet.param_specs) == [
        "_h.w0", "_h.w1", "_h.w2", "_h.wbias", "_o.w0", "_o.wbias"]
    rng = np.random.default_rng(int(reverse))
    params = {k: (rng.normal(size=s.shape) * 0.5).astype(np.float32)
              for k, s in jnet.param_specs.items()}
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    st = rng.normal(size=(3, 3)).astype(np.float32)
    co = rng.normal(size=(3, 4, 4)).astype(np.float32)
    ch = rng.normal(size=(3, 4, 6)).astype(np.float32)

    def jloss(p):
        outs = jnet.apply(p, {"x": JArgument(jnp.asarray(x),
                                             jnp.asarray(mask)),
                              "st": JArgument(jnp.asarray(st))})
        return (jnp.sum(outs[jo.name].value * co)
                + jnp.sum(outs[jh.name].value * ch)), outs

    (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(p) for k, p in params.items()})
    tp = {k: torch.from_numpy(p).requires_grad_(True)
          for k, p in params.items()}
    touts = tnet.apply(tp, {"x": TArgument(torch.from_numpy(x),
                                           torch.from_numpy(mask)),
                            "st": TArgument(torch.from_numpy(st))})
    for name in (jo.name, jh.name):
        np.testing.assert_allclose(touts[name].value.detach().numpy(),
                                   np.asarray(jouts[name].value), **FWD_TOL,
                                   err_msg=name)
        np.testing.assert_array_equal(touts[name].mask.numpy(), mask)
    tl = ((touts[to.name].value * torch.from_numpy(co)).sum()
          + (touts[th.name].value * torch.from_numpy(ch)).sum())
    for k, g in zip(tp, torch.autograd.grad(tl, list(tp.values()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), **GRAD_TOL,
                                   err_msg=k)


def test_loss_and_every_gradient_match_jax(model):
    jtr = _jsgd(model, JAdam())
    ttr = _tsgd(model, TAdam())
    batch = _batches(5, sizes=(3,))[0]
    jfeed = _jfeeder()(batch)
    tfeed = _tfeeder()(batch)

    def jloss(p):
        return jtr._total_cost(jtr.network.apply(p, jfeed, train=True),
                               jtr._row_mask(jfeed))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jtr.params)
    _, tl, tg, _ = ttr.loss_and_grads(tfeed)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    _assert_params_close({k: v.numpy() for k, v in tg.items()}, jg, GRAD_TOL)
    # the eval forward (train=False: the primal kernels' paths)
    jout = jtr.forward(jfeed, ["decoder_group"])["decoder_group"]
    tout = ttr.forward(tfeed, ["decoder_group"])["decoder_group"]
    np.testing.assert_allclose(tout.value.numpy(), np.asarray(jout.value),
                               **FWD_TOL)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))


@pytest.fixture(scope="module")
def att_model():
    """The model with its encoder self-attention block
    (``seq_parallel="ring"``; no mesh, so dense): (JAX cost, port cost,
    shared numpy parameters)."""
    jdsl.reset()
    jcost, _, _ = j_seq2seq(**MODEL, seq_parallel="ring", num_heads=HEADS)
    tdsl.reset()
    tcost, _, _ = t_seq2seq(**MODEL, seq_parallel="ring", num_heads=HEADS)
    rng = np.random.default_rng(1)
    jtr = JSGD(cost=jcost, update_equation=JAdam(), seed=1)
    params = {k: (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
              for k, v in jtr.params.items()}
    return jcost, tcost, params


def test_attention_graph_and_parameter_names_match_jax(att_model):
    test_graph_and_parameter_names_match_jax(att_model)
    jcost, tcost, _ = att_model
    att = tcost.graph.layers["enc_self_att"]
    assert att.type == "multi_head_attention"
    assert att.attrs == jcost.graph.layers["enc_self_att"].attrs
    assert tcost.graph.layers["enc_f_in"].input_names() == ["enc_self_att"]
    specs = TNetwork(tcost.graph, outputs=[tcost.name]).param_specs
    for suffix, shape in (("wq", (E, E)), ("wk", (E, E)), ("wv", (E, E)),
                          ("wo", (E, E)), ("wbias", (E,))):
        assert tuple(specs[f"_enc_self_att.{suffix}"].shape) == shape


def test_attention_loss_and_every_gradient_match_jax(att_model):
    """One batch (ragged, one row padded by the batch bucket): the loss and
    every parameter gradient, the attention block's among them, and the
    eval forward."""
    test_loss_and_every_gradient_match_jax(att_model)


def test_attention_parameters_map_from_jax_by_name(att_model):
    """A JAX parameter dict of the self-attention graph maps onto the
    port's by name, and ``network=`` checks every shape: a transposed
    ``wq`` and a missing ``wo`` are refused."""
    jcost, tcost, _ = att_model
    jparams = {k: np.asarray(v) for k, v in
               JSGD(cost=jcost, update_equation=JAdam(), seed=3)
               .params.items()}
    net = TNetwork(tcost.graph, outputs=[tcost.name])
    got = params_from_numpy(jparams, device="cpu", network=net)
    assert sorted(got) == sorted(net.param_specs)
    for k, v in jparams.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    bad = dict(jparams)
    bad["_enc_self_att.wq"] = np.zeros((E, E + 1), np.float32)
    with pytest.raises(ValueError, match="_enc_self_att.wq"):
        params_from_numpy(bad, device="cpu", network=net)
    del bad["_enc_self_att.wo"]
    with pytest.raises(KeyError, match="_enc_self_att.wo"):
        params_from_numpy(bad, device="cpu", network=net)


def _run_jax(trainer, batches):
    costs = []
    trainer.train(lambda: iter(batches), feeder=_jfeeder(), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, jev.EndIteration) else None)
    return costs


def _run_port(trainer, batches):
    costs = []
    trainer.train(lambda: iter(batches), feeder=_tfeeder(), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, tev.EndIteration) else None)
    return costs


def test_five_step_adam_trajectory_matches_jax(model):
    batches = _batches(9)
    jtr = _jsgd(model, JAdam(learning_rate=5e-3))
    ttr = _tsgd(model, TAdam(learning_rate=5e-3))
    jcosts = _run_jax(jtr, batches)
    tcosts = _run_port(ttr, batches)
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    _assert_params_close({k: v.numpy() for k, v in ttr.params.items()},
                         jtr.params, RUN_TOL)
    test_batches = _batches(21, sizes=(4, 2))
    jres = jtr.test(lambda: iter(test_batches), feeder=_jfeeder())
    tres = ttr.test(lambda: iter(test_batches), feeder=_tfeeder())
    np.testing.assert_allclose(tres.cost, jres.cost, **RUN_TOL)
    assert tres.evaluator == pytest.approx(jres.evaluator, abs=1e-6)


def test_checkpoints_cross_between_packages(model, tmp_path):
    """JAX -> port: the JAX run saves after 2 steps and trains 2 more; the
    port resumes the file and trains the same 2. Port -> JAX: the port
    trains the first 2 steps into a save directory, which the JAX
    Checkpointer restores and trains on. All three end at the same
    parameters and Adam state."""
    first, second = _batches(13, sizes=(4, 3)), _batches(14, sizes=(4, 2))
    jtr = _jsgd(model, JAdam(learning_rate=5e-3))
    _run_jax(jtr, first)
    j_save_params(str(tmp_path / "jax.npz"), jtr.params, jtr.opt_state)
    _run_jax(jtr, second)

    resumed = _tsgd(model, TAdam(learning_rate=5e-3))
    resumed.load_state(*load_params(str(tmp_path / "jax.npz")))
    assert resumed.opt_state["t"] == 2
    _run_port(resumed, second)
    _assert_params_close({k: v.numpy() for k, v in resumed.params.items()},
                         jtr.params, RUN_TOL)

    ttr = _tsgd(model, TAdam(learning_rate=5e-3))
    _run_port(ttr, first)
    save_dir = tmp_path / "port_ckpt"
    save_generation(str(save_dir), 0, ttr.params, ttr.opt_state)
    params, opt_flat, _ = JCheckpointer(str(save_dir)).restore()
    assert "_gru_decoder.w0" in params and "_dec_in.w1" in params
    back = _jsgd(model, JAdam(learning_rate=5e-3))
    back.load_state(params, opt_flat)
    assert int(back.opt_state["t"]) == 2
    _run_jax(back, second)
    _assert_params_close(back.params, jtr.params, RUN_TOL)
    for name, slots in jtr.opt_state["slots"].items():
        for s, v in slots.items():
            np.testing.assert_allclose(
                np.asarray(back.opt_state["slots"][name][s]), np.asarray(v),
                **RUN_TOL, err_msg=f"{name}/{s}")


_CONF = textwrap.dedent(f"""
    import numpy as np
    from paddle_tpu_torch.data.types import integer_value_sequence
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    from paddle_tpu_torch.optim import Adam
    cost, probs, _ = seq2seq_attention(src_vocab={SV}, trg_vocab={TV},
                                       embed_dim={E}, hidden={H})
    optimizer = Adam(learning_rate=1e-2)
    feeding = {{"source_words": integer_value_sequence({SV}),
               "target_words": integer_value_sequence({TV}),
               "target_next": integer_value_sequence({TV})}}

    def train_reader():
        rng = np.random.default_rng(0)
        for _ in range(3):
            batch = []
            for _ in range(4):
                src = rng.integers(2, {SV}, size=int(rng.integers(1, 7)))
                trg = [2 + int(i) % {TV - 2} for i in src[::-1]]
                batch.append((src.tolist(), [0] + trg[:-1], trg))
            yield batch

    test_reader = train_reader
""")


def test_cli_train_then_test_on_cpu(tmp_path, capsys):
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    save_dir = tmp_path / "ckpt"

    def _cli(*args):
        assert cli.main(list(args)) == 0
        return capsys.readouterr().out

    out = _cli("--config", str(conf), "--job", "train", "--device", "cpu",
               "--num_passes", "3", "--save_dir", str(save_dir))
    costs = [float(ln.split("cost=")[1].split()[0])
             for ln in out.splitlines() if ln.startswith("Pass ")]
    assert len(costs) == 3 and all(np.isfinite(costs))
    assert costs[-1] < costs[0]
    summary = json.loads(next(ln for ln in out.splitlines() if
                              ln.startswith("train_summary "))[14:])
    assert summary["steps"] == 9
    # CPU tensors take the plain versions: no kernel launched
    assert {"gru_seq", "gru_seq_train", "gru_bwd_step", "gru_cell",
            "gru_cell_infer"} <= set(summary["kernels"])
    assert all(c["launches"] == 0 for c in summary["kernels"].values())
    out = _cli("--config", str(conf), "--job", "test", "--device", "cpu",
               "--save_dir", str(save_dir))
    assert out.startswith("Test: cost=")
    test_summary = json.loads(next(ln for ln in out.splitlines() if
                                   ln.startswith("test_summary "))[13:])
    assert all(c["launches"] == 0 for c in test_summary["kernels"].values())
    test_cost = float(out.split("cost=")[1].split()[0])
    assert np.isfinite(test_cost) and test_cost < costs[0]


def test_attention_cli_train_then_test_on_cpu(tmp_path, capsys):
    """The CLI with the self-attention model: costs fall over 3 passes,
    ``--job test`` runs from the save directory; on the CPU the flash
    wrappers run their plain versions and count no launch."""
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF.replace(
        f"hidden={H})", f"hidden={H},\n"
        f"                                   seq_parallel='ring', "
        f"num_heads={HEADS})"))
    assert "seq_parallel='ring'" in conf.read_text()
    save_dir = tmp_path / "ckpt"
    assert cli.main(["--config", str(conf), "--job", "train", "--device",
                     "cpu", "--num_passes", "3", "--save_dir",
                     str(save_dir)]) == 0
    out = capsys.readouterr().out
    costs = [float(ln.split("cost=")[1].split()[0])
             for ln in out.splitlines() if ln.startswith("Pass ")]
    assert len(costs) == 3 and all(np.isfinite(costs))
    assert costs[-1] < costs[0]
    summary = json.loads(next(ln for ln in out.splitlines() if
                              ln.startswith("train_summary "))[14:])
    assert summary["kernels"]["flash_fwd"]["launches"] == 0
    assert summary["kernels"]["flash_bwd"]["launches"] == 0
    assert cli.main(["--config", str(conf), "--job", "test", "--device",
                     "cpu", "--save_dir", str(save_dir)]) == 0
    out = capsys.readouterr().out
    test_cost = float(out.split("Test: cost=")[1].split()[0])
    assert np.isfinite(test_cost) and test_cost < costs[0]


def test_unported_paths_raise_not_implemented():
    # generation is ported: generating=True builds JAX's generating graph
    layers = []
    for dsl, build in ((jdsl, j_seq2seq), (tdsl, t_seq2seq)):
        dsl.reset()
        gen, names = build(**MODEL, generating=True)
        assert (gen.name, names) == ("gen", ["source_words"])
        layers.append([(n, l.type, l.size, l.input_names())
                       for n, l in dsl.current_graph().layers.items()])
    assert layers[0] == layers[1]
    # seq_parallel is ported: without a sequence mesh both kinds build the
    # same dense graph
    graphs = []
    for kind in ("ring", "ulysses"):
        tdsl.reset()
        t_seq2seq(**MODEL, seq_parallel=kind, num_heads=HEADS)
        g = tdsl.current_graph()
        graphs.append([(n, l.type, l.size, l.input_names())
                       for n, l in g.layers.items()])
        assert g.layers["enc_self_att"].attrs["seq_parallel"] == kind
    assert graphs[0] == graphs[1]
    # SubsequenceInput is ported: it wraps its input as JAX's does
    for dsl in (jdsl, tdsl):
        dsl.reset()
        x = dsl.data(name="x", size=4, is_sequence=True)
        assert dsl.SubsequenceInput(x).input is x
    # beam_search is ported: both DSLs refuse a group with no
    # GeneratedInput the same way
    for dsl in (jdsl, tdsl):
        dsl.reset()
        x = dsl.data(name="x", size=4)
        with pytest.raises(ValueError, match="needs a GeneratedInput"):
            dsl.beam_search(lambda s: dsl.fc(input=s, size=3, name="o"),
                            [dsl.StaticInput(x)])
    with pytest.raises(RuntimeError, match="inside a recurrent_group"):
        tdsl.memory(name="h", size=4)


# --------------------------------------------------------- generation
GEN = dict(MODEL, beam_size=3, max_length=8)


def _gen_graphs():
    jdsl.reset()
    j_seq2seq(**GEN, generating=True)
    jg = jdsl.current_graph()
    tdsl.reset()
    t_seq2seq(**GEN, generating=True)
    return jg, tdsl.current_graph()


def test_generating_graph_and_parameter_names_match_jax(model):
    """The generating graph through both DSLs: the same layers, the same
    beam group (inputs, memories, GeneratedInput spec, beam size, max
    length, decode policy, its step network), the same parameter names
    and shapes; every one of them, and the generated word's embedding, a
    parameter of the training graph, so JAX's training parameters map
    onto the port's generating network by name."""
    jg, tg = _gen_graphs()
    assert list(tg.layers) == list(jg.layers)
    for name, jl in jg.layers.items():
        tl = tg.layers[name]
        assert (tl.type, tl.size, tl.act, tl.input_names()) == (
            jl.type, jl.size, jl.act, jl.input_names()), name
    ja, ta = jg.layers["gen"].attrs, tg.layers["gen"].attrs
    for key in ("ins", "memories", "outputs", "gen", "beam_size",
                "max_length", "decode_chunk", "full_scan",
                "candidate_adjust", "drop_callback", "norm_or_drop",
                "stop_beam_search"):
        assert ta[key] == ja[key], key
    assert list(ta["sub_model"].layers) == list(ja["sub_model"].layers)
    jspecs = JNetwork(jg, outputs=["gen"]).param_specs
    tnet = TNetwork(tg, outputs=["gen"])
    assert sorted(tnet.param_specs) == sorted(jspecs)
    for k, spec in jspecs.items():
        assert tuple(tnet.param_specs[k].shape) == tuple(spec.shape), k
    _, _, train_params = model
    assert set(tnet.param_specs) | {"_trg_emb.w0"} == set(train_params)
    got = params_from_numpy(train_params, device="cpu", network=tnet)
    for k in tnet.param_specs:
        np.testing.assert_array_equal(got[k].numpy(), train_params[k])


def _sources(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, SV, size=int(rng.integers(1, T + 1))).tolist()
            for _ in range(n)]


def _beams(pkg, graph, params, samples, **kw):
    """(tokens, scores, lengths) as numpy from ``pkg``'s encoder and
    SequenceGenerator."""
    if pkg == "jax":
        from paddle_tpu.core.generation import SequenceGenerator
        p = {k: jnp.asarray(v) for k, v in params.items()}
        gen = SequenceGenerator(graph, "gen")
        feed = JFeeder({"source_words": jtypes.integer_value_sequence(SV)},
                       pad_multiple=T)([(s,) for s in samples])
        outer = JNetwork(graph, outputs=gen.static_input_layers()).apply(
            p, feed)
        return [np.asarray(x) for x in gen.generate(p, outer, **kw)]
    from paddle_tpu_torch.core.generation import SequenceGenerator
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    gen = SequenceGenerator(graph, "gen")
    feed = TFeeder({"source_words": ttypes.integer_value_sequence(SV)},
                   pad_multiple=T, device="cpu")([(s,) for s in samples])
    outer = TNetwork(graph, outputs=gen.static_input_layers()).apply(
        p, feed)
    return [x.numpy() for x in gen.generate(p, outer, **kw)]


def _assert_beams_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0], err_msg="tokens")
    np.testing.assert_array_equal(got[2], want[2], err_msg="lengths")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5,
                               err_msg="scores")


def test_generation_matches_jax(model):
    """``seq2seq_attention(generating=True)`` at the small width, with the
    training graph's parameters (random) and ragged sources: tokens and
    lengths equal to JAX's ``SequenceGenerator`` (its GRU cell kernel
    interpreted), scores within 1e-5, chunked (the default chunk of 8,
    and 3) and full scan."""
    jg, tg = _gen_graphs()
    params = model[2]
    samples = _sources(3)
    want = _beams("jax", jg, params, samples, full_scan=True)
    full = _beams("torch", tg, params, samples, full_scan=True)
    _assert_beams_equal(full, want)
    for chunk in (None, 3):
        got = _beams("torch", tg, params, samples, decode_chunk=chunk)
        _assert_beams_equal(got, _beams("jax", jg, params, samples,
                                        decode_chunk=chunk))
        for a, b in zip(got, full):
            assert np.array_equal(a, b)


_GEN_CONF = textwrap.dedent(f"""
    from paddle_tpu_torch.data.types import integer_value_sequence
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    gen, _ = seq2seq_attention(src_vocab={SV}, trg_vocab={TV},
                               embed_dim={E}, hidden={H}, beam_size=3,
                               max_length=8, generating=True)
    outputs = [gen]
    feeding = {{"source_words": integer_value_sequence({SV})}}
""")


def test_cli_merge_and_serve_generating_config_on_cpu(tmp_path, capsys):
    """--job train of the training config, --job merge of the generating
    config from the same save dir (its embedding and step parameters read
    from the training checkpoint by name), the merged file read back by
    both packages, and --job serve's engine answering generate requests
    with the beams of the port's and JAX's SequenceGenerator on the
    checkpoint's parameters; an off-menu beam size is a typed 400."""
    from paddle_tpu.trainer.merge_model import load_merged_ex as j_load
    from paddle_tpu_torch.serving import BadRequest
    from paddle_tpu_torch.trainer.merge_model import load_merged_ex
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    gen_conf = tmp_path / "gen_conf.py"
    gen_conf.write_text(_GEN_CONF)
    save_dir, model_path = tmp_path / "ckpt", tmp_path / "gen.ptmodel"
    assert cli.main(["--config", str(conf), "--job", "train", "--device",
                     "cpu", "--num_passes", "1", "--save_dir",
                     str(save_dir)]) == 0
    assert cli.main(["--config", str(gen_conf), "--job", "merge",
                     "--device", "cpu", "--save_dir", str(save_dir),
                     "--model_path", str(model_path)]) == 0
    capsys.readouterr()
    from paddle_tpu_torch.trainer.checkpoint import latest_checkpoint
    trained, _ = load_params(latest_checkpoint(str(save_dir)))
    graph, params, outputs, extras = load_merged_ex(str(model_path))
    assert outputs == ["gen"] and not extras
    assert graph.layers["gen"].type == "beam_search_group"
    assert set(params) == set(trained)
    for k, v in params.items():
        np.testing.assert_array_equal(v, np.asarray(trained[k]), err_msg=k)
    jgraph, jparams, joutputs, _ = j_load(str(model_path))
    assert joutputs == ["gen"] and sorted(jparams) == sorted(params)
    assert list(jgraph.layers) == list(graph.layers)

    args = cli.parse_args(["--config", str(gen_conf), "--job", "serve",
                           "--device", "cpu", "--init_model_path",
                           str(model_path), "--max_batch", "4",
                           "--serving_length_buckets", str(T)])
    eng = cli.build_serving_engine(cli.load_config(str(gen_conf)),
                                   args).start()
    try:
        samples = _sources(8)
        got = [eng.infer((s,), kind="generate") for s in samples[:2]]
        reqs = [eng.submit((s,), kind="generate") for s in samples[2:]]
        for r in reqs:
            assert r.event.wait(60) and r.error is None
            got.append(r.result)
        with pytest.raises(BadRequest) as e:
            eng.submit((samples[0],), kind="generate", beam_size=5)
        assert e.value.allowed == {"beam_size": [3], "max_length": [8]}
    finally:
        eng.shutdown()
    _, tg = _gen_graphs()
    want = _beams("torch", tg, trained, samples)
    _assert_beams_equal(want, _beams("jax", jgraph, jparams, samples))
    for b, ans in enumerate(got):
        assert len(ans["sequences"]) == 3
        for k, seq in enumerate(ans["sequences"]):
            assert seq["tokens"] == want[0][b, k, :want[2][b, k]].tolist()
            assert abs(seq["score"] - float(want[1][b, k])) < 1e-5
