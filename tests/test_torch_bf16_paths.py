"""Mixed precision past the first recurrent layer (``compute_dtype=
"bfloat16"``), the port's whole models against the JAX package's, on the
CPU.

Five models at tiny widths, each built with both DSLs, the same
parameters and the same batch:

- ``seq2seq``: ``seq2seq_attention`` (its decoder's ``gru_step`` meets an
  f32 state and input with bf16 weights: JAX's promotion, which the
  port's cells raised on before);
- ``seq2seq_narrow``: the same at embed = hidden = 8 and length 4, where
  the encoder GRU's bias gradient cancels over the batch (the port summed
  it over all T * B rows at once; JAX's scan sums it a step at a time in
  bf16, ``ops/gru.py:_BiasFold``);
- ``seq2seq_att``: the same with the encoder self-attention block
  (``seq_parallel="ring"``, dense on one device): flash gets bf16 q, k,
  v, its output promoted by the f32 mask;
- ``gru_group``: a GRU recurrent group with a memory and no boot (the
  nested text model's flat twin): an f32 state, a bf16 input;
- ``lstm_decoder``: an ``lstm_step`` decoder (chip_smoke.py's
  ``_LSTM_DECODER`` topology): f32 memories, bf16 peepholes;
- ``linear_crf``: the ``v1_api_demo/sequence_tagging/linear_crf.py``
  topology (sparse binary features, an fc without bias, ``crf_layer``
  and ``crf_decoding_layer`` sharing ``crfw``): the CRF gets bf16.

Each: every layer's output dtype and state dtypes equal JAX's (the dtype
probe); the loss within 1e-2 relative and every gradient within
``tests/test_torch_bf16.py:_grad_close``'s bounds of JAX's (and of the
f32 gradient at the same parameters: the port's, which the f32 tests
hold to JAX's at 1e-4). JAX runs its CPU default: the scans, the inline cells and
``blockwise_attention``; the linear CRF runs JAX's TPU path,
``_crf_core`` interpreted with its custom VJP (``_crf_bwd``, the analytic
marginals the port's CRF kernels compute): JAX's default there is
autodiff through ``crf_log_z_ref``'s scan, which also differentiates the
shift by max(trans), a term that cancels exactly only in exact
arithmetic; at bf16 it leaves 0.030 on crfw's argmax entry (6.8 % of the
largest entry; the port's bf16 gradient lies 0.0076 from the f32 one).
seq2seq also trains two Adam steps at bf16 on the port's CPU path.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config.model_config import ParamAttr as JParamAttr
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.models.seq2seq import seq2seq_attention as j_seq2seq
from paddle_tpu.ops import common
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config.model_config import ParamAttr as TParamAttr
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.models.seq2seq import seq2seq_attention as t_seq2seq
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer.trainer import SGD
from test_torch_bf16 import _grad_close

V, E, H, T = 20, 16, 16, 6        # seq2seq: dicts, embed, hidden, length
E_N, H_N, T_N = 8, 8, 4           # the narrow seq2seq
FEATS, LABELS = 40, 5             # the linear CRF: features, labels


def _s2s(dsl, embed=E, hidden=H, **kw):
    fn = j_seq2seq if dsl is jdsl else t_seq2seq
    return fn(src_vocab=V, trg_vocab=V - 4, embed_dim=embed, hidden=hidden,
              **kw)[0]


def _gru_group(dsl):
    """``chip_smoke.py:nested_text(nested=False)``: a group over the
    words whose ``gru_step`` memory has no boot layer."""
    words = dsl.data(name="words", size=V, is_sequence=True)
    label = dsl.data(name="label", size=3)
    emb = dsl.embedding(words, size=8, name="emb")

    def step(w):
        h = dsl.memory(name="h", size=8)
        x = dsl.fc(input=w, size=24, act="linear", name="proj")
        return dsl.gru_step_layer(x, h, name="h")

    g = dsl.recurrent_group(step, emb, name="word_rnn")
    out = dsl.fc(input=dsl.last_seq(g, name="doc"), size=3, act="softmax",
                 name="out")
    return dsl.classification_cost(input=out, label=label, name="cost")


def _lstm_decoder(dsl):
    """``chip_smoke.py:_LSTM_DECODER`` at a tiny width."""
    src = dsl.data(name="source_words", size=V, is_sequence=True)
    semb = dsl.embedding(input=src, size=8, name="src_emb")
    boot = dsl.fc(input=dsl.pooling(input=semb, pooling_type="avg",
                                    name="src_avg"),
                  size=8, act="tanh", name="boot")

    def step(word):
        h = dsl.memory(name="h", size=8, boot_layer=boot)
        c = dsl.memory(name="cst", size=8)
        gates = dsl.fc(input=[word, h], size=32, act="linear", name="gates")
        out = dsl.lstm_step_layer(gates, c, size=8, name="h")
        dsl.get_output_layer(out, arg_name="state", size=8, name="cst")
        return dsl.fc(input=out, size=V, act="softmax", name="prob")

    trg = dsl.data(name="target_words", size=V, is_sequence=True)
    nxt = dsl.data(name="target_next", size=V, is_sequence=True)
    temb = dsl.embedding(input=trg, size=8, name="trg_emb")
    probs = dsl.recurrent_group(step, [temb], name="decoder_group")
    return dsl.classification_cost(input=probs, label=nxt,
                                   name="decoder_cost")


def linear_crf(dsl, features, labels):
    """``v1_api_demo/sequence_tagging/linear_crf.py``: sparse binary
    features, a linear fc to the labels without bias, the CRF cost and
    its Viterbi decode sharing ``crfw``."""
    attr = (JParamAttr if dsl is jdsl else TParamAttr)(name="crfw")
    feats = dsl.data(name="features", size=features, is_sequence=True)
    chunk = dsl.data(name="chunk", size=labels, is_sequence=True)
    crf_input = dsl.fc(input=feats, size=labels, act="linear",
                       bias_attr=False, name="crf_input")
    cost = dsl.crf_layer(input=crf_input, label=chunk, size=labels,
                         param_attr=attr, name="crf")
    dsl.crf_decoding_layer(input=crf_input, label=chunk, size=labels,
                           param_attr=attr, name="crf_decoding")
    return cost


def _s2s_batch(rng, n=4, t=T):
    out = []
    for _ in range(n):
        src = rng.integers(2, V, size=int(rng.integers(1, t + 1)))
        trg = [2 + int(i) % (V - 6) for i in src[::-1]]
        out.append((src.tolist(), [0] + trg[:-1], trg))
    return out


def _words_batch(rng, n=4):
    return [(rng.integers(0, V, size=int(rng.integers(1, T + 1))).tolist(),
             int(rng.integers(0, 3))) for _ in range(n)]


def _crf_batch(rng, n=4):
    out = []
    for _ in range(n):
        k = int(rng.integers(1, T + 1))
        feats = [sorted(set(rng.integers(0, FEATS, size=4).tolist()))
                 for _ in range(k)]
        out.append((feats, rng.integers(0, LABELS, size=k).tolist()))
    return out


def _s2s_feeding(ty):
    return {"source_words": ty.integer_value_sequence(V),
            "target_words": ty.integer_value_sequence(V - 4),
            "target_next": ty.integer_value_sequence(V - 4)}


MODELS = {
    "seq2seq": dict(
        build=_s2s, batch=_s2s_batch, feeding=_s2s_feeding,
        bf16=("src_emb", "trg_emb", "enc_f_in", "enc_b_in")),
    "seq2seq_narrow": dict(
        build=lambda dsl: _s2s(dsl, embed=E_N, hidden=H_N),
        batch=lambda rng: _s2s_batch(rng, t=T_N), feeding=_s2s_feeding,
        bf16=("src_emb", "trg_emb", "enc_f_in", "enc_b_in"), pad=T_N),
    "seq2seq_att": dict(
        build=lambda dsl: _s2s(dsl, seq_parallel="ring", num_heads=2),
        batch=_s2s_batch, feeding=_s2s_feeding,
        # the block's bf16 output is promoted by the f32 mask
        bf16=("src_emb", "trg_emb")),
    "gru_group": dict(
        build=_gru_group, batch=_words_batch,
        feeding=lambda ty: {"words": ty.integer_value_sequence(V),
                            "label": ty.integer_value(3)},
        bf16=("emb",)),
    "lstm_decoder": dict(
        build=_lstm_decoder, batch=lambda rng: [
            (s, t, n) for s, t, n in _s2s_batch(rng)],
        feeding=lambda ty: {"source_words": ty.integer_value_sequence(V),
                            "target_words": ty.integer_value_sequence(V),
                            "target_next": ty.integer_value_sequence(V)},
        bf16=("src_emb", "trg_emb")),
    "linear_crf": dict(
        build=lambda dsl: linear_crf(dsl, FEATS, LABELS), batch=_crf_batch,
        feeding=lambda ty: {
            "features": ty.sparse_binary_vector_sequence(FEATS),
            "chunk": ty.integer_value_sequence(LABELS)},
        bf16=("features", "crf_input"), jax_mode="interpret"),
}


def _jax_mode(spec):
    """The JAX package's kernel mode of a model: its CPU default, or the
    TPU path interpreted (``jax_mode``)."""
    if "jax_mode" in spec:
        return common.force_mode(spec["jax_mode"])
    return contextlib.nullcontext()


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(name, spec, JAX trainer, port trainer, JAX batch, port batch, the
    port's f32 trainer): the same random parameters on both sides."""
    spec = MODELS[request.param]
    jdsl.reset()
    jcost = spec["build"](jdsl)
    tdsl.reset()
    tcost = spec["build"](tdsl)
    rng = np.random.default_rng(0)
    specs = JNetwork(jcost.graph, outputs=[jcost.name]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
              for k, s in specs.items()}
    jtr = JSGD(cost=jcost, update_equation=JAdam(learning_rate=1e-3),
               parameters={k: jnp.asarray(v) for k, v in params.items()},
               compute_dtype="bfloat16")
    ttr, tf32 = (SGD(cost=tcost, update_equation=Adam(learning_rate=1e-3),
                     parameters=params_from_numpy(params, device="cpu"),
                     device="cpu", compute_dtype=dt)
                 for dt in ("bfloat16", None))
    batch = spec["batch"](np.random.default_rng(1))
    pad = spec.get("pad", T)
    jfeed = JFeeder(spec["feeding"](jtypes), pad_multiple=pad)(batch)
    tfeed = TFeeder(spec["feeding"](ttypes), pad_multiple=pad,
                    device="cpu")(batch)
    return request.param, spec, jtr, ttr, jfeed, tfeed, tf32


def _probe(out):
    """A layer's output as dtype names: (value, whether it has a mask, its
    final state's or a group's final memories' dtypes)."""
    name = lambda t: str(t.dtype).replace("torch.", "")  # noqa: E731
    st = out.state
    if isinstance(st, dict) and "final" in st:
        st = {k: name(v) for k, v in st["final"].items()}
    elif isinstance(st, tuple):
        st = [name(v) for v in st]
    elif hasattr(st, "dtype"):
        st = [name(st)]
    else:
        st = None
    return name(out.value), out.mask is not None, st


def test_layer_dtypes_match_jax(model):
    """The dtype probe: each layer's output dtype, its final states'
    dtypes and a group's final memories' dtypes in the port equal JAX's
    (JAX's forward traced abstractly, ``jax.eval_shape``); masks stay
    f32."""
    name, spec, jtr, ttr, jfeed, tfeed, _ = model
    jprobe = {}

    def jfwd(params, feed):
        outs = jtr.network.apply(jtr._cast_compute(params),
                                 jtr._cast_compute(feed), train=False)
        jprobe.update({n: _probe(a) for n, a in outs.items()})
        return jnp.zeros(())

    with _jax_mode(spec):
        jax.eval_shape(jfwd, jtr.params, jfeed)
    with torch.no_grad():
        tout = ttr.network.apply(ttr._cast_compute(ttr.params),
                                 ttr._cast_compute(tfeed), train=False)
    assert list(tout) == list(jprobe)
    assert {n: _probe(a) for n, a in tout.items()} == jprobe
    for n, a in tout.items():
        if a.mask is not None:
            assert a.mask.dtype == torch.float32, n
    bf16 = {n for n, p in jprobe.items() if p[0] == "bfloat16"}
    assert bf16 == set(spec["bf16"])


def test_loss_and_every_gradient_match_jax(model):
    """The loss within 1e-2 relative and every parameter gradient within
    ``_grad_close``'s bounds of JAX's at bf16 compute (and of the f32
    gradient at the same parameters); the port's gradients f32."""
    name, spec, jtr, ttr, jfeed, tfeed, tf32 = model
    def jloss(p, feed):
        outs = jtr.network.apply(jtr._cast_compute(p),
                                 jtr._cast_compute(feed), train=True)
        return jtr._total_cost(outs, jtr._row_mask(feed))

    with _jax_mode(spec):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(jtr.params, jfeed)
    _, tl, tg, _ = ttr.loss_and_grads(tfeed)
    fg = {k: v.numpy() for k, v in tf32.loss_and_grads(tfeed)[2].items()}
    assert float(tl) == pytest.approx(float(jl), rel=1e-2)
    assert sorted(tg) == sorted(jg)
    _grad_close(tg, jg, fg)


def test_seq2seq_trains_two_adam_steps_at_bf16():
    """seq2seq with its self-attention block trains at bf16 on the port's
    CPU path: two Adam steps, finite costs, f32 masters and slots."""
    tdsl.reset()
    cost = _s2s(tdsl, seq_parallel="ring", num_heads=2)
    tr = SGD(cost=cost, update_equation=Adam(learning_rate=1e-2),
             device="cpu", compute_dtype="bfloat16", seed=3)
    feeder = TFeeder(_s2s_feeding(ttypes), pad_multiple=T, device="cpu")
    rng = np.random.default_rng(2)
    costs = [float(tr.train_step(feeder(_s2s_batch(rng)))["cost"])
             for _ in range(2)]
    assert all(np.isfinite(costs))
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    for slots in tr.opt_state["slots"].values():
        assert all(s.dtype == torch.float32 for s in slots.values())
