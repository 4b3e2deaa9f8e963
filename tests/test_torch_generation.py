"""The port's generation slice against the JAX package, on the CPU: the LSTM
cell (``kernels/rnn_cells.py``: ``lstm_cell``, ``lstm_cell_infer``), the
``lstm_step`` and ``get_output`` layers in a training group, the beam
search (``core/generation.py:SequenceGenerator``) over a GRU-step and an
LSTM-step decoder (``tests/test_generation_chunked.py:_build_cell_decoder``,
built through both DSLs) with each beam-control hook pinned in the config,
and the served generate path (``generate_rows``, ``POST /v1/generate``).
Inputs and parameters come from a numpy seed.

The JAX side runs under ``force_mode("interpret")`` and ``fused_rnn(True)``,
so its Pallas cells are taken: ``_lstm_cell_kernel`` (training entry
``lstm_cell`` with its recompute vjp, and ``lstm_cell_infer`` in the
decode) and ``_gru_cell_kernel``.

Tolerances: forward rtol/atol 1e-5; gradients rtol 1e-4 / atol 1e-5 (f32
sums in other orders); beams: tokens and lengths identical, scores within
1e-5; the port's chunked decode byte-identical to its full scan.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as jkernels
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.generation import SequenceGenerator as JGenerator
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.kernels.rnn_cells import lstm_cell as j_lstm_cell
from paddle_tpu.kernels.rnn_cells import lstm_cell_infer as j_lstm_cell_infer
from paddle_tpu.ops import common
from paddle_tpu.serving import ServingClient
from paddle_tpu.serving.errors import BadRequest as JBadRequest
from paddle_tpu_torch import ops
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.generation import SequenceGenerator as TGenerator
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.kernels import rnn_cells
from paddle_tpu_torch.serving import (BadRequest, ServingEngine,
                                      ServingPredictor, make_server)

V, E, H = 7, 4, 6
EOS = 1
K, L = 3, 8
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_kernels():
    """The JAX Pallas cells, interpreted."""
    with common.force_mode("interpret"), jkernels.fused_rnn(True):
        yield


# ------------------------------------------------------------- LSTM cell
def _cell_inputs(B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32)
    return (f(B, 4 * H), f(B, H), f(H, scale=0.5), f(H, scale=0.5),
            f(H, scale=0.5)), (f(B, H), f(B, H))


@pytest.mark.parametrize("B,H,acts", [
    (5, 8, ("tanh", "sigmoid", "tanh")), (1, 16, ("tanh", "sigmoid", "tanh")),
    (9, 130, ("tanh", "sigmoid", "tanh")), (4, 8, ("relu", "sigmoid", "tanh"))])
def test_lstm_cell_matches_jax(B, H, acts):
    """Both entries' (h, c) against JAX's ``lstm_cell`` and
    ``lstm_cell_infer`` (the Pallas kernel, interpreted, for the default
    activations; ``_lstm_math`` otherwise), with nonzero peepholes; every
    gradient against ``jax.vjp`` through its custom vjp."""
    ins, (dh, dc) = _cell_inputs(B, H, seed=B * H)
    jins = [jnp.asarray(a) for a in ins]
    j_out, vjp = jax.vjp(lambda *a: j_lstm_cell(*a, *acts), *jins)
    j_grads = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    j_infer = j_lstm_cell_infer(*jins, *acts)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    t_out = rnn_cells.lstm_cell(*leaves, *acts)
    with torch.no_grad():
        t_infer = rnn_cells.lstm_cell_infer(
            *(torch.from_numpy(a) for a in ins), *acts)
    for got, want in ((t_out, j_out), (t_infer, j_infer)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **FWD_TOL)
    grads = torch.autograd.grad(t_out, leaves, (torch.from_numpy(dh),
                                                torch.from_numpy(dc)))
    for name, g, w in zip(("gates", "c_prev", "check_i", "check_f",
                           "check_o"), grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_lstm_cell_counts_no_launch_on_the_cpu():
    """A CPU tensor runs the plain version: no kernel launch is
    counted, and the plain version is ``lstm_math`` with the default
    activations."""
    ins, _ = _cell_inputs(3, 4, seed=1)
    t = [torch.from_numpy(a) for a in ins]
    counts = ops.kernel_counts()
    assert "lstm_cell" in counts and "lstm_cell_infer" in counts
    before = (rnn_cells.lstm_cell.launches,
              rnn_cells.lstm_cell_infer.launches)
    h, c = rnn_cells.lstm_cell_infer(*t)
    h2, c2 = rnn_cells.lstm_cell(*t)
    assert (rnn_cells.lstm_cell.launches,
            rnn_cells.lstm_cell_infer.launches) == before
    acts = [rnn_cells.activation(a) for a in ("tanh", "sigmoid", "tanh")]
    h3, c3 = rnn_cells.lstm_math(*t, *acts)
    for a, b in ((h, h3), (c, c3), (h2, h3), (c2, c3)):
        assert torch.equal(a, b)


# ------------------------------------------- lstm_step in a training group
def _lstm_group_graph(dsl):
    x = dsl.data(name="x", size=5, is_sequence=True)
    src = dsl.data(name="src", size=H)
    boot = dsl.fc(input=src, size=H, act="tanh", name="boot")

    def step(x_t):
        h = dsl.memory(name="h", size=H, boot_layer=boot)
        c = dsl.memory(name="cst", size=H)
        gates = dsl.fc(input=[x_t, h], size=4 * H, act="linear",
                       name="gates")
        out = dsl.lstm_step_layer(gates, c, size=H, name="h")
        dsl.get_output_layer(out, arg_name="state", size=H, name="cst")
        return dsl.fc(input=out, size=V, act="softmax", name="prob")

    return dsl.recurrent_group(step, [x])


def test_lstm_step_training_group_matches_jax():
    """The ``lstm_step`` + ``get_output`` decoder step in a recurrent group
    (the cell state carried by a memory linked to the get_output layer,
    the peepholes nonzero, ragged and padded rows): the same graph and
    parameter names through both DSLs, the output and every parameter
    and input gradient against JAX's ``lax.scan`` group with its Pallas
    cell's training entry."""
    jdsl.reset()
    jout = _lstm_group_graph(jdsl)
    tdsl.reset()
    tout = _lstm_group_graph(tdsl)
    assert tout.name == jout.name == "__recurrent_group_0__"
    jg = jout.graph.layers[jout.name].attrs
    tg = tout.graph.layers[tout.name].attrs
    assert tg["memories"] == jg["memories"]
    assert list(tg["sub_model"].layers) == list(jg["sub_model"].layers)
    for name, jl in jg["sub_model"].layers.items():
        tl = tg["sub_model"].layers[name]
        assert (tl.type, tl.size, tl.act, tl.input_names(), tl.attrs) == (
            jl.type, jl.size, jl.act, jl.input_names(), jl.attrs), name
    jnet = JNetwork(jout.graph, outputs=[jout.name])
    tnet = TNetwork(tout.graph, outputs=[tout.name])
    assert sorted(tnet.param_specs) == sorted(jnet.param_specs)
    assert tuple(tnet.param_specs["_h.wbias"].shape) == (3 * H,)
    rng = np.random.default_rng(5)
    params = {k: (rng.normal(size=s.shape) * 0.5).astype(np.float32)
              for k, s in jnet.param_specs.items()}
    B, T = 4, 6
    x = rng.normal(size=(B, T, 5)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([[6], [3], [1], [0]])).astype(
        np.float32)
    src = rng.normal(size=(B, H)).astype(np.float32)
    ct = rng.normal(size=(B, T, V)).astype(np.float32)

    def jloss(p, x_, s_):
        outs = jnet.apply(p, {"x": JArgument(x_, jnp.asarray(mask)),
                              "src": JArgument(s_)}, train=True)
        return jnp.sum(outs[jout.name].value * ct), outs[jout.name].value

    (_, j_val), j_grads = jax.value_and_grad(jloss, (0, 1, 2),
                                             has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(src))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(src).requires_grad_(True)
    t_val = tnet.apply(tp, {"x": TArgument(tx, torch.from_numpy(mask)),
                            "src": TArgument(ts)}, train=True)[tout.name].value
    np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val),
                               **FWD_TOL)
    grads = torch.autograd.grad((t_val * torch.from_numpy(ct)).sum(),
                                list(tp.values()) + [tx, ts])
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[0][k]),
                                   **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(j_grads[1]),
                               **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(j_grads[2]),
                               **GRAD_TOL)


# ----------------------------------------------------------- beam search
# the hooks are module-level so that pinning them in a config survives
# pickling (merged models); one spelling for each package
def _j_boost_eos(logp, state):
    return logp.at[:, EOS].add(5.0)


def _t_boost_eos(logp, state):
    logp = logp.clone()
    logp[:, EOS] += 5.0
    return logp


def _j_drop_2(state, total):
    return jnp.broadcast_to((jnp.arange(total.shape[-1]) == 2)[None, None],
                            total.shape)


def _t_drop_2(state, total):
    return (torch.arange(total.shape[-1]) == 2)[None, None].expand(
        total.shape)


def _j_keep_eos_and_3(state, total):
    """Drops every token but EOS and 3: with K = 3, fewer than K finite
    candidates remain, and the selection breaks ties among -1e9 fills."""
    keep = (jnp.arange(total.shape[-1]) == EOS) | (
        jnp.arange(total.shape[-1]) == 3)
    return jnp.broadcast_to(~keep[None, None], total.shape)


def _t_keep_eos_and_3(state, total):
    idx = torch.arange(total.shape[-1])
    return (~((idx == EOS) | (idx == 3)))[None, None].expand(total.shape)


def _j_min_len_4(eos_scores, length):
    return jnp.where(length < 4, jnp.float32(-1e9), eos_scores)


def _t_min_len_4(eos_scores, length):
    return torch.full_like(eos_scores, -1e9) if length < 4 else eos_scores


def _stop_after_2(state, t):
    return t >= 2


# hook kind -> (JAX hooks, port hooks), pinned in the config;
# norm_or_drop rides with candidate_adjust so that endings exist for it
HOOKS = {
    None: ({}, {}),
    "candidate_adjust": ({"candidate_adjust": _j_boost_eos},
                         {"candidate_adjust": _t_boost_eos}),
    "drop_callback": ({"drop_callback": _j_drop_2},
                      {"drop_callback": _t_drop_2}),
    "drop_to_fewer_than_k": ({"drop_callback": _j_keep_eos_and_3},
                             {"drop_callback": _t_keep_eos_and_3}),
    "norm_or_drop": ({"candidate_adjust": _j_boost_eos,
                      "norm_or_drop": _j_min_len_4},
                     {"candidate_adjust": _t_boost_eos,
                      "norm_or_drop": _t_min_len_4}),
    "stop_beam_search": ({"stop_beam_search": _stop_after_2},
                         {"stop_beam_search": _stop_after_2}),
}


def _cell_decoder(dsl, cell, **hooks):
    """``tests/test_generation_chunked.py:_build_cell_decoder`` (the LSTM
    step with its peephole bias on), with ``hooks`` pinned."""
    dsl.reset()
    src = dsl.data("src", size=H)
    boot = dsl.fc(src, size=H, act="tanh", name="boot", bias_attr=False)

    if cell == "gru":
        def step(prev_emb):
            m = dsl.memory(name="g", size=H, boot_layer=boot)
            x = dsl.fc(prev_emb, size=3 * H, act="linear", name="xg",
                       bias_attr=False)
            g = dsl.gru_step_layer(x, m, name="g")
            return dsl.fc(g, size=V, act="softmax", name="prob",
                          bias_attr=False)
    else:
        def step(prev_emb):
            out_m = dsl.memory(name="h", size=H, boot_layer=boot)
            c_m = dsl.memory(name="cst", size=H)
            gates = dsl.fc([prev_emb, out_m], size=4 * H, act="linear",
                           name="gates", bias_attr=False)
            h = dsl.lstm_step_layer(gates, c_m, name="h")
            dsl.get_output_layer(h, arg_name="state", size=H, name="cst")
            return dsl.fc(h, size=V, act="softmax", name="prob",
                          bias_attr=False)

    dsl.beam_search(
        step,
        [dsl.GeneratedInput(size=V, embedding_name="gen_emb",
                            embedding_size=E)],
        bos_id=0, eos_id=EOS, beam_size=K, max_length=L, name="gen",
        **hooks)
    return dsl.current_graph()


def _decoder_params(graph, seed=0):
    """Every parameter of the generating graph (the boot, the hoisted step
    parameters, the peepholes included) and the embedding, from numpy."""
    rng = np.random.default_rng(seed)
    specs = JNetwork(graph, outputs=["gen"]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.7).astype(np.float32)
              for k, s in sorted(specs.items())}
    params["gen_emb"] = rng.normal(size=(V, E)).astype(np.float32)
    return params


def _sources(B, seed=7):
    return np.random.default_rng(seed).normal(size=(B, H)).astype(
        np.float32)


def _j_beams(graph, params, src, **kw):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    outer = JNetwork(graph, outputs=["boot"]).apply(
        p, {"src": JArgument(jnp.asarray(src))})
    gen = JGenerator(graph, "gen")
    out = [np.asarray(x) for x in gen.generate(p, outer, **kw)]
    return out, gen.last_info


def _t_beams(graph, params, src, **kw):
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    outer = TNetwork(graph, outputs=["boot"]).apply(
        p, {"src": TArgument(torch.from_numpy(src))})
    gen = TGenerator(graph, "gen")
    out = [x.numpy() for x in gen.generate(p, outer, **kw)]
    return out, gen.last_info


def _assert_beams_equal(got, want, where):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{where} tokens")
    np.testing.assert_array_equal(got[2], want[2],
                                  err_msg=f"{where} lengths")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5,
                               err_msg=f"{where} scores")


@pytest.mark.parametrize("hook_kind", list(HOOKS))
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_beam_search_matches_jax(cell, hook_kind):
    """The GRU- and LSTM-step decoders with each hook pinned in the
    config: tokens and lengths equal to JAX's ``SequenceGenerator``,
    scores within 1e-5, both the chunked decode (chunks of 3 over L = 8)
    and the full scan; the port's chunked decode byte-identical to its
    full scan, with the same step accounting as JAX."""
    j_hooks, t_hooks = HOOKS[hook_kind]
    jg = _cell_decoder(jdsl, cell, **j_hooks)
    tg = _cell_decoder(tdsl, cell, **t_hooks)
    params = _decoder_params(jg, seed=len(hook_kind or ""))
    src = _sources(3)
    t_full, t_info = _t_beams(tg, params, src, full_scan=True)
    assert t_info["decode_steps"] == L and t_info["full_scan"]
    j_full, _ = _j_beams(jg, params, src, full_scan=True)
    _assert_beams_equal(t_full, j_full, f"{cell}/{hook_kind} full scan")
    t_chunk, t_info = _t_beams(tg, params, src, decode_chunk=3)
    j_chunk, j_info = _j_beams(jg, params, src, decode_chunk=3)
    _assert_beams_equal(t_chunk, j_chunk, f"{cell}/{hook_kind} chunked")
    for a, b in zip(t_chunk, t_full):
        assert np.array_equal(a, b)
    assert t_info == j_info
    if hook_kind == "drop_to_fewer_than_k":
        tokens, _, lengths = t_full
        used = {int(x) for b in range(3) for k in range(K)
                for x in tokens[b, k, :lengths[b, k]]}
        assert used <= {EOS, 3}
    if hook_kind == "stop_beam_search":
        assert t_info["decode_steps"] == 3 and t_info["steps_saved"] == 5


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_greedy_and_early_exit_match_jax(cell):
    """K = 1 (no parent gathers) and a decode that ends early (EOS boosted
    in the config): equal to JAX, and the chunked decode stops before L."""
    jg = _cell_decoder(jdsl, cell, **HOOKS["candidate_adjust"][0])
    tg = _cell_decoder(tdsl, cell, **HOOKS["candidate_adjust"][1])
    params = _decoder_params(jg, seed=3)
    src = _sources(4, seed=11)
    for beam in (1, K):
        t_out, t_info = _t_beams(tg, params, src, beam_size=beam,
                                 decode_chunk=2)
        j_out, j_info = _j_beams(jg, params, src, beam_size=beam,
                                 decode_chunk=2)
        _assert_beams_equal(t_out, j_out, f"{cell} beam {beam}")
        assert t_info == j_info
        assert t_info["steps_saved"] > 0, t_info


# --------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def lstm_server():
    """The LSTM-step decoder served on the CPU: (port, predictor,
    params)."""
    jg = _cell_decoder(jdsl, "lstm")
    params = _decoder_params(jg, seed=9)
    graph = _cell_decoder(tdsl, "lstm")
    pred = ServingPredictor(graph, params, ["gen"],
                            {"src": ttypes.dense_vector(H)},
                            batch_buckets=[1, 2, 4], device="cpu")
    eng = ServingEngine(pred, batch_timeout_ms=2.0).start()
    server = make_server(eng, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield server.server_address[1], pred, jg, params
    finally:
        server.shutdown()
        eng.shutdown()


def test_generate_rows_and_http_match_jax(lstm_server):
    """``generate_rows`` over a padded batch bucket and ``POST
    /v1/generate`` (single samples, a ``rows`` call, through the JAX
    package's ``ServingClient``: the same wire) answer JAX's beams: K
    sequences, best first, tokens cut at their lengths; a repeat answers
    the same; /healthz lists the LSTM cell's launch counts."""
    port, pred, jg, params = lstm_server
    src = _sources(3, seed=21)
    (tokens, scores, lengths), info = pred.generate_rows(
        [(row.tolist(),) for row in src])
    assert info["bucket"] == f"b4_k{K}" and info["padded_rows"] == 4
    j_out, _ = _j_beams(jg, params, src)
    _assert_beams_equal([tokens[:3], scores[:3], lengths[:3]], j_out,
                        "generate_rows")
    outer = pred.encode_rows([(row.tolist(),) for row in src])
    assert set(outer) >= set(pred.engine.static_input_layers())
    again = [t.numpy() for t in pred.engine.generate(pred.params, outer)]
    _assert_beams_equal(again, [tokens, scores, lengths], "encode_rows")
    client = ServingClient(port=port)
    answers = [client.generate((row.tolist(),)) for row in src]
    answers.append(client.generate((src[0].tolist(),)))
    assert answers[-1] == answers[0]
    for b, ans in enumerate(answers[:3]):
        seqs = ans["sequences"]
        assert len(seqs) == K
        assert [s["score"] for s in seqs] == sorted(
            (s["score"] for s in seqs), reverse=True)
        for k, s in enumerate(seqs):
            assert s["tokens"] == j_out[0][b, k, :j_out[2][b, k]].tolist()
            assert abs(s["score"] - float(j_out[1][b, k])) < 1e-5
    rows = client._request_once("POST", "/v1/generate", {
        "rows": [[row.tolist()] for row in src]})
    assert [r["sequences"] for r in rows["results"]] == [
        a["sequences"] for a in answers[:3]]
    health = client.healthz()
    assert {"lstm_cell", "lstm_cell_infer", "gru_cell_infer"} <= set(
        health["kernels"])


def test_off_menu_generate_options_get_the_typed_400(lstm_server):
    """Serving pins the config's (beam_size, max_length): another pair is
    a 400 carrying the menu, at the engine and over HTTP; a generation-only
    config has no scoring outputs."""
    port, pred, _, _ = lstm_server
    assert pred.gen_allowed_menu() == {"beam_size": [K], "max_length": [L]}
    with pytest.raises(BadRequest) as e:
        pred.check_gen_opts(beam_size=K + 2)
    assert e.value.allowed == {"beam_size": [K], "max_length": [L]}
    pred.check_gen_opts(beam_size=K, max_length=L)
    client = ServingClient(port=port)
    sample = (_sources(1)[0].tolist(),)
    with pytest.raises(JBadRequest):
        client.generate(sample, beam_size=K + 1)
    with pytest.raises(JBadRequest):
        client.generate(sample, max_length=L + 5)
    with pytest.raises(BadRequest, match="no scoring outputs"):
        pred.predict_rows([sample])
