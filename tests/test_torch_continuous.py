"""Continuous batching in the PyTorch port against the JAX package, on the
CPU: ``core/generation.py:DecodeSession`` and the serving engine's
continuous generate path (``serving/batcher.py``), with ``/metrics`` and
``/livez`` (``serving/server.py``).

(a) the port's ``DecodeSession`` against JAX's on one admission schedule
(W = 3 lanes, K = 2 beams, L = 12, chunks of 2): lanes admitted at
different chunks, one mid-flight, a lane released and admitted again;
tokens, lengths and steps equal, scores within 1e-5, with and without
pinned ``norm_or_drop`` and ``stop_beam_search`` hooks; (b) each lane
equals the port's dedicated search on the same request; (c)-(h) the
engine on the JAX package's length-controlled twin graph
(``tests/test_serving_continuous.py``), built with the port's DSL: the
decoder's EOS logit follows the boot memory's sum, so a positive source
finishes within 2 steps and a negative one runs to ``max_length``.

Every engine wait has a timeout and every engine is shut down in
``finally``.
"""

import http.client
import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.generation import SequenceGenerator as JGenerator
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import types as jtypes
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import ServingPredictor as JPredictor
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.generation import SequenceGenerator as TGenerator
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.serving import (DeadlineExceeded, ServingEngine,
                                      ServingPredictor, make_server)

WAIT = 120.0


# ------------------------------------------------- (a), (b) the session
SV, SE, SH = 9, 4, 6      # the session graph's vocab, embedding, hidden
SEOS, SK, SL, SW, SCHUNK = 1, 2, 12, 3, 2


def _j_boost_eos(logp, state):
    return logp.at[:, SEOS].add(2.5)


def _t_boost_eos(logp, state):
    logp = logp.clone()
    logp[:, SEOS] += 2.5
    return logp


def _j_min_len_4(eos_scores, length):
    return jnp.where(length < 4, jnp.float32(-1e9), eos_scores)


def _t_min_len_4(eos_scores, length):
    return torch.where(torch.as_tensor(length) < 4,
                       torch.full_like(eos_scores, -1e9), eos_scores)


def _stop_after_5(state, t):
    return t >= 5


# hook set -> (JAX hooks, port hooks), pinned in the config; norm_or_drop
# rides with a boosted EOS so that endings exist for it
SESSION_HOOKS = {
    None: ({}, {}),
    "norm_or_drop": ({"candidate_adjust": _j_boost_eos,
                      "norm_or_drop": _j_min_len_4},
                     {"candidate_adjust": _t_boost_eos,
                      "norm_or_drop": _t_min_len_4}),
    "stop_beam_search": ({"stop_beam_search": _stop_after_5},
                         {"stop_beam_search": _stop_after_5}),
}


def _gru_decoder(dsl, **hooks):
    """A GRU-step decoder booted from a dense source (the step the card
    runs through ``gru_cell_infer``), ``hooks`` pinned."""
    dsl.reset()
    src = dsl.data("src", size=SH)
    boot = dsl.fc(src, size=SH, act="tanh", name="boot", bias_attr=False)

    def step(prev_emb):
        m = dsl.memory(name="g", size=SH, boot_layer=boot)
        x = dsl.fc(prev_emb, size=3 * SH, act="linear", name="xg",
                   bias_attr=False)
        g = dsl.gru_step_layer(x, m, name="g")
        return dsl.fc(g, size=SV, act="softmax", name="prob",
                      bias_attr=False)

    dsl.beam_search(
        step, [dsl.GeneratedInput(size=SV, embedding_name="gen_emb",
                                  embedding_size=SE)],
        bos_id=0, eos_id=SEOS, beam_size=SK, max_length=SL, name="gen",
        **hooks)
    return dsl.current_graph()


def _session_params(graph, seed):
    rng = np.random.default_rng(seed)
    specs = JNetwork(graph, outputs=["gen"]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.7).astype(np.float32)
              for k, s in sorted(specs.items())}
    params["gen_emb"] = rng.normal(size=(SV, SE)).astype(np.float32)
    return params


class _Pair:
    """The JAX and the port session on one graph, params and sources,
    driven by one schedule."""

    def __init__(self, hook_kind, n_src=5, seed=3):
        j_hooks, t_hooks = SESSION_HOOKS[hook_kind]
        jg = _gru_decoder(jdsl, **j_hooks)
        tg = _gru_decoder(tdsl, **t_hooks)
        self.params = _session_params(jg, seed)
        self.src = np.random.default_rng(seed + 1).normal(
            size=(n_src, SH)).astype(np.float32)
        jp = {k: jnp.asarray(v) for k, v in self.params.items()}
        tp = {k: torch.from_numpy(v) for k, v in self.params.items()}
        self.j_outer = JNetwork(jg, outputs=["boot"]).apply(
            jp, {"src": JArgument(jnp.asarray(self.src))})
        self.t_outer = TNetwork(tg, outputs=["boot"]).apply(
            tp, {"src": TArgument(torch.from_numpy(self.src))})
        self.tg, self.tp = tg, tp
        kw = dict(beam_size=SK, max_length=SL, decode_chunk=SCHUNK)
        self.j = JGenerator(jg, "gen").session(jp, SW, **kw)
        self.t = TGenerator(tg, "gen").session(tp, SW, **kw)

    def admit(self, lane, row):
        self.j.admit(lane, self.j_outer, row=row)
        self.t.admit(lane, self.t_outer, row=row)

    def chunk(self):
        assert self.j.run_chunk() == self.t.run_chunk() == SCHUNK

    def release(self, lane):
        self.j.release(lane)
        self.t.release(lane)

    def check(self, where):
        """Every lane's state and the lane flags equal in both."""
        for a, b in zip(self.t.poll(), self.j.poll()):
            np.testing.assert_array_equal(a, b, err_msg=f"{where} flags")
        assert self.t.free_lanes() == self.j.free_lanes()
        assert self.t.finished_lanes() == self.j.finished_lanes()
        for lane in self.t.active_lanes():
            got, want = self.t.peek(lane), self.j.peek(lane)
            msg = f"{where} lane {lane}"
            np.testing.assert_array_equal(got[0], want[0], err_msg=msg)
            np.testing.assert_array_equal(got[2], want[2], err_msg=msg)
            assert got[3] == want[3] == self.t.lane_steps(lane), msg
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                                       atol=1e-5, err_msg=msg)

    def dedicated(self, row):
        """The port's dedicated search on source ``row`` alone."""
        gen = TGenerator(self.tg, "gen")
        outer = {k: TArgument(value=a.value[row:row + 1])
                 for k, a in self.t_outer.items()}
        out = gen.generate(self.tp, outer, beam_size=SK, max_length=SL,
                           full_scan=True)
        return [x[0].numpy() for x in out]


@pytest.mark.parametrize("hook_kind", list(SESSION_HOOKS))
def test_session_matches_jax_on_one_admission_schedule(hook_kind):
    """(a) and (b): the schedule admits source 0 into lane 0, source 1
    into lane 1 one chunk later (mid-flight), source 2 into lane 2 a chunk
    after that, releases lane 1 after two more chunks and admits source 3
    there, then runs to the end; after every step of it both sessions
    agree. Each lane retired at its end equals the dedicated search."""
    pair = _Pair(hook_kind)
    served = {}  # lane -> row admitted into it

    def admit(lane, row):
        pair.admit(lane, row)
        served[lane] = row
        pair.check(f"admit {row}")

    def retire(lane):
        """The lane's answer, then its release, against the dedicated
        search on its source."""
        tokens, scores, lengths, _ = pair.t.peek(lane)
        want = pair.dedicated(served.pop(lane))
        np.testing.assert_array_equal(tokens, want[0])
        np.testing.assert_array_equal(lengths, want[2])
        np.testing.assert_allclose(scores, want[1], rtol=1e-5, atol=1e-5)
        pair.release(lane)

    admit(0, 0)
    pair.chunk()
    pair.check("chunk 1")
    admit(1, 1)
    pair.chunk()
    pair.check("chunk 2")
    admit(2, 2)
    for i in (3, 4):
        pair.chunk()
        pair.check(f"chunk {i}")
    # lane 1 is released (its search may still run) and admitted again
    pair.release(1)
    served.pop(1)
    pair.check("release 1")
    assert 1 in pair.t.free_lanes()
    admit(1, 3)
    for i in range(5, 5 + SL // SCHUNK + 2):
        pair.chunk()
        pair.check(f"chunk {i}")
        for lane in pair.t.finished_lanes():
            retire(lane)
    assert not served, f"lanes never finished: {served}"
    assert pair.t.free_lanes() == list(range(SW))


def test_session_lanes_are_independent_of_their_neighbours():
    """(b) at K = 2 with every lane busy: the answers of sources 0..4
    through a session of 3 lanes, admitted as lanes free, equal the
    dedicated search on each source alone."""
    pair = _Pair(None, n_src=5, seed=11)
    queue, served, done = list(range(5)), {}, 0
    for _ in range(40):
        for lane in pair.t.free_lanes():
            if queue:
                row = queue.pop(0)
                pair.t.admit(lane, pair.t_outer, row=row)
                served[lane] = row
        pair.t.run_chunk()
        for lane in pair.t.finished_lanes():
            tokens, scores, lengths, _ = pair.t.peek(lane)
            want = pair.dedicated(served.pop(lane))
            np.testing.assert_array_equal(tokens, want[0])
            np.testing.assert_array_equal(lengths, want[2])
            np.testing.assert_allclose(scores, want[1], rtol=1e-5,
                                       atol=1e-5)
            pair.t.release(lane)
            done += 1
        if done == 5:
            break
    assert done == 5


# --------------------------------------- (c)-(h) the length-controlled twin
V, E, H = 6, 4, 5
EOS = 1
K = 3


def _length_controlled_graph(dsl, max_length, beam_size=K, **kw):
    dsl.reset()
    src = dsl.data("src", size=H)
    boot = dsl.fc(src, size=H, act="tanh", name="boot", bias_attr=False)

    def step(prev_emb):
        m = dsl.memory(name="h", size=H, boot_layer=boot)
        h = dsl.fc([prev_emb, m], size=H, act="tanh", name="h",
                   bias_attr=False)
        return dsl.fc(h, size=V, act="softmax", name="prob",
                      bias_attr=False)

    dsl.beam_search(
        step, [dsl.GeneratedInput(size=V, embedding_name="gen_emb",
                                  embedding_size=E)],
        bos_id=0, eos_id=EOS, beam_size=beam_size, max_length=max_length,
        name="gen", **kw)
    return dsl.current_graph()


def _length_controlled_params(graph):
    """EOS logit = 3 * sum(memory), memory = tanh(2 src) decayed by tanh
    each step (JAX's ``_length_controlled_params``), as numpy."""
    params = {k: np.zeros(s.shape, np.float32) for k, s in
              JNetwork(graph, outputs=["gen"]).param_specs.items()}
    params["_boot.w0"] = 2.0 * np.eye(H, dtype=np.float32)
    params["_h.w1"] = np.eye(H, dtype=np.float32)
    u = np.zeros((H, V), np.float32)
    u[:, EOS] = 3.0
    params["_prob.w0"] = u
    params["gen_emb"] = np.zeros((V, E), np.float32)
    return params


def _short():
    return ([1.0] * H,)


def _long():
    return ([-1.0] * H,)


def _predictor(max_length=24, decode_chunk=2, max_batch=4, outputs=("gen",),
               **graph_kw):
    jg = _length_controlled_graph(jdsl, max_length, **graph_kw)
    params = _length_controlled_params(jg)
    tg = _length_controlled_graph(tdsl, max_length, **graph_kw)
    buckets = [b for b in (1, 2, 4) if b <= max_batch]
    return ServingPredictor(tg, params, list(outputs),
                            {"src": ttypes.dense_vector(H)},
                            batch_buckets=buckets,
                            gen_decode_chunk=decode_chunk, device="cpu")


def _engine(continuous=True, **kw):
    eng_kw = {k: kw.pop(k) for k in ("max_batch",) if k in kw}
    pred = _predictor(**kw, **eng_kw)
    return ServingEngine(pred, batch_timeout_ms=2.0,
                         continuous_batching=continuous,
                         **eng_kw).start()


def _gather(eng, samples, deadline_ms=None):
    reqs = [eng.submit(s, kind="generate", deadline_ms=deadline_ms)
            for s in samples]
    for r in reqs:
        assert r.event.wait(WAIT), "engine hung"
    return reqs


@pytest.fixture(scope="module")
def engines():
    cont = _engine(continuous=True)
    try:
        convoy = _engine(continuous=False)
    except BaseException:
        cont.shutdown()
        raise
    try:
        yield cont, convoy
    finally:
        cont.shutdown()
        convoy.shutdown()


def test_continuous_answers_match_convoy_and_jax(engines):
    """(c) The same five requests through the continuous and the convoy
    engine: identical beams (scores within 1e-5), equal to the JAX
    package's predictor on the same graph and parameters."""
    cont, convoy = engines
    assert cont._session is not None and convoy._session is None
    samples = [_short(), _long(), _short(), _long(), _short()]
    got_c = _gather(cont, samples)
    got_v = _gather(convoy, samples)
    jg = _length_controlled_graph(jdsl, 24)
    jpred = JPredictor(jg, _length_controlled_params(jg), ["gen"],
                       {"src": jtypes.dense_vector(H)}, batch_buckets=[1],
                       gen_decode_chunk=2)
    for s, rc, rv in zip(samples, got_c, got_v):
        assert rc.error is None and rv.error is None
        ks, vs = rc.result["sequences"], rv.result["sequences"]
        assert [q["tokens"] for q in ks] == [q["tokens"] for q in vs], s
        (tok, sc, ln), _ = jpred.generate_rows([s])
        assert [q["tokens"] for q in ks] == [
            tok[0, k, :ln[0, k]].tolist() for k in range(K)]
        for k, (a, b) in enumerate(zip(ks, vs)):
            assert abs(a["score"] - b["score"]) < 1e-5
            assert abs(a["score"] - float(sc[0, k])) < 1e-5
    # the length control controls: shorts end within 2 tokens, longs run
    # to max_length
    assert all(len(q["tokens"]) <= 2 for q in got_c[0].result["sequences"])
    assert any(len(q["tokens"]) == 24 for q in got_c[1].result["sequences"])
    assert cont.fatal is None and convoy.fatal is None


def test_short_requests_escape_the_convoy(engines):
    """(d) A long request, then six shorts through 4 lanes: every short
    is answered while the long lane still decodes, some were admitted
    mid-decode, and each short ran fewer decode steps than the long."""
    cont, _ = engines
    base = cont.metrics.counters["continuous_admissions_total"]
    steps_before = len(cont.metrics.decode_steps._recent)
    long_req = cont.submit(_long(), kind="generate")
    shorts = [cont.submit(_short(), kind="generate") for _ in range(6)]
    for r in shorts:
        assert r.event.wait(WAIT)
        assert r.error is None
    assert not long_req.event.is_set(), \
        "short requests waited for the slow lane (convoy not broken)"
    assert long_req.event.wait(WAIT)
    assert long_req.error is None
    assert cont.metrics.counters["continuous_admissions_total"] > base
    steps = list(cont.metrics.decode_steps._recent)[steps_before:]
    assert len(steps) == 7
    # the long request retired last, after max_length steps
    assert steps[-1] == 24 and max(steps[:-1]) < steps[-1], steps
    snap = cont.metrics.snapshot()
    assert snap["lane_occupancy"]["count"] > 0
    assert snap["decode_chunks_total"] > 0
    assert cont.metrics.counters["decode_steps_saved_total"] > 0
    assert cont.fatal is None


def test_deadline_enforced_mid_decode():
    """(e) A lane whose deadline passes mid-search is answered
    ``DeadlineExceeded`` at the next chunk boundary and freed; its
    neighbour completes. A floor of 5 ms a chunk keeps the 192-step
    search well past the 40-ms deadline."""
    eng = _engine(max_length=192, decode_chunk=1, max_batch=2)
    try:
        real_chunk = eng._session.run_chunk

        def slow_chunk():
            out = real_chunk()
            time.sleep(0.005)
            return out

        eng._session.run_chunk = slow_chunk
        neighbor = eng.submit(_long(), kind="generate")
        doomed = eng.submit(_long(), kind="generate", deadline_ms=40.0)
        assert doomed.event.wait(WAIT)
        assert isinstance(doomed.error, DeadlineExceeded)
        assert "mid-decode" in str(doomed.error)
        assert not neighbor.event.is_set(), \
            "the deadline answer waited for the whole batch"
        # the lane was freed at once: a new request is admitted into it
        # while the neighbour still decodes
        follow = eng.submit(_short(), kind="generate")
        assert follow.event.wait(WAIT) and follow.error is None
        assert not neighbor.event.is_set()
        assert neighbor.event.wait(WAIT)
        assert neighbor.error is None
        assert any(len(q["tokens"]) == 192
                   for q in neighbor.result["sequences"])
        assert eng.metrics.counters["deadline_exceeded_total"] == 1
        assert eng.fatal is None
    finally:
        eng.shutdown()


def test_two_bucket_seq2seq_stands_down_to_convoy(caplog):
    """(f) seq2seq's encoded source pads to its request's length bucket,
    so with two buckets a session's lanes cannot hold it: build_session
    warns and returns None, and the engine serves convoy batching. With
    one bucket the session is built."""
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    tdsl.reset()
    seq2seq_attention(src_vocab=30, trg_vocab=30, embed_dim=8, hidden=8,
                      beam_size=2, max_length=6, generating=True)
    graph = tdsl.current_graph()
    params = {k: v.numpy() for k, v in Network(
        graph, outputs=["gen"]).init_params(
            torch.Generator().manual_seed(0), device="cpu").items()}
    from paddle_tpu_torch.core.generation import generation_params
    for name, shape in generation_params(graph).items():
        params[name] = np.random.default_rng(0).normal(
            size=shape).astype(np.float32)
    feeding = {"source_words": ttypes.integer_value_sequence(30)}

    def pred(buckets):
        return ServingPredictor(graph, params, ["gen"], feeding,
                                batch_buckets=[1, 2],
                                length_buckets=buckets, gen_decode_chunk=2,
                                device="cpu")

    with caplog.at_level("WARNING"):
        assert pred([4, 8]).build_session(2) is None
    assert "continuous batching stood down" in caplog.text
    assert "length buckets" in caplog.text
    eng = ServingEngine(pred([4, 8]), continuous_batching=True,
                        batch_timeout_ms=1.0).start(warmup=False)
    try:
        assert eng._session is None and not eng.continuous_batching
        r = eng.submit(([3, 4, 5],), kind="generate")
        assert r.event.wait(WAIT) and r.error is None
        assert len(r.result["sequences"]) == 2
    finally:
        eng.shutdown()
    assert pred([8]).build_session(2) is not None


def test_full_scan_policy_stands_down(caplog):
    """(f) A config-pinned full scan reaches the predictor (no early
    exit) and continuous batching stands down with its warning; an
    explicit chunk overrides the pin; ``--decode_chunk 0`` is the full
    scan too."""
    pred = _predictor(max_length=6, decode_chunk=None, max_batch=1,
                      beam_size=2, full_scan=True)
    assert pred.gen_effective_full_scan()
    pred.warmup()
    _, info = pred.generate_rows([_short()])
    assert info["decode_steps"] == 6
    with caplog.at_level("WARNING"):
        assert pred.build_session(2) is None
    assert "full_scan" in caplog.text
    pred2 = _predictor(max_length=6, decode_chunk=2, max_batch=1,
                       beam_size=2, full_scan=True)
    assert not pred2.gen_effective_full_scan()
    _, info2 = pred2.generate_rows([_short()])
    assert info2["decode_steps"] < 6 and info2["steps_saved"] > 0
    pred3 = _predictor(max_length=6, decode_chunk=0, max_batch=1)
    assert pred3.gen_effective_full_scan()
    assert pred3.build_session(2) is None


def test_generate_traffic_does_not_starve_queued_score_requests():
    """(g) Admission at chunk boundaries pauses while a score request
    waits: the session drains, the worker returns to the queue, and the
    score is answered while generate traffic keeps coming."""
    eng = _engine(max_length=48, max_batch=2, outputs=("gen", "boot"))
    try:
        gens = [eng.submit(_long(), kind="generate") for _ in range(4)]
        score = eng.submit(_short(), kind="score")
        gens += [eng.submit(_long(), kind="generate") for _ in range(4)]
        assert score.event.wait(WAIT), "score request starved"
        assert score.error is None
        assert not all(g.event.is_set() for g in gens), \
            "the score waited for every generate request"
        np.testing.assert_allclose(score.result["outputs"]["boot"],
                                   np.tanh([2.0] * H), rtol=1e-6)
        for r in gens:
            assert r.event.wait(WAIT)
            assert r.error is None
        assert eng.fatal is None
    finally:
        eng.shutdown()


def _series(text):
    """The Prometheus series of an export: every sample line up to its
    value."""
    return sorted(line.rsplit(" ", 1)[0] for line in text.splitlines()
                  if line and not line.startswith("#"))


def _http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_metrics_series_match_jax_and_livez_stays_up_while_draining():
    """(h) The same traffic (two generate requests, one score, one after
    the other) through the port's and the JAX package's continuous
    engines: ``/metrics`` exports the same series and type lines, and the
    JSON snapshot the same keys; draining turns ``/healthz`` to 503 while
    ``/livez`` stays 200."""
    eng = _engine(max_length=8, max_batch=2, outputs=("gen", "boot"))
    jg = _length_controlled_graph(jdsl, 8)
    jeng = JEngine(JPredictor(jg, _length_controlled_params(jg),
                              ["gen", "boot"],
                              {"src": jtypes.dense_vector(H)},
                              batch_buckets=[1, 2], gen_decode_chunk=2),
                   max_batch=2, batch_timeout_ms=2.0,
                   continuous_batching=True)
    server = None
    try:
        jeng.start()
        for e in (eng, jeng):
            for sample, kind in ((_short(), "generate"),
                                 (_long(), "generate"),
                                 (_short(), "score")):
                r = e.submit(sample, kind=kind)
                assert r.event.wait(WAIT) and r.error is None
        server = make_server(eng, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        status, text = _http_get(port, "/metrics")
        assert status == 200
        text = text.decode()
        jtext = jeng.metrics.to_prometheus()
        assert _series(text) == _series(jtext)
        assert ([ln for ln in text.splitlines() if ln.startswith("#")]
                == [ln for ln in jtext.splitlines() if ln.startswith("#")])
        status, body = _http_get(port, "/metrics?format=json")
        snap = json.loads(body)
        assert status == 200
        assert sorted(snap) == sorted(jeng.metrics.snapshot())
        assert snap["decode_chunks_total"] > 0
        assert re.search(r"_lane_occupancy \d", text)
        assert _http_get(port, "/livez")[0] == 200
        assert _http_get(port, "/healthz")[0] == 200
        eng.begin_drain()
        status, body = _http_get(port, "/healthz")
        assert status == 503 and json.loads(body)["status"] == "draining"
        status, body = _http_get(port, "/livez")
        assert status == 200 and json.loads(body)["live"] is True
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        eng.shutdown()
        jeng.shutdown()
