"""The quantized serving tier of the PyTorch port against the JAX package,
on the CPU: ``paddle_tpu_torch/quant.py`` (quantize, dequantize, the
golden set and the gate's delta), the storage-dtype load and lazy view,
the warmup gate (``serving/predictor.py``), the PTM1 writer's bf16 form
(``trainer/merge_model.py``) and ``--job merge --quantize``.

- ``quantize_params`` is bit-equal to JAX's for bf16 and int8 (storage
  bits, scales, row-wise sparse tables, the ``skipped`` dicts);
  ``dequantize_params``, ``gate_delta`` and ``make_golden_rows`` equal
  JAX's; ``golden_section`` is within 1e-5 of JAX's;
- the quantization matrix over the port's 8 servable families, with
  JAX's closure check against ``paddle_tpu_torch/data/types.py``;
- the drifted int8 artifact (JAX's ``_drifted_int8``) raises
  ``QuantGateError`` with JAX's wire fields and deltas within 1e-6;
- the lazy view holds no more dequantized leaves than the layer being
  run reads;
- a port-written bf16 file loads with ``ml_dtypes`` hidden, and a
  JAX-written one then fails with the named error.
"""

import os
import subprocess
import sys
import textwrap
import weakref

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import quant as jquant
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import types as jtypes
from paddle_tpu.models.lstm_text import lstm_text_classifier as j_classifier
from paddle_tpu.serving import ServingPredictor as JPredictor
from paddle_tpu.serving.errors import QuantGateError as JQuantGateError
from paddle_tpu.trainer.merge_model import merge_model as j_merge_model
from paddle_tpu_torch import quant as tquant
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as T
from paddle_tpu_torch.serving import (QuantGateError, ServingEngine,
                                      ServingPredictor)
from paddle_tpu_torch.trainer.merge_model import (load_merged_ex,
                                                  merge_model, merged_digest)

DIM, VOCAB, CLASSES = 6, 12, 2


def _table(seed=0):
    """Leaves of every kind: 2-D and 3-D weights, an outlier-row sparse
    table, a zero tensor, a sparse 1-D table, a bias, an int leaf."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(8, 4)).astype(np.float32)
    emb[2] *= 100.0
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "w3": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "emb": emb,
            "zero": np.zeros((3, 4), np.float32),
            "sparse1d": np.arange(5, dtype=np.float32),
            "bias": rng.normal(size=(7,)).astype(np.float32),
            "steps": np.arange(4, dtype=np.int32)}


SPARSE = {"emb", "sparse1d"}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantize_params_bit_equal_to_jax(dtype):
    params = _table()
    jq, jmeta = jquant.quantize_params(params, dtype, sparse_names=SPARSE)
    tq, tmeta = tquant.quantize_params(params, dtype, sparse_names=SPARSE)
    assert sorted(tq) == sorted(jq)
    for name, want in jq.items():
        got = tq[name]
        want = np.asarray(want)
        if dtype == "bf16" and name != "steps":
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got, want.view(np.uint16),
                                          err_msg=name)
        else:
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert tmeta["skipped"] == jmeta["skipped"]
    assert tmeta["dtype"] == jmeta["dtype"] and tmeta["tol"] == jmeta["tol"]
    assert sorted(tmeta["scales"]) == sorted(jmeta["scales"])
    for name, s in jmeta["scales"].items():
        np.testing.assert_array_equal(tmeta["scales"][name], s)
        assert tmeta["scales"][name].dtype == np.float32
    if dtype == "int8":
        assert tmeta["scales"]["emb"].shape == (8, 1)  # row-wise
        assert tmeta["scales"]["zero"] == np.float32(1.0)
        assert "row-wise" in tmeta["skipped"]["sparse1d"]
    else:
        assert tmeta[tquant.BF16_STORAGE_KEY] == "uint16"
    # dequantize: the port's on its own storage equals JAX's on JAX's.
    # JAX's leaves a bf16 leaf in bf16 (numpy does not count
    # ml_dtypes.bfloat16 as floating); the port's gives its f32 values
    jd = jquant.dequantize_params(jq, jmeta)
    td = tquant.dequantize_params(tq, tmeta)
    for name, want in jd.items():
        want = np.asarray(want)
        if dtype == "bf16" and name != "steps":
            want = want.astype(np.float32)
        np.testing.assert_array_equal(td[name], want, err_msg=name)
        assert td[name].dtype == want.dtype, name
    # and the port's dequantize reads JAX's ml_dtypes storage too
    td2 = tquant.dequantize_params(jq, jmeta)
    for name, want in td.items():
        np.testing.assert_array_equal(td2[name], want)
        assert td2[name].dtype == want.dtype


def test_bf16_rounds_to_nearest_even_like_jax():
    """Values on the rounding boundaries of bf16 (ties, subnormals,
    infinities, the largest finite f32) cast bit-equal."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x00000001,
                     0x80400000, 0x7F7FFFFF, 0x7F800000, 0xFF800000,
                     0x477FF000, 0x00000000], np.uint32)
    w = bits.view(np.float32).reshape(2, 5)
    jq, _ = jquant.quantize_params({"w": w}, "bf16")
    tq, _ = tquant.quantize_params({"w": w}, "bf16")
    np.testing.assert_array_equal(tq["w"], np.asarray(jq["w"]).view(
        np.uint16))


def test_unknown_quant_dtype_is_a_typed_refusal():
    with pytest.raises(ValueError, match="fp8"):
        tquant.quantize_params({"w": np.eye(2, dtype=np.float32)}, "fp8")


def test_gate_delta_and_int8_scale_equal_jax():
    rng = np.random.default_rng(2)
    for shape in ((4, 3), (1, 7)):
        a = rng.normal(size=shape)
        b = a + rng.normal(size=shape) * 1e-2
        assert tquant.gate_delta(a, b) == jquant.gate_delta(a, b)
        assert tquant.gate_delta(a * 0.1, b * 0.1) == jquant.gate_delta(
            a * 0.1, b * 0.1)
    w = np.array([[0.0, 0.0], [3.0, -4.0]], np.float32)
    np.testing.assert_array_equal(tquant.int8_scale(w, axis=(1,)),
                                  jquant.int8_scale(w, axis=(1,)))
    np.testing.assert_array_equal(tquant.int8_scale(w),
                                  jquant.int8_scale(w))


def _feeding(types):
    return {name: getattr(types, name)(DIM if "vector" in name else VOCAB)
            for name in MATRIX}


def _rows_equal(got, want):
    """Golden rows, slot by slot (numpy vectors by value)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            elif isinstance(b, list) and b and isinstance(b[0],
                                                          np.ndarray):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                assert a == b


def test_make_golden_rows_equal_jax_over_every_family():
    """One feeding with a slot of every servable family: the same draw
    order gives the same rows; a nested slot is refused."""
    _rows_equal(tquant.make_golden_rows(_feeding(T), n=5),
                jquant.make_golden_rows(_feeding(jtypes), n=5))
    with pytest.raises(ValueError, match="nested sequence"):
        tquant.make_golden_rows(
            {"x": T.integer_value_sub_sequence(VOCAB)})


# ------------------------------------------------------------ the matrix
def _servable_families():
    """Every non-nested InputType constructor of the port's
    ``data/types.py``."""
    fams = []
    for name in dir(T):
        if name.startswith("_"):
            continue
        fn = getattr(T, name)
        if not callable(fn) or isinstance(fn, type):
            continue
        try:
            itype = fn(4)
        except TypeError:
            continue
        if isinstance(itype, T.InputType) \
                and itype.seq_type != T.SUB_SEQUENCE:
            fams.append(name)
    return sorted(fams)


MATRIX = {
    "dense_vector": T.dense_vector(DIM),
    "dense_vector_sequence": T.dense_vector_sequence(DIM),
    "integer_value": T.integer_value(VOCAB),
    "integer_value_sequence": T.integer_value_sequence(VOCAB),
    "sparse_binary_vector": T.sparse_binary_vector(DIM),
    "sparse_binary_vector_sequence": T.sparse_binary_vector_sequence(DIM),
    "sparse_float_vector": T.sparse_float_vector(DIM),
    "sparse_float_vector_sequence": T.sparse_float_vector_sequence(DIM),
}


def test_matrix_is_closed_over_servable_families():
    """Every servable family of the port's ``data/types.py`` has a matrix
    row: a new constructor fails here until it gets one."""
    assert sorted(MATRIX) == _servable_families()


def _demo(dsl, itype, seed=0):
    """(graph, params as numpy, feeding) of one matrix row: a scoring
    config that consumes the family's feed layout (JAX's ``_demo``)."""
    dsl.reset()
    x = dsl.data(name="x", size=itype.dim)
    h = x
    if itype.type == T.INDEX:
        h = dsl.embedding(input=h, size=5, name="emb")
    if itype.seq_type == T.SEQUENCE:
        h = dsl.pooling(input=h, pooling_type="avg", name="pool")
    dsl.fc(input=h, size=CLASSES, act="softmax", name="out")
    graph = dsl.current_graph()
    params = {k: v.numpy() for k, v in TNetwork(graph, outputs=["out"])
              .init_params(torch.Generator().manual_seed(seed),
                           device="cpu").items()}
    return graph, params, {"x": itype}


@pytest.mark.parametrize("family", sorted(MATRIX))
def test_quantization_matrix_row(family, tmp_path):
    """One family, both dtypes: merged quantized by the port, served, the
    gate green, scores within the dtype's tolerance of the recorded fp32
    references, the weights resident in their storage dtype."""
    itype = MATRIX[family]
    graph, params, feeding = _demo(tdsl, itype)
    golden = tquant.golden_section(graph, params, ["out"], feeding)
    assert golden is not None
    refs = golden["outputs"]["out"]
    rows = [tuple(r) for r in golden["rows"]]
    sparse = {"_emb.w0"} if itype.type == T.INDEX else set()
    for dt in tquant.QUANT_DTYPES:
        qparams, meta = tquant.quantize_params(params, dt,
                                               sparse_names=sparse)
        path = os.path.join(str(tmp_path), f"{family}.{dt}.ptmodel")
        merge_model(path, graph, qparams, outputs=["out"], quant=meta,
                    golden=golden)
        pred = ServingPredictor.from_merged(
            path, feeding, batch_buckets=[len(rows)], length_buckets=[4],
            device="cpu")
        want = {"bf16": torch.bfloat16, "int8": torch.int8}[dt]
        assert pred.params["_out.w0"].dtype == want
        pred.warmup()
        tol = tquant.GATE_TOLERANCES[dt]
        assert pred.quant_gate["passed"] is True
        assert pred.quant_gate["max_delta"] <= tol
        assert pred.quant_health()["dtype"] == dt
        assert pred.model_version.endswith("+" + dt)
        outs, _ = pred.predict_rows(rows)
        assert tquant.gate_delta(outs["out"][:len(rows)], refs) <= tol


def test_golden_section_within_1e5_of_jax():
    """The LSTM classifier's golden section from one parameter table:
    the same rows, outputs within 1e-5."""
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    jdsl.reset()
    _, jout, _ = j_classifier(vocab_size=VOCAB, embed_dim=4, hidden=8)
    jgraph = jdsl.current_graph()
    params = {k: np.asarray(v) for k, v in JNetwork(
        jgraph, outputs=[jout.name]).init_params(
            jax.random.PRNGKey(3)).items()}
    tdsl.reset()
    _, tout, _ = lstm_text_classifier(vocab_size=VOCAB, embed_dim=4,
                                      hidden=8)
    tgraph = tdsl.current_graph()

    def feeding(types):
        return {"words": types.integer_value_sequence(VOCAB),
                "label": types.integer_value(CLASSES)}

    want = jquant.golden_section(jgraph, params, [jout.name],
                                 feeding(jtypes))
    got = tquant.golden_section(tgraph, params, [tout.name], feeding(T))
    _rows_equal(got["rows"], want["rows"])
    assert got["n"] == want["n"]
    np.testing.assert_allclose(got["outputs"][tout.name],
                               want["outputs"][jout.name], rtol=1e-5,
                               atol=1e-5)


def test_generation_only_config_records_no_golden(caplog):
    tdsl.reset()
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    seq2seq_attention(src_vocab=20, trg_vocab=20, embed_dim=4, hidden=4,
                      beam_size=2, max_length=4, generating=True)
    graph = tdsl.current_graph()
    with caplog.at_level("WARNING"):
        assert tquant.golden_section(
            graph, {}, ["gen"],
            {"source_words": T.integer_value_sequence(20)}) is None
    assert "generation-only" in caplog.text


# --------------------------------------------- the gate refuses READY
def _drifted_int8(tmp_path, graph, params, feeding):
    """JAX's ``_drifted_int8``: an int8 artifact whose quantized table was
    corrupted after the golden references were recorded, merged by the
    JAX package."""
    golden = jquant.golden_section(graph, params, ["out"], feeding)
    qparams, meta = jquant.quantize_params(params, "int8")
    name = next(k for k, v in qparams.items() if v.dtype == np.int8)
    bad = dict(qparams)
    bad[name] = np.clip(bad[name].astype(np.int32) * -3,
                        -127, 127).astype(np.int8)
    p = os.path.join(str(tmp_path), "drifted.int8.ptmodel")
    j_merge_model(p, graph, bad, outputs=["out"], quant=meta,
                  golden=golden)
    return p


def test_drifted_artifact_refuses_ready_like_jax(tmp_path):
    jgraph, _, _ = _demo(jdsl, jtypes.dense_vector(DIM))
    params = {k: np.asarray(v) for k, v in JNetwork(
        jgraph, outputs=["out"]).init_params(
            jax.random.PRNGKey(0)).items()}
    p = _drifted_int8(tmp_path, jgraph, params,
                      {"x": jtypes.dense_vector(DIM)})
    jpred = JPredictor.from_merged(p, {"x": jtypes.dense_vector(DIM)},
                                   batch_buckets=[4])
    with pytest.raises(JQuantGateError) as jerr:
        jpred.warmup()
    pred = ServingPredictor.from_merged(p, {"x": T.dense_vector(DIM)},
                                        batch_buckets=[4], device="cpu")
    with pytest.raises(QuantGateError) as terr:
        pred.warmup()
    got, want = terr.value.to_wire()["error"], jerr.value.to_wire()["error"]
    assert sorted(got) == sorted(want)
    assert got["code"] == want["code"] == "quant_gate"
    assert terr.value.status == jerr.value.status == 503
    assert got["gate"]["dtype"] == want["gate"]["dtype"] == "int8"
    assert got["gate"]["tol"] == want["gate"]["tol"]
    assert sorted(got["gate"]["deltas"]) == sorted(want["gate"]["deltas"])
    for k, d in want["gate"]["deltas"].items():
        assert abs(got["gate"]["deltas"][k] - d) <= 1e-6
        assert d > want["gate"]["tol"]
    assert pred.warmed is False and pred.quant_gate["passed"] is False
    assert pred.model_version == jpred.model_version
    # through the engine: start() raises, the server never goes ready,
    # and /healthz carries the verdict
    eng = ServingEngine(ServingPredictor.from_merged(
        p, {"x": T.dense_vector(DIM)}, batch_buckets=[4], device="cpu"),
        batch_timeout_ms=1.0)
    try:
        with pytest.raises(QuantGateError):
            eng.start(warmup=True)
        h = eng.health()
        assert h["ready"] is False and h["status"] == "warming"
        assert h["quant"]["dtype"] == "int8"
        assert h["quant"]["gate"]["passed"] is False
    finally:
        eng.shutdown(drain=False)


# ----------------------------------------------------------- the lazy view
def test_lazy_view_holds_one_layers_leaves_at_a_time():
    """A counting view over the LSTM classifier's int8 table: every leaf
    is dequantized when its layer reads it and freed with the layer; the
    dequantized leaves alive at once never outnumber the parameters of
    the layer being run, and no f32 copy of the table is built."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    tdsl.reset()
    _, out, _ = lstm_text_classifier(vocab_size=VOCAB, embed_dim=4,
                                     hidden=8, num_layers=2)
    graph = tdsl.current_graph()
    net = TNetwork(graph, outputs=[out.name])
    params = {k: v.numpy() for k, v in net.init_params(
        torch.Generator().manual_seed(1), device="cpu").items()}
    qparams, meta = tquant.quantize_params(params, "int8")
    from paddle_tpu_torch.compat.from_jax import quantized_params_from_numpy
    store = quantized_params_from_numpy(qparams, meta, "cpu", net)
    alive, reads, peak = weakref.WeakSet(), [], [0]

    class Counting(tquant.DequantView):
        def __getitem__(self, name):
            leaf = super().__getitem__(name)
            if leaf is not store.get(name):  # a dequantized copy
                alive.add(leaf)
                peak[0] = max(peak[0], len(alive))
            reads.append(name)
            return leaf

    feed = DataFeeder({"words": T.integer_value_sequence(VOCAB),
                       "label": T.integer_value(CLASSES)}, device="cpu")(
        [([1, 2, 3], 0), ([4, 5], 1)])
    with torch.no_grad():
        got = net.apply(Counting(store), feed)[out.name].value
    want = net.apply({k: torch.from_numpy(v) for k, v in
                      tquant.dequantize_params(qparams, meta).items()},
                     feed)[out.name].value
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    per_layer = max(len(p) for p in net._layer_params.values())
    assert sorted(reads) == sorted(n for p in net._layer_params.values()
                                   for n in p.values())
    assert 1 <= peak[0] <= per_layer < len(qparams)
    assert len(alive) == 0  # nothing dequantized outlives its layer
    assert all(t.dtype == torch.int8 for k, t in store.items()
               if k in meta["scales"])


# ------------------------------------------------------- the bf16 form
def test_port_bf16_file_loads_without_ml_dtypes(tmp_path):
    """A bf16 file the port writes holds uint16 bits: it serves in a
    process where ``ml_dtypes`` cannot be imported, the same scores as
    with it. A bf16 file the JAX package writes then fails with the
    named ``Bfloat16Unavailable``."""
    graph, params, feeding = _demo(tdsl, T.dense_vector(DIM))
    golden = tquant.golden_section(graph, params, ["out"], feeding)
    qparams, meta = tquant.quantize_params(params, "bf16")
    port_file = tmp_path / "port.bf16.ptmodel"
    merge_model(str(port_file), graph, qparams, outputs=["out"], quant=meta,
                golden=golden)
    jgraph, _, _ = _demo(jdsl, jtypes.dense_vector(DIM))
    jq, jmeta = jquant.quantize_params(params, "bf16")
    jax_file = tmp_path / "jax.bf16.ptmodel"
    j_merge_model(str(jax_file), jgraph, jq, outputs=["out"], quant=jmeta)
    rows = [tuple(r) for r in golden["rows"]]
    pred = ServingPredictor.from_merged(str(port_file), feeding,
                                        batch_buckets=[4], device="cpu")
    pred.warmup()
    want = pred.predict_rows(rows)[0]["out"]
    np.save(tmp_path / "want.npy", want)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None  # import ml_dtypes now fails
        import numpy as np
        from paddle_tpu_torch import quant
        from paddle_tpu_torch.data import types
        from paddle_tpu_torch.serving import ServingPredictor
        from paddle_tpu_torch.trainer.merge_model import (
            Bfloat16Unavailable, load_merged_ex)
        feeding = {{"x": types.dense_vector({DIM})}}
        pred = ServingPredictor.from_merged({str(port_file)!r}, feeding,
                                            batch_buckets=[4],
                                            device="cpu")
        pred.warmup()
        assert pred.quant_gate["passed"]
        rows = [tuple(r) for r in quant.make_golden_rows(feeding)]
        got = pred.predict_rows(rows)[0]["out"]
        assert np.array_equal(got, np.load({str(tmp_path / "want.npy")!r}))
        try:
            load_merged_ex({str(jax_file)!r})
        except Bfloat16Unavailable as e:
            assert "ml_dtypes" in str(e)
        else:
            raise AssertionError("a JAX bf16 file loaded without ml_dtypes")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "paddle_tpu")
               or (m.startswith("ml_dtypes") and sys.modules[m])]
        assert not bad, bad
        print("clean")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    # with ml_dtypes, the JAX file serves the port's scores
    jpred = ServingPredictor.from_merged(str(jax_file), feeding,
                                         batch_buckets=[4], device="cpu")
    np.testing.assert_array_equal(jpred.predict_rows(rows)[0]["out"], want)


def test_cli_merge_quantize_and_the_training_refusal(tmp_path):
    """``--job merge --quantize int8`` writes the quant and golden
    sections (the golden outputs from the fp32 parameters), the PTM1
    digest differs from the fp32 merge's, ``--job serve``'s plan passes
    both sections to the predictor, and ``--job test`` refuses the
    quantized file."""
    from paddle_tpu_torch.trainer import cli
    conf = tmp_path / "conf.py"
    conf.write_text(textwrap.dedent(f"""
        from paddle_tpu_torch.data.types import (integer_value,
                                                 integer_value_sequence)
        from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
        cost, out, _ = lstm_text_classifier(vocab_size={VOCAB},
                                            embed_dim=4, hidden=8)
        outputs = [out]
        feeding = {{"words": integer_value_sequence({VOCAB}),
                   "label": integer_value(2)}}

        def train_reader():
            yield [([1, 2, 3], 0), ([4, 5], 1)]
    """))
    paths = {}
    for dt in (None, "int8"):
        paths[dt] = str(tmp_path / f"m.{dt}.ptmodel")
        args = ["--config", str(conf), "--job", "merge", "--device", "cpu",
                "--model_path", paths[dt], "--seed", "5"]
        if dt:
            args += ["--quantize", dt, "--quantize_tol", "0.07"]
        assert cli.main(args) == 0
    assert merged_digest(paths[None]) != merged_digest(paths["int8"])
    graph, fp32, outs, extras = load_merged_ex(paths[None])
    assert extras == {}
    _, q, _, extras = load_merged_ex(paths["int8"])
    assert extras["quant"]["dtype"] == "int8"
    assert extras["quant"]["tol"] == 0.07
    assert q["_output.w0"].dtype == np.int8
    golden = extras["golden"]
    ns = cli.load_config(str(conf))
    want = tquant.golden_section(graph, fp32, outs, ns["feeding"])
    np.testing.assert_array_equal(golden["outputs"]["output"],
                                  want["outputs"]["output"])
    args = cli.parse_args(["--config", str(conf), "--job", "serve",
                           "--device", "cpu", "--init_model_path",
                           paths["int8"], "--max_batch", "4",
                           "--serving_length_buckets", "8"])
    eng = cli.build_serving_engine(ns, args)
    try:
        eng.start()
        assert eng.predictor.model_version.endswith("+int8")
        assert eng.health()["quant"]["gate"]["passed"] is True
        assert eng.health()["quant"]["gate"]["tol"] == 0.07
    finally:
        eng.shutdown()
    with pytest.raises(SystemExit, match="quantized merged model"):
        cli.main(["--config", str(conf), "--job", "test", "--device", "cpu",
                  "--init_model_path", paths["int8"]])
