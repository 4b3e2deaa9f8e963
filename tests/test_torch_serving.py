"""The PyTorch port's serving path on the CPU, against the JAX package.

A PTM1 merged model written by the JAX package is served by the port's
``ServingPredictor`` and must score the JAX predictor's answers (rtol/atol
1e-5); loading it must not import JAX; the port's HTTP server speaks the
JAX package's wire (driven here by ``paddle_tpu.serving.ServingClient``);
and ``python -m paddle_tpu_torch.trainer.cli --job serve`` serves a merged
model and drains to exit 0 on SIGTERM.
"""

import http.client
import json
import signal
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import types as jtypes
from paddle_tpu.models.lstm_text import lstm_text_classifier as j_classifier
from paddle_tpu.serving import ServingClient
from paddle_tpu.serving import ServingPredictor as JPredictor
from paddle_tpu.serving.errors import BadRequest as JBadRequest
from paddle_tpu.serving.errors import ShuttingDown as JShuttingDown
from paddle_tpu.trainer.merge_model import merge_model as j_merge_model
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.serving import (ServingEngine, ServingPredictor,
                                      make_server)
from paddle_tpu_torch.trainer.merge_model import load_merged_ex

V, E, H = 50, 6, 16
BUCKETS = dict(batch_buckets=[1, 2, 4], length_buckets=[8, 16])


def _feeding(types):
    return {"words": types.integer_value_sequence(V),
            "label": types.integer_value(2)}


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, size=int(rng.integers(1, 17))).tolist(),
             int(rng.integers(0, 2))) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """lstm_text_classifier merged to PTM1 by the JAX package, with every
    parameter (biases and peepholes included) random."""
    jdsl.reset()
    _, out, _ = j_classifier(vocab_size=V, embed_dim=E, hidden=H)
    graph = jdsl.current_graph()
    net = JNetwork(graph, outputs=[out.name])
    rng = np.random.default_rng(0)
    params = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
              for k, v in net.init_params(jax.random.PRNGKey(0)).items()}
    path = tmp_path_factory.mktemp("ptm1") / "model.ptmodel"
    j_merge_model(str(path), graph, params, outputs=[out.name])
    return path


def test_port_serves_jax_merged_model_like_jax(jax_model):
    port = ServingPredictor.from_merged(str(jax_model), _feeding(ttypes),
                                        device="cpu", **BUCKETS)
    ref = JPredictor.from_merged(str(jax_model), _feeding(jtypes),
                                 **BUCKETS)
    for rows in (_rows(1, 3), _rows(2, 1), _rows(3, 4)):
        got, ginfo = port.predict_rows(rows)
        want, winfo = ref.predict_rows(rows)
        assert ginfo["bucket"] == winfo["bucket"]
        np.testing.assert_allclose(got["output"], want["output"],
                                   rtol=1e-5, atol=1e-5)
    assert port.model_version == ref.model_version


def test_port_loads_jax_ptm1_without_importing_jax(jax_model):
    code = textwrap.dedent(f"""
        import sys
        import paddle_tpu_torch
        from paddle_tpu_torch.data import types
        from paddle_tpu_torch.serving import ServingPredictor
        pred = ServingPredictor.from_merged(
            {str(jax_model)!r},
            {{"words": types.integer_value_sequence({V}),
              "label": types.integer_value(2)}},
            batch_buckets=[1], length_buckets=[8], device="cpu")
        outs, _ = pred.predict_rows([([1, 2, 3], 0)])
        assert abs(float(outs["output"][0].sum()) - 1.0) < 1e-5
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "paddle_tpu" or m.startswith("paddle_tpu.")]
        assert not bad, bad
        print("clean")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_port_refuses_unmapped_jax_classes(tmp_path):
    """A pickled class of the JAX package without a port copy is refused
    loudly instead of importing paddle_tpu."""
    import pickle

    from paddle_tpu.core.registry import ShapeInfo
    jdsl.reset()
    jdsl.data(name="x", size=4)
    graph = jdsl.current_graph()
    graph.layers["x"].attrs["info"] = ShapeInfo(size=4)
    path = tmp_path / "alien.ptmodel"
    j_merge_model(str(path), graph, {}, outputs=["x"])
    with pytest.raises(pickle.UnpicklingError, match="paddle_tpu.core"):
        load_merged_ex(str(path))


def test_port_refuses_quantized_ptm1(tmp_path):
    """Quantized merges (quant/golden sections) are not served yet: a
    clear error, never raw storage-dtype weights."""
    jdsl.reset()
    _, out, _ = j_classifier(vocab_size=V, embed_dim=E, hidden=H)
    graph = jdsl.current_graph()
    params = {k: np.asarray(v) for k, v in JNetwork(
        graph, outputs=[out.name]).init_params(
            jax.random.PRNGKey(1)).items()}
    path = tmp_path / "q.ptmodel"
    j_merge_model(str(path), graph, params, outputs=[out.name],
                  quant={"dtype": "bf16"})
    with pytest.raises(ValueError, match="quantized"):
        ServingPredictor.from_merged(str(path), _feeding(ttypes),
                                     device="cpu", **BUCKETS)


@pytest.fixture
def port_server(jax_model):
    pred = ServingPredictor.from_merged(str(jax_model), _feeding(ttypes),
                                        device="cpu", **BUCKETS)
    eng = ServingEngine(pred, max_batch=4, batch_timeout_ms=2.0,
                        queue_depth=16).start()
    server = make_server(eng, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield pred, eng, server.server_address[1]
    server.shutdown()
    eng.shutdown()
    thread.join(timeout=10)
    server.server_close()


def test_port_server_speaks_the_jax_wire(port_server):
    pred, eng, port = port_server
    client = ServingClient(port=port)
    assert client.healthz()["status"] == "ok"
    sample = _rows(4, 1)[0]
    got = np.asarray(client.score(list(sample))["outputs"]["output"])
    want, _ = pred.predict_rows([sample])
    np.testing.assert_allclose(got, want["output"][0], rtol=1e-6)
    assert abs(got.sum() - 1.0) < 1e-5
    # an id outside the declared range: typed 400, rebuilt client side
    with pytest.raises(JBadRequest, match="outside the declared range"):
        client.score([[1, V + 7], 0])
    # one bad row among good ones: its slot carries the error (207)
    results = client.score_rows([list(sample), [[V + 1], 0],
                                 list(sample)])
    assert results[1]["error"]["code"] == "bad_request"
    for r in (results[0], results[2]):
        np.testing.assert_allclose(r["outputs"]["output"], got, rtol=1e-6)
    # drain: admission closes with the typed 429
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/admin/drain")
    assert json.loads(conn.getresponse().read())["draining"] is True
    conn.close()
    with pytest.raises(JShuttingDown):
        client.score(list(sample))


def test_cli_serve_merged_model_then_sigterm_drains(tmp_path):
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.trainer.merge_model import merge_model
    import torch
    conf = tmp_path / "conf.py"
    conf.write_text(textwrap.dedent(f"""
        from paddle_tpu_torch.data.types import (integer_value,
                                                 integer_value_sequence)
        from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
        cost, out, _ = lstm_text_classifier(vocab_size={V}, embed_dim={E},
                                            hidden={H})
        outputs = [out]
        feeding = {{"words": integer_value_sequence({V}),
                   "label": integer_value(2)}}
    """))
    from paddle_tpu_torch.trainer import cli
    ns = cli.load_config(str(conf))
    from paddle_tpu_torch.config import dsl
    graph = dsl.current_graph()
    params = Network(graph, outputs=["output"]).init_params(
        torch.Generator().manual_seed(3), device="cpu")
    model = tmp_path / "m.ptmodel"
    merge_model(str(model), graph, params, outputs=["output"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", "--config",
         str(conf), "--job", "serve", "--init_model_path", str(model),
         "--device", "cpu", "--max_batch", "4",
         "--serving_length_buckets", "8,16", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), proc.stderr.read()
        port = int(line.split()[2].rsplit(":", 1)[1])
        sample = _rows(5, 1)[0]
        got = ServingClient(port=port).score(list(sample))
        pred = ServingPredictor.from_merged(str(model), ns["feeding"],
                                            device="cpu", **BUCKETS)
        want, _ = pred.predict_rows([sample])
        np.testing.assert_allclose(got["outputs"]["output"],
                                   want["output"][0], rtol=1e-6)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
