"""The port's training slice against the JAX package, on the CPU:
``lstm_text_classifier`` at a tiny width (vocab 50, embed 6, hidden 8,
2 LSTM layers, 2 classes), the same parameters carried across by name and
the same batches (ragged lengths, some batches row-padded by the feeder's
batch buckets, so the row mask and the live batch size are exercised).

- the loss and every parameter gradient of one batch, against
  ``jax.value_and_grad`` of the JAX trainer's cost (its CPU path, the
  ``lax.scan`` LSTM; ``test_torch_lstm_grad.py`` holds the LSTM against
  the Pallas kernels' custom VJP), and the eval forward;
- 5-step trajectories with Adam and with Momentum (the lazy sparse-row
  path on the embedding table): the cost of every step, the final
  parameters and ``test()``'s cost and classification_error;
- checkpoints both ways: trained in JAX, saved, resumed in the port,
  matching the JAX-only run; trained in the port, saved into a save
  directory, restored by the JAX ``Checkpointer``, matching again;
- the CLI round trip: ``--job train`` -> ``--job merge`` -> ``--job test``
  -> ``--job serve --device cpu`` answering one score, and ``--device
  cuda`` refusing to start without a card.

Tolerances: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 (ROADMAP's;
f32 sums in other orders); trajectories and checkpoints rtol/atol 1e-4 on
costs and parameters (the gradient differences, compounded over up to 5
updates; Adam's first steps are sign-like, so an element whose gradient is
roundoff could flip, but at this width none does).
"""

import http.client
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.dist.checkpoint import Checkpointer as JCheckpointer
from paddle_tpu.models.lstm_text import lstm_text_classifier as j_classifier
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.optim import Momentum as JMomentum
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer import events as jev
from paddle_tpu.trainer.checkpoint import load_params as j_load_params
from paddle_tpu.trainer.checkpoint import save_params as j_save_params
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.models.lstm_text import \
    lstm_text_classifier as t_classifier
from paddle_tpu_torch.optim import Adam as TAdam
from paddle_tpu_torch.optim import Momentum as TMomentum
from paddle_tpu_torch.trainer import cli
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                 load_params, save_generation)
from paddle_tpu_torch.trainer.checkpoint import save_params as t_save_params
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

V, E, H, T = 50, 6, 8, 12
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
BUCKETS = [4, 8]


def _batches(seed, sizes=(6, 6, 5, 6, 3)):
    """Batches of (ids, label) samples; labels follow a rule on the ids."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        batch = []
        for _ in range(n):
            ids = rng.integers(0, V, size=int(rng.integers(1, T + 1)))
            batch.append((ids.tolist(), int(ids.mean() > V / 2)))
        out.append(batch)
    return out


def _feeding(types):
    return {"words": types.integer_value_sequence(V),
            "label": types.integer_value(2)}


def _jfeeder():
    return JFeeder(_feeding(jtypes), pad_multiple=T, batch_buckets=BUCKETS)


def _tfeeder():
    return TFeeder(_feeding(ttypes), pad_multiple=T, batch_buckets=BUCKETS,
                   device="cpu")


@pytest.fixture(scope="module")
def model():
    """(JAX cost, port cost, shared numpy parameters): every parameter
    random, the zero-initialised biases and peepholes included."""
    jdsl.reset()
    jcost, _, _ = j_classifier(vocab_size=V, embed_dim=E, hidden=H)
    tdsl.reset()
    tcost, _, _ = t_classifier(vocab_size=V, embed_dim=E, hidden=H)
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


def test_loss_and_every_gradient_match_jax(model):
    jtr = _jsgd(model, JAdam())
    ttr = _tsgd(model, TAdam())
    batch = _batches(5, sizes=(7,))[0]
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
    # the eval forward of the same parameters
    jout = jtr.forward(jfeed, ["output"])["output"].value
    tout = ttr.forward(tfeed, ["output"])["output"].value
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def _run_jax(trainer, batches, num_passes=1):
    costs = []
    trainer.train(lambda: iter(batches), feeder=_jfeeder(),
                  num_passes=num_passes,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, jev.EndIteration) else None)
    return costs


def _run_port(trainer, batches, num_passes=1):
    costs = []
    trainer.train(lambda: iter(batches), feeder=_tfeeder(),
                  num_passes=num_passes,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, tev.EndIteration) else None)
    return costs


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_five_step_trajectory_matches_jax(model, name):
    if name == "adam":
        jopt, topt = JAdam(learning_rate=2e-3), TAdam(learning_rate=2e-3)
    else:
        jopt = JMomentum(learning_rate=0.05, momentum=0.9)
        topt = TMomentum(learning_rate=0.05, momentum=0.9)
    batches = _batches(9)
    jtr, ttr = _jsgd(model, jopt), _tsgd(model, topt)
    jcosts = _run_jax(jtr, batches)
    tcosts = _run_port(ttr, batches)
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    _assert_params_close({k: v.numpy() for k, v in ttr.params.items()},
                         jtr.params, RUN_TOL)
    if name == "momentum":
        # the embedding table took the lazy sparse-row path
        assert "t_rows" in ttr.opt_state["slots"]["_embed.w0"]
    test_batches = _batches(21, sizes=(8, 5))
    jres = jtr.test(lambda: iter(test_batches), feeder=_jfeeder())
    tres = ttr.test(lambda: iter(test_batches), feeder=_tfeeder())
    np.testing.assert_allclose(tres.cost, jres.cost, **RUN_TOL)
    assert tres.evaluator == pytest.approx(jres.evaluator, abs=1e-6)


def test_checkpoints_cross_between_packages(model, tmp_path):
    """JAX -> port: the JAX run saves after 2 steps and trains 2 more; the
    port resumes the file and trains the same 2. Port -> JAX: the port
    trains the first 2 steps and saves a generation into a save dir,
    which the JAX Checkpointer restores and trains on. All three end at
    the same parameters and optimizer state."""
    first, second = _batches(13, sizes=(6, 5)), _batches(14, sizes=(6, 3))
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
    # a single file, read by the JAX package's loader
    t_save_params(str(tmp_path / "port.npz"), ttr.params, ttr.opt_state)
    jp, jo = j_load_params(str(tmp_path / "port.npz"))
    _assert_params_close(jp, {k: v.numpy() for k, v in ttr.params.items()},
                         dict(rtol=0, atol=0))
    assert int(jo["t"]) == 2 and jo["t"].dtype == np.int32
    save_dir = tmp_path / "port_ckpt"
    save_generation(str(save_dir), 0, ttr.params, ttr.opt_state)
    params, opt_flat, meta = JCheckpointer(str(save_dir)).restore()
    assert meta["pass_id"] == 0 and meta["end_of_pass"]
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
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    cost, out, _ = lstm_text_classifier(vocab_size={V}, embed_dim={E},
                                        hidden={H})
    outputs = [out]
    optimizer = Adam(learning_rate=5e-3)
    feeding = {{"words": integer_value_sequence({V}),
               "label": integer_value(2)}}

    def train_reader():
        rng = np.random.default_rng(0)
        for _ in range(3):
            batch = []
            for _ in range(4):
                ids = rng.integers(0, {V}, size=int(rng.integers(1, 13)))
                batch.append((ids.tolist(), int(ids.mean() > {V} / 2)))
            yield batch

    test_reader = train_reader
""")


def test_cli_train_merge_test_serve_round_trip(tmp_path, capsys):
    """train, merge and test through ``cli.main`` in this process; serve as
    its own process, as a deployment runs it."""
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    save_dir, model = tmp_path / "ckpt", tmp_path / "m.ptmodel"

    def _cli(*args):
        assert cli.main(list(args)) == 0
        return capsys.readouterr().out

    out = _cli("--config", str(conf), "--job", "train", "--device", "cpu",
               "--num_passes", "2", "--save_dir", str(save_dir),
               "--test_period", "1")
    passes = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    assert [p.split(":")[0] for p in passes] == ["Pass 0", "Pass 1"]
    assert all("cost=" in p and "classification_error=" in p for p in passes)
    summary = json.loads(next(ln for ln in out.splitlines() if
                              ln.startswith("train_summary "))[14:])
    assert summary["steps"] == 6 and summary["device"] == "cpu"
    # CPU tensors take the plain versions: no kernel launched
    assert all(c["launches"] == 0 for c in summary["kernels"].values())
    assert sorted(p.name for p in save_dir.glob("checkpoint-*.npz")) == [
        "checkpoint-p00000-b00000000.npz", "checkpoint-p00001-b00000000.npz"]
    out = _cli("--config", str(conf), "--job", "merge", "--device", "cpu",
               "--save_dir", str(save_dir), "--model_path", str(model))
    assert "merged model written" in out
    out = _cli("--config", str(conf), "--job", "test", "--device", "cpu",
               "--init_model_path",
               str(save_dir / "checkpoint-p00001-b00000000.npz"))
    assert out.startswith("Test: cost=")

    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", "--config",
         str(conf), "--job", "serve", "--init_model_path", str(model),
         "--device", "cpu", "--max_batch", "2",
         "--serving_length_buckets", "16", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), proc.stderr.read()
        port = int(line.split()[2].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/score",
                     body=json.dumps({"sample": [[1, 2, 3], 0]}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        assert abs(sum(body["outputs"]["output"]) - 1.0) < 1e-5
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()

    # the merged file holds the trained parameters of the last pass
    from paddle_tpu_torch.trainer.merge_model import load_merged_ex
    _, merged, _, _ = load_merged_ex(str(model))
    saved, _ = load_params(str(save_dir / "checkpoint-p00001-b00000000.npz"))
    _assert_params_close(merged, saved, dict(rtol=0, atol=0))


def test_cli_train_on_cuda_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would train")
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--config", str(conf), "--job", "train"])
    assert exc.value.code not in (0, None)


def test_save_dir_keeps_the_newest_three_generations(tmp_path):
    """End-of-pass saves keep the newest three generations (the JAX
    Checkpointer's ``keep``), and the newest is the one restored."""
    params = {"w": torch.ones(2, 3)}
    for pass_id in range(5):
        save_generation(str(tmp_path), pass_id,
                        {"w": params["w"] * pass_id}, {"t": pass_id})
    assert sorted(p.name for p in tmp_path.glob("checkpoint-*")) == [
        f"checkpoint-p{i:05d}-b00000000.npz{s}"
        for i in (2, 3, 4) for s in ("", ".meta")]
    path = latest_checkpoint(str(tmp_path))
    assert path.endswith("checkpoint-p00004-b00000000.npz")
    restored, opt_flat = load_params(path)
    assert restored["w"].tolist() == [[4.0] * 3] * 2
    assert int(opt_flat["t"]) == 4


def test_feeder_pads_to_pad_multiple_with_int_labels():
    """What training needs of the feeder: labels as an integer tensor on
    the feeder's device, sequences padded to ``pad_multiple`` (T=100 for
    lengths up to 100, as ``bench.py`` feeds the benchmark)."""
    feeder = TFeeder(_feeding(ttypes), pad_multiple=100, device="cpu")
    feed = feeder([([1, 2, 3], 1), (list(range(100)), 0)])
    assert feed["words"].value.shape == (2, 100)
    assert feed["label"].value.dtype == torch.int32
    assert feed["label"].value.tolist() == [1, 0]
    assert feed["words"].mask.sum(dim=1).tolist() == [3.0, 100.0]
