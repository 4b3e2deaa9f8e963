"""Exact resume: the port's ``Checkpointer`` and ``SGD.train(checkpointer=
...)``, on the CPU; the twin of ``tests/test_exact_resume_matrix.py``.

A trainer killed at a step between two saves (``testing.chaos``'s
``FaultPlan``, ``mode="raise"``: the in-process stand-in for a kill) and
resumed from the newest durable generation ends with parameters,
optimizer state and step generator bitwise those of a run that was never
interrupted. The matrix is closure-checked: every resume-relevant feature
this slice ports (grad_accum, async_input, prev_batch_state, dropout) is
in a cell, and one cell composes several. The checkpointer writes in the
background.

Also: a corrupt newest generation is quarantined and the older one
restored; a background writer's error surfaces on the trainer's thread;
a JAX-written save directory resumes in the port by name (parameters and
Adam slots), continuing as the JAX run continues; the kill-and-resume
drill through the CLI (``PADDLE_TPU_CHAOS_PLAN``, ``mode="exit"``: a real
process death); ``--job time`` and ``--job checkgrad``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.dist.checkpoint import Checkpointer as JCheckpointer
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch.config import dsl
from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.dist.checkpoint import Checkpointer
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing.chaos import ChaosKilled, FaultPlan, chaos_plan
from paddle_tpu_torch.trainer import cli
from paddle_tpu_torch.trainer.checkpoint import _flatten
from paddle_tpu_torch.trainer.trainer import SGD

WIDTH, CLASSES, B, T = 8, 3, 16, 6
BATCHES, PASSES = 4, 3

# cell -> {features}; the spellings are the closure vocabulary
MATRIX = {
    "baseline": set(),
    "grad_accum": {"grad_accum"},
    "async_input": {"async_input"},
    "prev_batch_state": {"prev_batch_state"},
    "dropout": {"dropout"},
    "dropout_grad_accum_async": {"dropout", "grad_accum", "async_input"},
}
REQUIRED_FEATURES = {"grad_accum", "async_input", "prev_batch_state",
                     "dropout"}

# kill at the 7th step (pass 1, batch 2): past the pass-1 save at batch 2,
# before the next: a mid-pass resume
KILL_AT = 7
CADENCE = 2


def test_matrix_closure():
    seen = set().union(*MATRIX.values())
    missing = REQUIRED_FEATURES - seen
    assert not missing, f"resume matrix lost coverage for {missing}"
    assert any(len(f) >= 2 for f in MATRIX.values()), \
        "need at least one composed cell"


def _build(features, seed=5):
    dsl.reset()
    lbl = dsl.data(name="label", size=CLASSES)
    if "prev_batch_state" in features:
        x = dsl.data(name="x", size=WIDTH, is_sequence=True)
        proj = dsl.fc(input=x, size=4 * WIDTH, act="linear")
        h = dsl.last_seq(dsl.lstmemory(input=proj, name="lstm"))
    else:
        x = dsl.data(name="x", size=WIDTH)
        h = dsl.fc(input=x, size=WIDTH, act="tanh")
    if "dropout" in features:
        h = dsl.dropout(h, 0.25)
    out = dsl.fc(input=h, size=CLASSES, act="softmax", name="out")
    cost = dsl.classification_cost(input=out, label=lbl)
    return SGD(cost, update_equation=Adam(learning_rate=3e-3), seed=seed,
               device="cpu",
               prev_batch_state="prev_batch_state" in features)


def _reader(features):
    rng = np.random.RandomState(11)
    seq = "prev_batch_state" in features
    X = rng.randn(BATCHES * B, *((T,) if seq else ()), WIDTH).astype(
        np.float32)
    Y = rng.randint(0, CLASSES, size=BATCHES * B).astype(np.int32)
    lens = rng.randint(1, T + 1, size=BATCHES * B)
    M = (np.arange(T)[None] < lens[:, None]).astype(np.float32)

    def reader():
        for i in range(0, BATCHES * B, B):
            yield {"x": Argument(torch.from_numpy(X[i:i + B]),
                                 torch.from_numpy(M[i:i + B]) if seq
                                 else None),
                   "label": Argument(torch.from_numpy(Y[i:i + B]))}
    return reader


def _train_kwargs(features):
    kw = {}
    if "grad_accum" in features:
        kw["grad_accum_steps"] = 2
    if "async_input" in features:
        kw["async_load_data"] = True
    return kw


def _final_state(tr):
    return ({k: v.numpy() for k, v in tr.params.items()},
            _flatten(tr.opt_state), tr._rng.get_state().numpy())


def _assert_bitwise(got, want, where):
    for a, b, what in zip(got, want, ("param", "opt", "rng")):
        if what == "rng":
            np.testing.assert_array_equal(a, b, err_msg=f"rng ({where})")
            continue
        assert set(a) == set(b), what
        for k in b:
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"{what} {k} ({where})")


@pytest.mark.parametrize("cell", sorted(MATRIX), ids=sorted(MATRIX))
def test_kill_and_resume_is_bitwise_identical(cell, tmp_path):
    features = MATRIX[cell]
    kw = _train_kwargs(features)
    reader = _reader(features)
    clean = _build(features)
    clean.train(reader, num_passes=PASSES, **kw)
    want = _final_state(clean)
    plan = FaultPlan(faults=[
        {"type": "kill", "site": "step_done", "at": KILL_AT,
         "mode": "raise"}])
    ck_a = Checkpointer(str(tmp_path), saving_period=1,
                        saving_period_by_batches=CADENCE, background=True)
    run_a = _build(features)
    with chaos_plan(plan):
        with pytest.raises(ChaosKilled):
            run_a.train(reader, num_passes=PASSES, checkpointer=ck_a, **kw)
    assert plan.hits("step_done") == KILL_AT
    ck_a.flush()
    run_b = _build(features)
    seen = []
    run_b.train(reader, num_passes=PASSES,
                checkpointer=Checkpointer(
                    str(tmp_path), saving_period=1,
                    saving_period_by_batches=CADENCE, background=True),
                event_handler=lambda e: seen.append(
                    (type(e).__name__, getattr(e, "pass_id", None),
                     getattr(e, "batch_id", None))), **kw)
    first = next(t for t in seen if t[0] == "BeginIteration")
    assert first[1:] == (1, CADENCE), seen[:4]
    _assert_bitwise(_final_state(run_b), want, cell)


def test_corrupt_newest_generation_is_quarantined(tmp_path):
    """The newest generation bit-flipped after it became durable: restore
    moves it aside (``.bad``) and returns the generation before it."""
    features = set()
    # saves: batch 2, batch 4, the pass end (the newest): corrupt the last
    plan = FaultPlan(faults=[{"type": "corrupt", "site": "checkpoint",
                              "at": 3, "mode": "bitflip"}])
    tr = _build(features)
    with chaos_plan(plan):
        tr.train(_reader(features), num_passes=1, checkpointer=Checkpointer(
            str(tmp_path), saving_period=1, saving_period_by_batches=2))
    newest = "checkpoint-p00000-b00000000.npz"
    assert newest in os.listdir(tmp_path)
    restored = Checkpointer(str(tmp_path)).restore()
    assert restored is not None
    assert (restored[2]["pass_id"], restored[2]["batch_id"]) == (0, 4)
    assert os.path.exists(tmp_path / (newest + ".bad"))
    assert not os.path.exists(tmp_path / newest)
    np.testing.assert_array_equal(
        Checkpointer(str(tmp_path)).restore()[0]["_out.w0"],
        restored[0]["_out.w0"])


def test_background_writer_error_surfaces(tmp_path, monkeypatch):
    """A write that fails on the writer thread raises on the trainer's
    thread at the next save or flush."""
    from paddle_tpu_torch.dist import checkpoint as dck

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(dck, "write_snapshot", broken)
    ck = Checkpointer(str(tmp_path), background=True)
    ck.save({"w": torch.ones(2)}, None, pass_id=0)
    with pytest.raises(RuntimeError, match="background checkpoint writer"):
        ck.flush()


def _jax_mlp():
    jdsl.reset()
    x = jdsl.data(name="x", size=WIDTH)
    lbl = jdsl.data(name="label", size=CLASSES)
    h = jdsl.fc(input=x, size=WIDTH, act="tanh")
    out = jdsl.fc(input=h, size=CLASSES, act="softmax", name="out")
    return jdsl.classification_cost(input=out, label=lbl)


def test_jax_written_checkpoint_resumes_by_name(tmp_path):
    """A JAX trainer saves two passes into a directory; the port resumes a
    copy of it (parameters and Adam slots by name, the counters) and trains
    the third pass as a JAX trainer resumed from the directory does."""
    import shutil

    from paddle_tpu.trainer.checkpoint import _flatten as j_flatten
    reader = _reader(set())

    def jreader():
        for f in reader():
            yield {k: JArgument(jnp.asarray(a.value.numpy()))
                   for k, a in f.items()}

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JSGD(cost=_jax_mlp(), update_equation=JAdam(learning_rate=3e-3),
         seed=5).train(jreader, num_passes=2,
                       checkpointer=JCheckpointer(jdir))
    shutil.copytree(jdir, tdir)
    jres = JSGD(cost=_jax_mlp(), update_equation=JAdam(learning_rate=3e-3),
                seed=9)
    jres.train(jreader, num_passes=3, checkpointer=JCheckpointer(jdir))
    port = _build(set(), seed=9)
    passes = []
    port.train(reader, num_passes=3, checkpointer=Checkpointer(tdir),
               event_handler=lambda e: passes.append(e.pass_id)
               if type(e).__name__ == "BeginPass" else None)
    assert passes == [2]
    assert sorted(port.params) == sorted(jres.params)
    for k, v in jres.params.items():
        np.testing.assert_allclose(port.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    t_opt, j_opt = _flatten(port.opt_state), j_flatten(jres.opt_state)
    assert set(t_opt) == set(j_opt)
    for k, v in j_opt.items():
        np.testing.assert_allclose(t_opt[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


_CLI_CONF = textwrap.dedent("""
    import numpy as np
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data.types import dense_vector, integer_value
    from paddle_tpu_torch.optim import Adam

    x = dsl.data(name="x", size=8)
    lab = dsl.data(name="label", size=4)
    hid = dsl.fc(input=x, size=16, act="relu")
    hid = dsl.dropout(hid, 0.5)
    out = dsl.fc(input=hid, size=4, act="softmax")
    cost = dsl.classification_cost(input=out, label=lab)
    outputs = [out]
    optimizer = Adam(learning_rate=1e-2)
    feeding = {"x": dense_vector(8), "label": integer_value(4)}

    _rng = np.random.RandomState(0)
    _X = _rng.randn(128, 8).astype(np.float32)
    _Y = np.argmax(_X[:, :4], axis=1)

    def train_reader():
        for i in range(0, 128, 32):
            yield [(_X[j], int(_Y[j])) for j in range(i, i + 32)]
""")


def _cli_train(conf, save_dir, plan=None):
    env = dict(os.environ)
    env.pop("PADDLE_TPU_CHAOS_PLAN", None)
    if plan is not None:
        env["PADDLE_TPU_CHAOS_PLAN"] = plan.to_json()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", "--config",
         conf, "--job", "train", "--device", "cpu", "--num_passes", "2",
         "--save_dir", save_dir, "--saving_period_by_batches", "2",
         "--background_save", "--log_period", "0"],
        capture_output=True, text=True, timeout=300, env=env)


def _newest(save_dir):
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_checkpoint)
    return load_checkpoint(latest_checkpoint(save_dir))


def test_cli_kill_and_resume_drill(tmp_path):
    """``--job train`` with dropout, a save every 2 batches in the
    background: killed by ``os._exit`` at step 3 (between the saves at
    batches 2 and 4) and run again, its final checkpoint is bitwise the
    uninterrupted run's: parameters, Adam slots, counters, generator."""
    conf = tmp_path / "conf.py"
    conf.write_text(_CLI_CONF)
    clean = _cli_train(str(conf), str(tmp_path / "clean"))
    assert clean.returncode == 0, clean.stderr[-2000:]
    plan = FaultPlan(faults=[{"type": "kill", "site": "step_done", "at": 3,
                              "mode": "exit"}])
    killed = _cli_train(str(conf), str(tmp_path / "kill"), plan)
    assert killed.returncode == 17, killed.stderr[-2000:]
    assert "Pass 0" not in killed.stdout
    resumed = _cli_train(str(conf), str(tmp_path / "kill"))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "Pass 0" in resumed.stdout
    want, got = _newest(str(tmp_path / "clean")), _newest(
        str(tmp_path / "kill"))
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert "torch_rng" in want[2]


def test_cli_time_and_checkgrad(tmp_path, capsys):
    conf = tmp_path / "conf.py"
    conf.write_text(_CLI_CONF.replace("hid = dsl.dropout(hid, 0.5)\n", ""))
    assert cli.main(["--config", str(conf), "--job", "time", "--device",
                     "cpu", "--time_batches", "3", "--time_warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "avg_batch_time=" in out
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("time_summary "))[13:])
    assert len(summary["step_ms"]) == 3
    assert cli.main(["--config", str(conf), "--job", "checkgrad",
                     "--device", "cpu"]) == 0
    assert "checkgrad PASSED" in capsys.readouterr().out
