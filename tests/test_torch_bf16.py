"""Mixed-precision training (``compute_dtype="bfloat16"``) in the port's
trainer, on the CPU, against the JAX package's.

- the mask invariant (``utils/masks.py``) and ``_cast_compute``: masks and
  the row mask stay f32 with exact counts, a bf16 mask raises
  ``MaskDtypeError``, integer ids keep their dtype (ports of the JAX
  package's ``test_smoke.py``, ``test_prefetch.py``, ``test_analysis.py``
  and ``test_gan_vae.py`` bf16 tests);
- the dtype probe: every layer's output dtype in the classifier and the
  CTC acoustic model equals JAX's (bf16 up to the first recurrent layer,
  whose f32 ``ys`` promote everything after it);
- whole-model parity: the loss and every parameter gradient of the
  classifier and of the acoustic model match JAX's at
  ``compute_dtype="bfloat16"``, at a first step and again after one Adam
  step; gradients are f32 on the f32 masters, the optimizer slots f32;
- the CLI: ``--compute_dtype bfloat16 --device cpu`` trains, tests and
  times a tiny classifier, and its checkpoint loads into JAX's ``SGD``.

JAX runs its CPU default, the ``lax.scan`` recurrences (its Pallas kernels
cannot run in bf16 with f32 masks). Tolerances: the loss 1e-2 relative;
each gradient tensor |port - JAX| <= 2e-2 * max|JAX| + 1e-3, and
|port - f32| <= 2 |JAX - f32| + 1e-3 * max|f32| with f32 the JAX
package's float32 gradient at the same parameters (bf16 keeps 8 bits,
and the port sums its chains and ``dW`` in f32 where JAX rounds every
operation). The first bound keeps its absolute 1e-3: the classifier's
``lstm0_proj`` bias gradient (largest entry 2.2e-3) parts from JAX's by
4.1 % of it (9.1e-5), a batch sum that cancels; every other tensor
within 2.2 %.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.models.lstm_text import lstm_text_classifier as j_classifier
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer.checkpoint import load_params as j_load_params
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import ROW_MASK_KEY
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.models.lstm_text import \
    lstm_text_classifier as t_classifier
from paddle_tpu_torch.optim import Adam, Momentum
from paddle_tpu_torch.trainer import cli
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.checkpoint import latest_checkpoint
from paddle_tpu_torch.trainer.trainer import SGD
from paddle_tpu_torch.utils.masks import (MaskDtypeError,
                                          assert_feed_masks_f32,
                                          assert_mask_f32)
from paddle_tpu_torch.utils.precision import matmul, result_type

BF = torch.bfloat16


# ----------------------------------------------------- the mask invariant
def test_assert_mask_f32_rejects_only_sub_f32_floats():
    ok = torch.ones(2, 3)
    assert assert_mask_f32(ok) is ok
    assert assert_mask_f32(None) is None
    # "never below f32": float64, int and bool masks keep full counts
    assert_mask_f32(np.ones((2, 3)))
    assert_mask_f32(torch.ones(2, 3, dtype=torch.float64))
    assert_mask_f32(np.ones((2, 3), np.int32))
    assert_mask_f32(torch.ones(2, 3, dtype=torch.bool))
    with pytest.raises(MaskDtypeError):
        assert_mask_f32(torch.ones(2, 3, dtype=BF))
    with pytest.raises(MaskDtypeError):
        assert_mask_f32(np.ones((2, 3), np.float16))
    feed = {"x": Argument(value=torch.ones(2, 3), mask=ok)}
    assert assert_feed_masks_f32(feed) is feed
    bad = {"x": Argument(value=torch.ones(2, 3),
                         mask=torch.ones(2, 3, dtype=BF))}
    with pytest.raises(MaskDtypeError, match="x"):
        assert_feed_masks_f32(bad)
    nested = {"y": Argument(value=torch.ones(2), state={"inner": bad["x"]})}
    with pytest.raises(MaskDtypeError, match="inner"):
        assert_feed_masks_f32(nested)


def test_serving_feed_checks_its_masks():
    """The predictor's feed (``ServingPredictor._feed``, which scoring,
    encoding and generation take) refuses a bf16 mask, as the JAX
    predictor's ``_convert`` does, and passes an f32 feed through."""
    from types import SimpleNamespace

    from paddle_tpu_torch.serving.predictor import ServingPredictor
    good = {"x": Argument(value=torch.ones(2, 3), mask=torch.ones(2, 3))}
    bad = {"x": Argument(value=torch.ones(2, 3),
                         mask=torch.ones(2, 3, dtype=BF))}
    for feed in (good, bad):
        stub = SimpleNamespace(feeder=lambda rows, feed=feed: feed)
        if feed is good:
            assert ServingPredictor._feed(stub, [()]) is good
            continue
        with pytest.raises(MaskDtypeError, match="serving feed"):
            ServingPredictor._feed(stub, [()])


def _pooled_classifier(dsl, seq_input=True):
    x = dsl.data(name="x", size=4, is_sequence=seq_input)
    lab = dsl.data(name="label", size=2)
    pooled = dsl.pooling(input=dsl.fc(input=x, size=8), pooling_type="avg")
    out = dsl.fc(input=pooled, size=2, act="softmax")
    return dsl.classification_cost(input=out, label=lab)


def test_cast_keeps_masks_f32_with_exact_counts():
    """600 live tokens, past bf16's integer ceiling of 256: the values
    cast, the mask stays f32 and sums to 600 exactly; integer ids keep
    their dtype (``test_smoke.py``'s bf16 test)."""
    tdsl.reset()
    tr = SGD(cost=_pooled_classifier(tdsl),
             update_equation=Momentum(learning_rate=0.1),
             compute_dtype="bfloat16", device="cpu")
    feed = {"x": Argument(value=torch.ones(2, 300, 4),
                          mask=torch.ones(2, 300)),
            "label": Argument(value=torch.zeros(2, dtype=torch.int32))}
    cast = tr._cast_compute(feed)
    assert cast["x"].value.dtype == BF
    assert cast["x"].mask.dtype == torch.float32
    assert float(cast["x"].mask.sum()) == 600.0
    assert cast["label"].value.dtype == torch.int32
    # parameters: every f32 leaf cast, the masters untouched
    cp = tr._cast_compute(tr.params)
    assert all(v.dtype == BF for v in cp.values())
    assert all(v.dtype == torch.float32 for v in tr.params.values())


def test_cast_compute_rejects_a_bf16_mask():
    """A sub-f32 mask entering ``_cast_compute`` raises at once, not after
    a saturated sum (``test_analysis.py``)."""
    tdsl.reset()
    x = tdsl.data(name="x", size=4, is_sequence=True)
    lab = tdsl.data(name="label", size=2)
    pooled = tdsl.pooling(input=x, pooling_type="avg", name="pool")
    out = tdsl.fc(input=pooled, size=2, act="softmax", name="out")
    cost = tdsl.classification_cost(input=out, label=lab)
    tr = SGD(cost=cost, update_equation=Adam(learning_rate=1e-3),
             compute_dtype="bfloat16", device="cpu")
    feed = {"x": Argument(value=torch.ones(2, 3, 4),
                          mask=torch.ones(2, 3, dtype=BF)),
            "label": Argument(value=torch.zeros(2, dtype=torch.int32))}
    with pytest.raises(MaskDtypeError):
        tr._cast_compute(feed)
    with pytest.raises(MaskDtypeError):
        tr.train_step(feed)


def test_row_mask_stays_f32_and_a_padded_bf16_step_trains():
    """The row-validity mask is exempt by key; a bf16 step on a batch the
    feeder padded to 8 rows counts its 5 live rows (``test_prefetch.py``)."""
    tdsl.reset()
    x = tdsl.data("x", size=4)
    y = tdsl.data("y", size=3)
    h = tdsl.fc(input=x, size=3, act="softmax")
    cost = tdsl.classification_cost(input=h, label=y)
    t = SGD(cost=cost, update_equation=Momentum(learning_rate=0.1),
            compute_dtype="bfloat16", device="cpu")
    feeder = TFeeder({"x": ttypes.dense_vector(4),
                      "y": ttypes.integer_value(3)}, batch_buckets=[8],
                     device="cpu")
    feed = feeder([(np.ones(4, np.float32), 1)] * 5)
    cast = t._cast_compute(feed)
    assert cast[ROW_MASK_KEY].value.dtype == torch.float32
    assert cast["x"].value.dtype == BF
    m = t.train_step(feed)
    assert np.isfinite(float(m["cost"]))
    assert float(m["classification_error"][1]) == 5.0
    assert all(v.dtype == torch.float32 for v in t.params.values())


def test_bf16_training_converges_params_and_slots_stay_f32():
    """``test_gan_vae.py``: an MLP trains at bf16 compute, its master
    parameters and Adam's slots stay f32, the gradients come back f32."""
    tdsl.reset()
    x = tdsl.data(name="x", size=8)
    lbl = tdsl.data(name="label", size=4)
    out = tdsl.fc(input=tdsl.fc(input=x, size=32, act="relu"), size=4,
                  act="softmax")
    cost = tdsl.classification_cost(input=out, label=lbl)
    tr = SGD(cost=cost, update_equation=Adam(learning_rate=1e-2),
             compute_dtype="bfloat16", device="cpu")
    rng = np.random.RandomState(0)
    W = rng.randn(8, 4)

    def reader():
        for _ in range(8):
            xv = rng.randn(32, 8).astype(np.float32)
            yv = np.argmax(xv @ W, axis=1).astype(np.int32)
            yield {"x": Argument(value=torch.tensor(xv)),
                   "label": Argument(value=torch.tensor(yv))}

    cs = []
    tr.train(reader, num_passes=4,
             event_handler=lambda e: cs.append(e.cost)
             if isinstance(e, tev.EndIteration) else None)
    assert cs[-1] < cs[0] * 0.6
    for v in tr.params.values():
        assert v.dtype == torch.float32
    for slots in tr.opt_state["slots"].values():
        for s in slots.values():
            assert s.dtype == torch.float32
    xv = rng.randn(16, 8).astype(np.float32)
    feed = {"x": Argument(value=torch.tensor(xv)),
            "label": Argument(value=torch.zeros(16, dtype=torch.int32))}
    _, _, grads, _ = tr.loss_and_grads(feed)
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_bf16_batchnorm_statistics_stay_f32():
    tdsl.reset()
    x = tdsl.data(name="x", size=6)
    lbl = tdsl.data(name="label", size=2)
    h = tdsl.batch_norm(tdsl.fc(input=x, size=6, act="linear"), act="relu")
    out = tdsl.fc(input=h, size=2, act="softmax")
    cost = tdsl.classification_cost(input=out, label=lbl)
    tr = SGD(cost=cost, update_equation=Adam(learning_rate=1e-2),
             compute_dtype="bfloat16", device="cpu")
    rng = np.random.RandomState(1)

    def reader():
        xv = rng.randn(16, 6).astype(np.float32)
        yv = (xv[:, 0] > 0).astype(np.int32)
        yield {"x": Argument(value=torch.tensor(xv)),
               "label": Argument(value=torch.tensor(yv))}

    before = {n: v.clone() for n, v in tr.params.items()}
    tr.train(reader, num_passes=2)
    for name, v in tr.params.items():
        assert v.dtype == torch.float32, name
    moved = [n for n in tr.params if tr.meta[n].is_static
             and not torch.equal(tr.params[n], before[n])]
    assert moved  # the moving statistics were written, in f32


def test_promotion_helper_follows_jnp_result_type():
    a = torch.randn(3, 4)
    b = torch.randn(4, 5).to(BF)
    assert result_type(a, b) == torch.float32
    assert str(jnp.result_type(jnp.float32, jnp.bfloat16)) == "float32"
    out = matmul(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, a @ b.float())
    assert matmul(a.to(BF), b).dtype == BF
    with pytest.raises(RuntimeError):
        a @ b  # torch refuses the mixed product the helper promotes


# --------------------------------------------------------- the two models
V, E, HID, TMAX = 50, 6, 8, 12
F, G, NL, C = 10, 8, 2, 6  # acoustic: features, GRU width, layers, outputs
CT = 12


def _classifier(dsl):
    cost, _, _ = (j_classifier if dsl is jdsl else t_classifier)(
        vocab_size=V, embed_dim=E, hidden=HID)
    return cost


def _acoustic(dsl):
    """chip_smoke.py's ``_DS2_MODEL`` topology at a small width."""
    audio = dsl.data(name="audio", size=F, is_sequence=True)
    text = dsl.data(name="text", size=C - 1, is_sequence=True)
    x = audio
    for _ in range(NL):
        fwd = dsl.grumemory(input=dsl.fc(input=x, size=3 * G, act="linear"))
        bwd = dsl.grumemory(input=dsl.fc(input=x, size=3 * G, act="linear"),
                            reverse=True)
        x = dsl.concat([fwd, bwd])
    scores = dsl.fc(input=x, size=C, act="linear")
    cost = dsl.warp_ctc_layer(input=scores, label=text, size=C,
                              blank=C - 1, norm_by_times=True)
    dsl.evaluator("ctc_edit_distance", input=scores, label=text)
    return cost


def _classifier_batch(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, size=int(rng.integers(1, TMAX + 1)))
        out.append((ids.tolist(), int(ids.mean() > V / 2)))
    return out


def _acoustic_batch(seed, n=4):
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(99).normal(size=(C, F))
    out = []
    for _ in range(n):
        t = int(rng.integers(5, CT + 1))
        lab = rng.integers(0, C - 1, size=int(rng.integers(1, t // 3 + 1)))
        seq = np.repeat(np.append(lab, C - 1), -(-t // (len(lab) + 1)))[:t]
        frames = protos[seq] + 0.3 * rng.normal(size=(t, F))
        out.append((frames.astype(np.float32).tolist(), lab.tolist()))
    return out


MODELS = {
    "classifier": dict(
        build=_classifier, batch=_classifier_batch, lr=2e-3,
        feeding=lambda ty: {"words": ty.integer_value_sequence(V),
                            "label": ty.integer_value(2)},
        pad=TMAX, buckets=[8],
        # JAX's per-layer dtypes (the dtype probe's classifier rows)
        bf16=("embed", "lstm0_proj")),
    "acoustic": dict(
        build=_acoustic, batch=_acoustic_batch, lr=2e-4,
        feeding=lambda ty: {"audio": ty.dense_vector_sequence(F),
                            "text": ty.integer_value_sequence(C - 1)},
        pad=CT, buckets=None,
        bf16=("audio", "__fc_layer_0__", "__fc_layer_1__")),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    spec = MODELS[request.param]
    jdsl.reset()
    jcost = spec["build"](jdsl)
    tdsl.reset()
    tcost = spec["build"](tdsl)
    rng = np.random.default_rng(0)
    specs = JNetwork(jcost.graph, outputs=[jcost.name]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
              for k, s in specs.items()}
    return request.param, spec, jcost, tcost, params


def _feeders(spec):
    kw = dict(pad_multiple=spec["pad"])
    if spec["buckets"]:
        kw["batch_buckets"] = spec["buckets"]
    return (JFeeder(spec["feeding"](jtypes), **kw),
            TFeeder(spec["feeding"](ttypes), device="cpu", **kw))


def _trainers(model, compute_dtype="bfloat16"):
    _, spec, jcost, tcost, params = model
    jtr = JSGD(cost=jcost, update_equation=JAdam(learning_rate=spec["lr"]),
               parameters={k: jnp.asarray(v) for k, v in params.items()},
               compute_dtype=compute_dtype)
    ttr = SGD(cost=tcost, update_equation=Adam(learning_rate=spec["lr"]),
              parameters=params_from_numpy(params, device="cpu"),
              device="cpu", compute_dtype=compute_dtype)
    return jtr, ttr


def test_layer_dtypes_match_jax(model):
    """The dtype probe: each layer's output dtype in the port equals
    JAX's under bf16 compute: bf16 up to the first recurrent layer, f32
    from its output on (its ``h_new * mask`` is promoted by the f32 mask,
    and every later product promotes f32 activations with bf16 weights);
    the first recurrent layers' final states stay bf16."""
    name, spec, _, _, _ = model
    jtr, ttr = _trainers(model)
    jf, tf = _feeders(spec)
    batch = spec["batch"](1)
    jfeed, tfeed = jf(batch), tf(batch)
    jout = jtr.network.apply(jtr._cast_compute(jtr.params),
                             jtr._cast_compute(jfeed), train=False)
    with torch.no_grad():
        tout = ttr.network.apply(ttr._cast_compute(ttr.params),
                                 ttr._cast_compute(tfeed), train=False)
    assert list(tout) == list(jout)
    for n in jout:
        jd = str(jout[n].value.dtype)
        td = str(tout[n].value.dtype).replace("torch.", "")
        assert td == jd, (n, td, jd)
        if jout[n].mask is not None:
            assert tout[n].mask.dtype == torch.float32, n
        jst = jout[n].state
        if isinstance(jst, tuple) or hasattr(jst, "dtype"):
            jst = jst if isinstance(jst, tuple) else (jst,)
            tst = tout[n].state
            tst = tst if isinstance(tst, tuple) else (tst,)
            assert [str(s.dtype).replace("torch.", "") for s in tst] == [
                str(s.dtype) for s in jst], n
    bf16 = {n for n in jout if str(jout[n].value.dtype) == "bfloat16"}
    assert bf16 == set(spec["bf16"])


def _grad_close(tg, jg, fg):
    for k in jg:
        port = tg[k].numpy()
        ref, f32 = np.asarray(jg[k]), np.asarray(fg[k])
        assert tg[k].dtype == torch.float32, k
        big = float(np.abs(ref).max())
        err = float(np.abs(port - ref).max())
        assert err <= 2e-2 * big + 1e-3, (k, err, big)
        mine = float(np.abs(port - f32).max())
        own = float(np.abs(ref - f32).max())
        assert mine <= 2 * own + 1e-3 * float(np.abs(f32).max()), (
            k, mine, own)


def _jax_loss_and_grads(jtr, jfeed):
    def jloss(p):
        outs = jtr.network.apply(jtr._cast_compute(p),
                                 jtr._cast_compute(jfeed), train=True)
        return jtr._total_cost(outs, jtr._row_mask(jfeed))

    return jax.value_and_grad(jloss)(jtr.params)


def test_loss_and_every_gradient_match_jax_over_two_steps(model):
    """The loss and every parameter gradient against JAX's at bf16 compute
    (and against JAX's f32 gradients at the same parameters), on a first
    batch; then one Adam step on each side and the same again on a second
    batch from the stepped parameters."""
    name, spec, jcost, _, params = model
    jtr, ttr = _trainers(model)
    jf32 = JSGD(cost=jcost, update_equation=JAdam(learning_rate=spec["lr"]),
                parameters={k: jnp.asarray(v) for k, v in params.items()})
    jf, tf = _feeders(spec)
    b1, b2 = spec["batch"](2), spec["batch"](3)
    for step, batch in enumerate((b1, b2)):
        jfeed, tfeed = jf(batch), tf(batch)
        jl, jg = _jax_loss_and_grads(jtr, jfeed)
        jf32.params = jtr.params
        fl, fg = jax.value_and_grad(lambda p: jf32._total_cost(
            jf32.network.apply(p, jfeed, train=True),
            jf32._row_mask(jfeed)))(jtr.params)
        _, tl, tg, _ = ttr.loss_and_grads(tfeed)
        assert float(tl) == pytest.approx(float(jl), rel=1e-2), step
        assert sorted(tg) == sorted(jg)
        _grad_close(tg, jg, fg)
        if step == 0:
            jtr.params, jtr.opt_state, _ = jtr._train_step(
                jtr.params, jtr.opt_state, jfeed, jax.random.PRNGKey(0),
                jnp.int32(0))
            ttr.train_step(tfeed)
            for k in jtr.params:  # one Adam step apart: |dp| <= 2 lr
                np.testing.assert_allclose(
                    ttr.params[k].numpy(), np.asarray(jtr.params[k]),
                    rtol=0, atol=2.5 * spec["lr"], err_msg=k)
    for slots in ttr.opt_state["slots"].values():
        for s in slots.values():
            assert s.dtype == torch.float32


def test_eval_forward_matches_jax(model):
    """``test()``'s forward runs on the cast parameters too: the cost of
    a batch equals JAX's at bf16 within the value tolerance."""
    name, spec, _, _, _ = model
    jtr, ttr = _trainers(model)
    jf, tf = _feeders(spec)
    batches = [spec["batch"](7)]
    jres = jtr.test(lambda: iter(batches), feeder=jf)
    tres = ttr.test(lambda: iter(batches), feeder=tf)
    assert tres.cost == pytest.approx(jres.cost, rel=1e-2)


_CONF = textwrap.dedent(f"""
    import numpy as np
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    cost, out, _ = lstm_text_classifier(vocab_size={V}, embed_dim={E},
                                        hidden={HID})
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


def test_cli_compute_dtype_trains_tests_times_and_saves_f32(tmp_path,
                                                            capsys):
    """``--compute_dtype bfloat16`` reaches every job: train (two passes,
    a checkpoint a pass), test and time on the CPU; the checkpoint holds
    f32 masters in the JAX format, and JAX's ``SGD`` takes them."""
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    save_dir = tmp_path / "ckpt"
    assert cli.parse_args(["--config", "c", "--job", "train",
                           "--compute_dtype", "bfloat16"]
                          ).compute_dtype == "bfloat16"
    assert cli.parse_args(["--config", "c", "--job", "train"]
                          ).compute_dtype is None

    def _cli(*a):
        assert cli.main(["--config", str(conf), "--device", "cpu",
                         "--compute_dtype", "bfloat16", *a]) == 0
        return capsys.readouterr().out

    out = _cli("--job", "train", "--num_passes", "2", "--save_dir",
               str(save_dir))
    passes = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    assert [p.split(":")[0] for p in passes] == ["Pass 0", "Pass 1"]
    costs = [float(p.split("cost=")[1].split()[0]) for p in passes]
    assert all(np.isfinite(costs))
    ckpt = latest_checkpoint(str(save_dir))
    out = _cli("--job", "test", "--init_model_path", ckpt)
    assert out.startswith("Test: cost=")
    out = _cli("--job", "time", "--init_model_path", ckpt,
               "--time_batches", "2", "--time_warmup", "1")
    assert "TimeInfo: avg_batch_time=" in out
    params, _ = j_load_params(ckpt)
    assert all(np.asarray(v).dtype == np.float32 for v in params.values())
    jdsl.reset()
    jcost = _classifier(jdsl)
    jtr = JSGD(cost=jcost, update_equation=JAdam(),
               parameters={k: jnp.asarray(v) for k, v in params.items()},
               compute_dtype="bfloat16")
    feed = JFeeder({"words": jtypes.integer_value_sequence(V),
                    "label": jtypes.integer_value(2)},
                   pad_multiple=TMAX)(_classifier_batch(5))
    outs = jtr.network.apply(jtr._cast_compute(jtr.params),
                             jtr._cast_compute(feed), train=False)
    assert np.isfinite(float(jtr._total_cost(outs)))


def test_prev_batch_state_carries_at_the_layers_dtype():
    """Truncated BPTT under bf16: the carried state is kept in f32 (exact:
    bf16 widened) and enters each layer at its input's dtype: the first
    LSTM's bf16, the second's f32, as JAX carries them; the carried run
    matches JAX's second-batch loss."""
    jdsl.reset()
    jcost = _classifier(jdsl)
    tdsl.reset()
    tcost = _classifier(tdsl)
    rng = np.random.default_rng(0)
    specs = JNetwork(jcost.graph, outputs=[jcost.name]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
              for k, s in specs.items()}
    jtr = JSGD(cost=jcost, update_equation=JAdam(learning_rate=1e-3),
               parameters={k: jnp.asarray(v) for k, v in params.items()},
               compute_dtype="bfloat16", prev_batch_state=True)
    ttr = SGD(cost=tcost, update_equation=Adam(learning_rate=1e-3),
              parameters=params_from_numpy(params, device="cpu"),
              device="cpu", compute_dtype="bfloat16", prev_batch_state=True)
    jf = JFeeder(MODELS["classifier"]["feeding"](jtypes), pad_multiple=TMAX)
    tf = TFeeder(MODELS["classifier"]["feeding"](ttypes), pad_multiple=TMAX,
                 device="cpu")
    b1, b2 = _classifier_batch(11), _classifier_batch(12)
    jcosts = []
    jtr.train(lambda: iter([b1, b2]), feeder=jf, num_passes=1,
              event_handler=lambda e: jcosts.append(e.cost)
              if hasattr(e, "cost") else None)
    tcosts = []
    ttr.train(lambda: iter([b1, b2]), feeder=tf, num_passes=1,
              event_handler=lambda e: tcosts.append(e.cost)
              if isinstance(e, tev.EndIteration) else None)
    np.testing.assert_allclose(tcosts, jcosts[:2], rtol=1e-2)
    feed = tf(b1)
    ttr.train_step(feed)
    st = ttr._carried
    assert all(s.dtype == torch.float32 for s in st["lstm0"])
    outs = ttr.network.apply(ttr._cast_compute(ttr.params),
                             ttr._cast_compute(feed), carried=st)
    assert [s.dtype for s in outs["lstm0"].state] == [BF, BF]
    assert [s.dtype for s in outs["lstm1"].state] == [torch.float32] * 2
