"""The image slice end to end against the JAX package, on the CPU:
``resnet`` (the graph ``__graft_entry__.py:entry()`` compiles) and
``lenet_mnist``, built with both DSLs, with the JAX package's
``init_params`` carried across by name.

- ``resnet(50)`` at ``entry()``'s size has the reference's geometry
  (``stem_pool`` 64 x 57 x 57, ``res5c_add`` 2048 x 8 x 8) and 25,610,152
  parameters;
- ``resnet(50, classes=10, image_size=32, width=8)`` at batch 2, three
  ways: (a) ``train=True`` at ``init_params``, the output and every state
  update; (b) ``train=False`` after each package wrote its (a) moving
  statistics into its parameters by name; (c) ``train=False`` at
  ``init_params``, as ``entry()`` runs it, where the moving variance is 0
  and the output is NaN in places: NaN in the same places, equal values
  where finite (NaN is never compared with NaN as a value);
- the full-width graph at batch 2, (a);
- float32 gradients at init against float64 in both packages: a
  pre-activation within rounding of 0 flips its ReLU, so both miss the
  exact gradients by tens of times the tolerance, and the port is within
  it in float64 and in float32 with float64's ReLU masks replayed;
- three Momentum steps of ``resnet(18, classes=4, image_size=16,
  width=8)`` and of ``lenet_mnist`` by the port's ``SGD`` against JAX's:
  the costs, the parameters and the moving statistics folded in after
  each step;
- LeNet through the CLI (train, merge, test) and the merged model served
  by the predictor: single rows and a batch give the trainer's scores.

Tolerances: forward rtol/atol 1e-5 (ROADMAP's), trajectories rtol/atol
1e-4 (the gradient differences compounded over 3 updates, as in
``test_torch_train.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.models import lenet_mnist as j_lenet
from paddle_tpu.models import resnet as j_resnet
from paddle_tpu.optim import Momentum as JMomentum
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer import events as jev
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.models import lenet_mnist as t_lenet
from paddle_tpu_torch.models import resnet as t_resnet
from paddle_tpu_torch.optim import Momentum as TMomentum
from paddle_tpu_torch.serving.predictor import ServingPredictor
from paddle_tpu_torch.trainer import cli
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)


def _nets(build, **kw):
    """(JAX network, port network) of the graph ``build(**kw)`` makes in
    each package, executing up to its softmax output."""
    jdsl.reset()
    _, jout, _ = build[0](**kw)
    jnet = JNetwork(jdsl.current_graph(), outputs=[jout.name])
    tdsl.reset()
    _, tout, _ = build[1](**kw)
    tnet = TNetwork(tdsl.current_graph(), outputs=[tout.name])
    assert jout.name == tout.name == "output"
    return jnet, tnet


RESNET = (j_resnet, t_resnet)


def _jparams(jnet, seed=0):
    """The JAX package's ``init_params`` as numpy."""
    return {k: np.array(v) for k, v in
            jnet.init_params(jax.random.PRNGKey(seed)).items()}


def _forward(jnet, tnet, jp, tp, image, train):
    jouts, jupd = jnet.apply_with_state(
        {k: jnp.asarray(v) for k, v in jp.items()},
        {"image": JArgument(value=jnp.asarray(image))}, train=train)
    with torch.no_grad():
        touts, tupd = tnet.apply_with_state(
            {k: torch.from_numpy(v) for k, v in tp.items()},
            {"image": TArgument(value=torch.from_numpy(image))}, train=train)
    return (np.asarray(jouts["output"].value),
            {k: np.asarray(v) for k, v in jupd.items()},
            touts["output"].value.numpy(),
            {k: v.numpy() for k, v in tupd.items()})


def test_resnet50_has_the_reference_geometry_and_size():
    jnet, tnet = _nets(RESNET, depth=50, classes=1000, image_size=224)
    for name in ("stem_pool", "res5c_add", "global_pool"):
        t, j = tnet.shape_infos[name], jnet.shape_infos[name]
        assert (t.channels, t.height, t.width, t.size) == \
            (j.channels, j.height, j.width, j.size), name
    s = tnet.shape_infos
    assert (s["stem_pool"].channels, s["stem_pool"].height) == (64, 57)
    assert (s["res5c_add"].channels, s["res5c_add"].height) == (2048, 8)
    assert sum(int(np.prod(p.shape)) for p in
               tnet.param_specs.values()) == 25610152
    assert {k: tuple(p.shape) for k, p in tnet.param_specs.items()} == \
        {k: tuple(p.shape) for k, p in jnet.param_specs.items()}
    statics = sorted(k for k, p in tnet.param_specs.items() if p.is_static)
    assert len(statics) == 106 and statics == sorted(
        k for k, p in jnet.param_specs.items() if p.is_static)


def test_resnet50_small_matches_jax_three_ways():
    """(a), (b) and (c) at ``resnet(50, classes=10, image_size=32,
    width=8)``, batch 2."""
    jnet, tnet = _nets(RESNET, depth=50, classes=10, image_size=32, width=8)
    assert (tnet.shape_infos["stem_pool"].height,
            tnet.shape_infos["stem_pool"].channels) == (9, 8)
    jp = _jparams(jnet)
    image = np.random.default_rng(1).normal(
        size=(2, 32, 32, 3)).astype(np.float32)
    # (a) train=True: the output and the 106 state updates
    jo, jupd, to, tupd = _forward(jnet, tnet, jp, jp, image, True)
    assert np.isfinite(jo).all() and len(jupd) == 106
    np.testing.assert_allclose(to, jo, **FWD_TOL)
    assert sorted(tupd) == sorted(jupd)
    for k in jupd:
        np.testing.assert_allclose(tupd[k], jupd[k], **FWD_TOL, err_msg=k)
    # (b) train=False on each package's own moving statistics
    jo_b, _, to_b, upd_b = _forward(jnet, tnet, {**jp, **jupd},
                                    {**jp, **tupd}, image, False)
    assert np.isfinite(jo_b).all() and not upd_b
    np.testing.assert_allclose(to_b, jo_b, **FWD_TOL)
    # (c) train=False at init_params: NaN in the same places
    jo_c, _, to_c, _ = _forward(jnet, tnet, jp, jp, image, False)
    assert np.isnan(jo_c).any()
    np.testing.assert_array_equal(np.isnan(to_c), np.isnan(jo_c))
    live = ~np.isnan(jo_c)
    np.testing.assert_allclose(to_c[live], jo_c[live], **FWD_TOL)


def test_resnet50_full_width_train_forward_matches_jax():
    """(a) at ``entry()``'s graph, ``resnet(50, classes=1000,
    image_size=224)``, batch 2: the softmax output and every moving
    statistic."""
    jnet, tnet = _nets(RESNET, depth=50, classes=1000, image_size=224)
    jp = _jparams(jnet, seed=3)
    image = np.random.default_rng(2).normal(
        size=(2, 224, 224, 3)).astype(np.float32)
    jo, jupd, to, tupd = _forward(jnet, tnet, jp, jp, image, True)
    assert jo.shape == (2, 1000) and np.isfinite(jo).all()
    np.testing.assert_allclose(to, jo, **FWD_TOL)
    assert sorted(tupd) == sorted(jupd) and len(jupd) == 106
    for k in jupd:
        np.testing.assert_allclose(tupd[k], jupd[k], **FWD_TOL, err_msg=k)



def _grad_multiples(grads, exact):
    """Each gradient's largest distance from the exact one, as a multiple
    of the gradient tolerance (1e-3 of the exact tensor's largest entry
    + 1e-6)."""
    return {k: float(np.abs(grads[k] - w).max()
                     / (1e-3 * np.abs(w).max() + 1e-6))
            for k, w in exact.items()}


def test_resnet50_float32_gradients_miss_float64_where_relu_masks_flip(
        monkeypatch):
    """Why the card's ResNet-50 gradients are held in float64, and in
    float32 with float64's ReLU masks: at the port's ``init_params`` (here
    ``resnet(50, classes=10, image_size=32, width=8)``, batch 8) a
    float32 pre-activation within rounding of 0 takes the other side of
    a ReLU than in float64 and routes a whole gradient entry elsewhere.
    The JAX package's float32 gradients miss its float64 ones by tens of
    times the tolerance, and the port's by as much; in float64 the two
    packages agree within it; with the float64 run's ReLU masks replayed,
    the port's float32 gradients are within it too."""
    from paddle_tpu_torch.layers import activations
    jdsl.reset()
    jcost, _, _ = j_resnet(50, classes=10, image_size=32, width=8)
    jnet = JNetwork(jdsl.current_graph(), outputs=[jcost.name])
    tdsl.reset()
    tcost, _, _ = t_resnet(50, classes=10, image_size=32, width=8)
    tnet = TNetwork(tdsl.current_graph(), outputs=[tcost.name])
    p = {k: v.numpy() for k, v in tnet.init_params(
        torch.Generator().manual_seed(0), device="cpu").items()}
    static = {k for k, s in tnet.param_specs.items() if s.is_static}
    rng = np.random.default_rng(1)
    image = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    label = rng.integers(0, 10, size=8).astype(np.int32)

    def jax_grads(dtype):
        fixed = {k: jnp.asarray(p[k], dtype) for k in static}

        def loss(trained):
            outs, _ = jnet.apply_with_state(
                {**fixed, **trained},
                {"image": JArgument(value=jnp.asarray(image, dtype)),
                 "label": JArgument(value=jnp.asarray(label))}, train=True)
            return outs[jcost.name].value.mean()

        g = jax.jit(jax.grad(loss))({k: jnp.asarray(v, dtype)
                                     for k, v in p.items()
                                     if k not in static})
        return {k: np.asarray(v, np.float64) for k, v in g.items()}

    def port_grads(dtype):
        leaves = {k: torch.from_numpy(v).to(dtype).requires_grad_(
            k not in static) for k, v in p.items()}
        outs, _ = tnet.apply_with_state(
            leaves, {"image": TArgument(value=torch.from_numpy(image).to(
                dtype)), "label": TArgument(value=torch.from_numpy(label))},
            train=True)
        names = [k for k in leaves if k not in static]
        g = torch.autograd.grad(outs[tcost.name].value.mean(),
                                [leaves[k] for k in names])
        return {k: v.double().numpy() for k, v in zip(names, g)}

    jax32 = jax_grads(jnp.float32)
    with jax.enable_x64():
        jax64 = jax_grads(jnp.float64)
    plain, masks = activations.apply_activation, []

    def record(kind, value, mask):
        if kind == "relu":
            masks.append(value.detach() > 0)
        return plain(kind, value, mask)

    monkeypatch.setattr(activations, "apply_activation", record)
    port64 = port_grads(torch.float64)
    left = iter(masks)

    def replay(kind, value, mask):
        if kind != "relu":
            return plain(kind, value, mask)
        return value * next(left).to(value.dtype)

    monkeypatch.setattr(activations, "apply_activation", replay)
    port32_masked = port_grads(torch.float32)
    assert next(left, None) is None and len(masks) == 49
    monkeypatch.setattr(activations, "apply_activation", plain)
    port32 = port_grads(torch.float32)
    miss = {name: max(_grad_multiples(g, want).values()) for name, g, want
            in (("jax32", jax32, jax64), ("port32", port32, port64),
                ("port64", port64, jax64),
                ("port32_masked", port32_masked, port64))}
    assert miss["jax32"] > 10 and miss["port32"] > 10, miss
    assert miss["port32"] <= 2 * miss["jax32"] + 1, miss
    assert miss["port64"] <= 1 and miss["port32_masked"] <= 1, miss


# ------------------------------------------------------------ training
def _digits(seed, n, classes, size, channels=1):
    """Synthetic images: each class a fixed random prototype plus noise,
    as channel-major rows, with their labels."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(classes, channels * size * size))
    labels = rng.integers(0, classes, size=n)
    x = protos[labels] + 0.5 * rng.normal(size=(n, protos.shape[1]))
    return [(x[i].astype(np.float32), int(labels[i])) for i in range(n)]


def _trajectories(jbuild, tbuild, feeding_of, data_name, batches, seed):
    """3 Momentum steps in each package from JAX's init params: per-step
    costs and the final parameters."""
    jdsl.reset()
    jcost, _, _ = jbuild()
    jtr0 = JSGD(cost=jcost, update_equation=JMomentum(learning_rate=0.01,
                                                      momentum=0.9),
                seed=seed)
    params = {k: np.array(v) for k, v in jtr0.params.items()}
    jtr = JSGD(cost=jcost,
               update_equation=JMomentum(learning_rate=0.01, momentum=0.9),
               parameters={k: jnp.asarray(v) for k, v in params.items()})
    tdsl.reset()
    tcost, _, _ = tbuild()
    ttr = TSGD(cost=tcost,
               update_equation=TMomentum(learning_rate=0.01, momentum=0.9),
               parameters=params, device="cpu")
    jcosts, tcosts = [], []
    jtr.train(lambda: iter(batches), feeder=JFeeder(feeding_of(jtypes)),
              num_passes=1, event_handler=lambda e: jcosts.append(e.cost)
              if isinstance(e, jev.EndIteration) else None)
    ttr.train(lambda: iter(batches),
              feeder=TFeeder(feeding_of(ttypes), device="cpu"),
              num_passes=1, event_handler=lambda e: tcosts.append(e.cost)
              if isinstance(e, tev.EndIteration) else None)
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    jp = {k: np.asarray(v) for k, v in jtr.params.items()}
    assert sorted(ttr.params) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(ttr.params[k].numpy(), jp[k], **RUN_TOL,
                                   err_msg=k)
    return params, jp


def test_resnet18_tiny_trains_as_jax_does():
    """Costs, parameters and the folded moving statistics after 3 steps."""
    data = _digits(4, 24, 4, 16, channels=3)
    batches = [data[i:i + 8] for i in range(0, 24, 8)]

    def feeding(types):
        return {"image": types.dense_vector(3 * 16 * 16),
                "label": types.integer_value(4)}

    kw = dict(classes=4, image_size=16, width=8)
    before, after = _trajectories(lambda: j_resnet(18, **kw),
                                  lambda: t_resnet(18, **kw), feeding,
                                  "image", batches, seed=5)
    # the moving statistics moved off their zeros, and were not given to
    # the optimizer (momentum would move a static parameter otherwise)
    stats = [k for k in after if k.endswith((".w1", ".w2"))]
    assert len(stats) == 2 * 21  # the stem, 16 block convs, 4 shortcuts
    assert all(np.abs(after[k] - before[k]).max() > 0 for k in stats)


def test_lenet_trains_as_jax_does():
    data = _digits(7, 24, 10, 28)
    batches = [data[i:i + 8] for i in range(0, 24, 8)]

    def feeding(types):
        return {"pixel": types.dense_vector(784),
                "label": types.integer_value(10)}

    _trajectories(lambda: j_lenet(), lambda: t_lenet(), feeding, "pixel",
                  batches, seed=6)


_LENET_CONF = """
import numpy as np
from paddle_tpu_torch.config import dsl
from paddle_tpu_torch.data import types
from paddle_tpu_torch.models import lenet_mnist
from paddle_tpu_torch.optim import Momentum

dsl.reset()
cost, out, _ = lenet_mnist()
outputs = [out]
optimizer = Momentum(learning_rate=0.01, momentum=0.9)
feeding = {"pixel": types.dense_vector(784),
           "label": types.integer_value(10)}


def train_reader():
    rng = np.random.default_rng(2017)
    protos = rng.normal(size=(10, 784))
    for _ in range(4):
        y = rng.integers(0, 10, size=16)
        x = protos[y] + 0.5 * rng.normal(size=(16, 784))
        yield [(x[i].astype(np.float32), int(y[i])) for i in range(16)]


test_reader = train_reader
"""


def test_lenet_cli_merge_and_predictor(tmp_path, capsys):
    """``--job train`` (its classification error falls), ``--job merge``,
    ``--job test``; the merged file served by the predictor scores single
    rows and a batch as the trainer's forward does."""
    conf = tmp_path / "conf.py"
    conf.write_text(_LENET_CONF)
    save_dir, model = tmp_path / "ckpt", tmp_path / "m.ptmodel"

    def _cli(*args):
        assert cli.main(list(args)) == 0
        return capsys.readouterr().out

    out = _cli("--config", str(conf), "--job", "train", "--device", "cpu",
               "--num_passes", "3", "--save_dir", str(save_dir))
    errs = [float(ln.split("classification_error=")[1].split()[0])
            for ln in out.splitlines() if ln.startswith("Pass ")]
    assert len(errs) == 3 and errs[-1] < errs[0]
    _cli("--config", str(conf), "--job", "merge", "--device", "cpu",
         "--save_dir", str(save_dir), "--model_path", str(model))
    out = _cli("--config", str(conf), "--job", "test", "--device", "cpu",
               "--save_dir", str(save_dir))
    assert out.startswith("Test: cost=")
    feeding = {"pixel": ttypes.dense_vector(784)}
    pred = ServingPredictor.from_merged(str(model), feeding,
                                        batch_buckets=[1, 16],
                                        device="cpu")
    rows = [(r[0],) for r in _digits(9, 16, 10, 28)]
    batch, info = pred.predict_rows(rows)
    assert info["bucket"] is not None
    from paddle_tpu_torch.trainer.merge_model import load_merged_ex
    graph, params, _, _ = load_merged_ex(str(model))
    assert any(k.endswith(".w0") for k in params)
    net = TNetwork(graph, outputs=["output"])
    with torch.no_grad():
        want = net.apply({k: torch.from_numpy(np.asarray(v))
                          for k, v in params.items()},
                         {"pixel": TArgument(value=torch.from_numpy(
                             np.stack([r[0] for r in rows])))})
    want = want["output"].value.numpy()
    np.testing.assert_allclose(batch["output"][:16], want, **FWD_TOL)
    for i in (0, 7):
        one, _ = pred.predict_rows([rows[i]])
        np.testing.assert_allclose(one["output"][0], want[i], **FWD_TOL)
    json.dumps(info)
