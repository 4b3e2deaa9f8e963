"""The 17 evaluator types the port gained against the JAX package's, on the
CPU: each built from the same config by both packages'
``build_from_configs``, fed the same arrays over three batches, its value
and (for a printer) its printed lines compared. One case a type.

Then the trainer's wiring: a classifier with ``classification_error``,
``auc``, ``precision_recall``, ``pnpair`` (with a query id) and the
printers, through ``SGD.test`` in both packages from the same parameters:
the evaluator values within 1e-6 and the printed lines equal; and a
training step's ``gradient_printer`` line (the gradient of the cost by the
layer's output, from the step's own backward) against JAX's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.optim import Momentum as JMomentum
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer.metrics import build_from_configs as j_build
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.optim import Momentum as TMomentum
from paddle_tpu_torch.trainer import metrics as tmetrics
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

B, T, C = 6, 5, 4


def _probs(rng, *shape):
    return rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(
        np.float32)


def _mask(rng):
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    return (np.arange(T)[None] < lens[:, None]).astype(np.float32)


def _detections(rng):
    """detection_output rows (label, score, box, valid) and ground truth
    (label, box, difficult), near-matching boxes for half the rows."""
    gt = np.full((B, 3, 6), -1.0, np.float32)
    out = np.zeros((B, 5, 7), np.float32)
    for b in range(B):
        for i in range(int(rng.integers(1, 4))):
            x0, y0 = rng.uniform(0, 0.5, size=2)
            gt[b, i] = [rng.integers(1, 3), x0, y0, x0 + 0.3, y0 + 0.3,
                        float(rng.random() < 0.2)]
        for i in range(5):
            src = gt[b, i % 3]
            if src[0] >= 0 and rng.random() < 0.6:
                box = src[1:5] + rng.normal(scale=0.03, size=4)
                lab = src[0]
            else:
                x0, y0 = rng.uniform(0, 0.6, size=2)
                box = [x0, y0, x0 + 0.2, y0 + 0.2]
                lab = rng.integers(0, 3)
            out[b, i] = [lab, rng.random(), *box, float(rng.random() < 0.9)]
    return out, gt


def _case(kind, rng):
    """(config kwargs, eval_batch kwargs for one batch)."""
    m = _mask(rng)
    if kind in ("classification_error", "classification_error_printer"):
        return {}, dict(output=_probs(rng, B, T, C),
                        label=rng.integers(0, C, size=(B, T)), mask=m)
    if kind == "seq_classification_error":
        return {"top_k": 2}, dict(output=_probs(rng, B, T, C),
                                  label=rng.integers(0, C, size=(B, T)),
                                  mask=m)
    if kind == "rankauc":
        return {}, dict(output=rng.random((B, T, 1)).astype(np.float32),
                        label=rng.integers(0, 2, size=(B, T)).astype(
                            np.float32),
                        weight=rng.integers(1, 4, size=(B, T)).astype(
                            np.float32), mask=m)
    if kind in ("auc", "last-column-auc"):
        return {"num_bins": 64}, dict(output=_probs(rng, 4 * B, 2),
                                      label=rng.integers(0, 2, size=4 * B))
    if kind == "precision_recall":
        return {"positive_label": 1}, dict(
            output=_probs(rng, 4 * B, C),
            label=rng.integers(0, C, size=4 * B),
            weight=rng.random(4 * B).astype(np.float32))
    if kind == "pnpair":
        return {}, dict(output=rng.random((4 * B, 1)).astype(np.float32),
                        label=rng.integers(0, 3, size=4 * B),
                        query_id=rng.integers(0, 3, size=4 * B))
    if kind in ("column_sum", "last-column-sum"):
        return ({"column": 2} if kind == "column_sum" else {}), dict(
            output=rng.normal(size=(B, T, C)).astype(np.float32), mask=m)
    if kind == "value_printer":
        return {}, dict(output=rng.normal(size=(B, T, 2)).astype(np.float32),
                        mask=m)
    if kind == "gradient_printer":
        return {}, dict(output=rng.normal(size=(B, 3)).astype(np.float32),
                        grad=rng.normal(size=(B, 3)).astype(np.float32))
    if kind in ("max_id_printer", "maxid_printer"):
        return {"num_results": 2}, dict(output=_probs(rng, B, C))
    if kind == "max_frame_printer":
        return {"num_results": 3}, dict(
            output=rng.normal(size=(B, T, 1)).astype(np.float32), mask=m)
    if kind == "seq_text_printer":
        return {}, dict(output=rng.integers(0, 9, size=(B, T)), mask=m)
    if kind == "detection_map":
        out, gt = _detections(rng)
        return {"overlap_threshold": 0.5}, dict(output=out, label=gt)
    raise AssertionError(kind)


KINDS = ["classification_error", "seq_classification_error", "rankauc",
         "auc", "last-column-auc", "precision_recall", "pnpair",
         "column_sum", "last-column-sum", "value_printer",
         "gradient_printer", "max_id_printer", "maxid_printer",
         "max_frame_printer", "classification_error_printer",
         "seq_text_printer", "detection_map"]


def test_not_ported_is_empty():
    assert tmetrics.NOT_PORTED == ()
    assert len(KINDS) == 17


@pytest.mark.parametrize("kind", KINDS)
def test_evaluator_matches_jax(kind, capsys):
    rng = np.random.default_rng(KINDS.index(kind))
    cfg_kw, _ = _case(kind, np.random.default_rng(99))
    cfg = [{"type": kind, "name": "ev", "input_layers": ["o", "y"],
            **cfg_kw}]
    ((te, _, _),), ((je, _, _),) = (tmetrics.build_from_configs(cfg),
                                    j_build(cfg))
    assert type(te).__name__ == type(je).__name__
    for _ in range(3):
        _, batch = _case(kind, rng)
        out = batch.pop("output")
        grad = batch.pop("grad", None)
        te.eval_batch(out, **batch)
        je.eval_batch(out, **batch)
        if grad is not None:  # the trainer hands a printer its gradient
            te.last, je.last = grad, grad
    capsys.readouterr()
    tv = te.value()
    t_print = capsys.readouterr().out
    jv = je.value()
    j_print = capsys.readouterr().out
    assert tv == pytest.approx(jv, rel=1e-12, abs=1e-12)
    assert t_print == j_print
    if te.prints_on_value:
        assert t_print
    else:
        assert not t_print


# --------------------------------------------------- through the trainer
D = 6


def _graph(dsl):
    x = dsl.data(name="x", size=D)
    lab = dsl.data(name="label", size=C)
    qid = dsl.data(name="qid", size=4)
    hid = dsl.fc(input=x, size=8, act="tanh", name="hid")
    out = dsl.fc(input=hid, size=C, act="softmax", name="out")
    cost = dsl.classification_cost(input=out, label=lab, name="cost")
    dsl.evaluator("classification_error", out, label=lab, name="err")
    dsl.evaluator("auc", out, label=lab, name="auc")
    dsl.evaluator("precision_recall", out, label=lab, name="pr")
    dsl.evaluator("pnpair", [out], label=lab, weight=qid, name="pnpair")
    dsl.evaluator("value_printer", out, name="values")
    dsl.evaluator("max_id_printer", out, name="maxid")
    dsl.evaluator("classification_error_printer", out, label=lab,
                  name="errs")
    dsl.evaluator("gradient_printer", hid, name="hid_grad")
    return cost


def _pair():
    jdsl.reset()
    jcost = _graph(jdsl)
    jtr = JSGD(cost=jcost, update_equation=JMomentum(learning_rate=0.1),
               seed=3)
    rng = np.random.default_rng(1)
    params = {k: (rng.normal(size=np.shape(v)) * 0.5).astype(np.float32)
              for k, v in jtr.params.items()}
    jtr = JSGD(cost=jcost, update_equation=JMomentum(learning_rate=0.1),
               parameters={k: jnp.asarray(v) for k, v in params.items()})
    tdsl.reset()
    ttr = TSGD(_graph(tdsl), parameters=params, device="cpu",
               update_equation=TMomentum(learning_rate=0.1))
    return jtr, ttr


def _data(seed=5, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, D)).astype(np.float32),
             rng.integers(0, C, size=8).astype(np.int32),
             rng.integers(0, 3, size=8).astype(np.int32)) for _ in range(n)]


def _readers(data):
    def jr():
        for x, y, q in data:
            yield {"x": JArgument(jnp.asarray(x)),
                   "label": JArgument(jnp.asarray(y)),
                   "qid": JArgument(jnp.asarray(q))}

    def tr():
        for x, y, q in data:
            yield {"x": TArgument(torch.from_numpy(x)),
                   "label": TArgument(torch.from_numpy(y)),
                   "qid": TArgument(torch.from_numpy(q))}
    return jr, tr


def _floats(text):
    return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", text)]


def test_trainer_evaluators_and_printers_match_jax(capsys):
    """``SGD.test`` with the declared evaluators: the values within 1e-6
    of JAX's and the printed lines the same (numbers within 1e-5)."""
    jtr, ttr = _pair()
    jr, tr = _readers(_data())
    capsys.readouterr()
    tres = ttr.test(tr)
    t_print = capsys.readouterr().out
    jres = jtr.test(jr)
    j_print = capsys.readouterr().out
    for k in ("err", "auc", "pr", "pnpair"):
        assert tres.evaluator[k] == pytest.approx(jres.evaluator[k],
                                                  abs=1e-6), k
    assert tres.cost == pytest.approx(jres.cost, rel=1e-5)
    assert re.sub(r"[-\d.e]+", "#", t_print) == re.sub(r"[-\d.e]+", "#",
                                                       j_print)
    np.testing.assert_allclose(_floats(t_print), _floats(j_print),
                               rtol=1e-5, atol=1e-5)
    assert "layer=values value:" in t_print and "hid_grad" in t_print


def test_gradient_printer_prints_the_steps_gradient(capsys):
    """One training batch: the ``gradient_printer`` line at the pass end
    holds d cost / d hid of that batch, as JAX's."""
    jtr, ttr = _pair()
    jr, tr = _readers(_data(n=1))
    capsys.readouterr()
    ttr.train(tr, num_passes=1)
    t_print = capsys.readouterr().out
    jtr.train(jr, num_passes=1)
    j_print = capsys.readouterr().out

    def grad_block(text):
        body = text.split("layer=hid_grad grad matrix:\n")[1]
        return np.array(_floats("\n".join(body.splitlines()[:8])))

    np.testing.assert_allclose(grad_block(t_print), grad_block(j_print),
                               rtol=1e-4, atol=1e-5)
    assert np.abs(grad_block(t_print)).max() > 0
