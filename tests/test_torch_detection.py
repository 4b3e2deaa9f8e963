"""The SSD layers (``priorbox``, ``multibox_loss``, ``detection_output``)
and their box helpers in the port against the JAX package, on the CPU:
the twin of ``tests/test_misc_layers.py``'s detection stack, a larger
ragged case, rows at exact score ties (``lax.top_k`` and ``argmax`` take
the lower index), and SSD300's 8732 priors.

Values rtol 1e-5 / atol 1e-5 (``detection_output``: labels and validity
equal), gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.layers import detection as jdet
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.layers import detection as tdet

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# SSD300 (Liu et al. 2016; Caffe ssd_pascal.py): map sizes, channels,
# min / max sizes and aspect ratios
SSD300_MAPS = [(38, 512), (19, 1024), (10, 512), (5, 256), (3, 256),
               (1, 256)]
SSD300_MIN = [30, 60, 111, 162, 213, 264]
SSD300_MAX = [60, 111, 162, 213, 264, 315]
SSD300_AR = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]


def test_box_helpers_match_jax():
    rng = np.random.default_rng(0)

    def boxes(n):
        lo = rng.random((n, 2)) * 0.6
        return np.concatenate([lo, lo + 0.05 + rng.random((n, 2)) * 0.35],
                              -1).astype(np.float32)
    a, b = boxes(7), boxes(5)
    b[0] = a[0]
    var = np.full((7, 4), 0.1, np.float32)
    loc = (rng.normal(size=(7, 4)) * 0.3).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tdet.iou_matrix(t(a), t(b)).numpy(),
                               np.asarray(jdet.iou_matrix(a, b)), **FWD_TOL)
    np.testing.assert_allclose(
        tdet.encode_box(t(a[::-1].copy()), t(a), t(var)).numpy(),
        np.asarray(jdet.encode_box(a[::-1].copy(), a, var)), **FWD_TOL)
    dec = tdet.decode_box(t(loc), t(a), t(var)).numpy()
    np.testing.assert_allclose(dec, np.asarray(jdet.decode_box(loc, a, var)),
                               **FWD_TOL)
    # the round trip of the twin's encode/decode
    enc = tdet.encode_box(t(a[::-1].copy()), t(a), t(var))
    np.testing.assert_allclose(tdet.decode_box(enc, t(a), t(var)).numpy(),
                               a[::-1], rtol=1e-4, atol=1e-5)


def test_ssd300_has_8732_priors_in_both_packages():
    """SSD300's six maps give 8732 priors by the JAX formula; the port's
    boxes equal JAX's bit for bit."""
    total = 0
    for (fm, _), mn, mx, ar in zip(SSD300_MAPS, SSD300_MIN, SSD300_MAX,
                                   SSD300_AR):
        jb, jv = jdet.make_prior_boxes(fm, fm, 300, 300, [mn], [mx], ar,
                                       [0.1, 0.1, 0.2, 0.2])
        tb, tv = tdet.make_prior_boxes(fm, fm, 300, 300, [mn], [mx], ar,
                                       [0.1, 0.1, 0.2, 0.2])
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        total += tb.shape[0]
    assert total == 8732


def _stack(dsl, C, maps, classes, keep_top_k, nms_top_k=100,
           img=32, min_sizes=(10,), max_sizes=(), ars=(1.0,)):
    """priorbox over each map, concatenated by the caller's feed order:
    one map only here (the DSL has no box concat), then loss and
    detection_output on data layers for loc and conf."""
    image = dsl.data("img", size=3 * img * img, channels=3, height=img,
                     width=img)
    h = maps
    feat = dsl.data("feat", size=C * h * h, channels=C, height=h, width=h)
    pb = dsl.priorbox_layer(feat, image, min_size=list(min_sizes),
                            max_size=list(max_sizes), aspect_ratio=list(ars))
    N = pb.size // 8
    conf = dsl.data("conf", size=N * classes)
    loc = dsl.data("loc", size=N * 4)
    gt = dsl.data("gt", size=5, is_sequence=True)
    loss = dsl.multibox_loss_layer(pb, gt, conf, loc, num_classes=classes,
                                   name="loss")
    det = dsl.detection_output_layer(pb, conf, loc, num_classes=classes,
                                     keep_top_k=keep_top_k,
                                     nms_top_k=nms_top_k, name="det")
    return N, [loss.name, det.name, pb.name]


def _gt(rng, B, G, classes):
    gtv = np.zeros((B, G, 5), np.float32)
    gtm = np.zeros((B, G), np.float32)
    for b in range(B):
        n = int(rng.integers(1, G + 1))
        lo = rng.random((n, 2)) * 0.6
        wh = 0.1 + rng.random((n, 2)) * 0.35
        gtv[b, :n, 0] = rng.integers(1, classes, size=n)
        gtv[b, :n, 1:3] = lo
        gtv[b, :n, 3:5] = np.minimum(lo + wh, 1.0)
        gtm[b, :n] = 1.0
    return gtv, gtm


def _run_stack(feed, build, grads=True):
    """The outputs (loss, detections, priors) of ``build(dsl)`` in both
    packages by name, and the loss's gradients with respect to loc and
    conf."""
    jdsl.reset()
    names = build(jdsl)
    jnet = JNetwork(jdsl.current_graph(), outputs=names)
    jloss = JNetwork(jdsl.current_graph(), outputs=names[:1])
    tdsl.reset()
    build(tdsl)
    tnet = TNetwork(tdsl.current_graph(), outputs=names)
    jfeed = {k: JArgument(value=jnp.asarray(v), mask=None if m is None
                          else jnp.asarray(m)) for k, (v, m) in feed.items()}
    tx = {k: torch.from_numpy(v.copy()).requires_grad_(k in ("loc", "conf"))
          for k, (v, _) in feed.items()}
    tfeed = {k: TArgument(value=tx[k], mask=None if m is None
                          else torch.from_numpy(m))
             for k, (_, m) in feed.items()}
    touts = tnet.apply({}, tfeed)
    # jitted: JAX's eager detection_output compiles each class's loop
    jouts = jax.jit(lambda f: {n: jnet.apply({}, f)[n].value
                               for n in names})(jfeed)
    out = {n: (touts[n].value.detach().numpy(), np.asarray(jouts[n]))
           for n in names}
    if grads:
        w = np.random.default_rng(3).normal(
            size=out["loss"][1].shape).astype(np.float32)
        tg = torch.autograd.grad((touts["loss"].value
                                  * torch.from_numpy(w)).sum(),
                                 [tx["loc"], tx["conf"]])

        def jl(lc, cf):
            f = dict(jfeed, loc=JArgument(value=lc), conf=JArgument(value=cf))
            return jnp.sum(jloss.apply({}, f)["loss"].value * w)
        jg = jax.jit(jax.grad(jl, argnums=(0, 1)))(jfeed["loc"].value,
                                                   jfeed["conf"].value)
        for g, want, n in zip(tg, jg, ("loc", "conf")):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       **GRAD_TOL, err_msg=n)
    return names, out


def _check_det(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])   # labels
    np.testing.assert_array_equal(got[..., 6], want[..., 6])   # valid
    np.testing.assert_allclose(got[..., 1:6], want[..., 1:6], **FWD_TOL)


def test_detection_stack_twin():
    """The twin of ``tests/test_misc_layers.py::test_detection_stack``:
    the same graph and batch, every output as JAX's."""
    rng = np.random.RandomState(0)
    C, Hf, classes, B = 4, 2, 3, 2
    N = Hf * Hf
    gtv = np.zeros((B, 3, 5), np.float32)
    gtv[:, 0] = [1, 0.1, 0.1, 0.4, 0.4]
    gtm = np.zeros((B, 3), np.float32)
    gtm[:, 0] = 1
    feed = {"img": (np.zeros((B, 3 * 32 * 32), np.float32), None),
            "feat": (np.zeros((B, C * Hf * Hf), np.float32), None),
            "conf": (rng.randn(B, N * classes).astype(np.float32), None),
            "loc": ((rng.randn(B, N * 4) * 0.1).astype(np.float32), None),
            "gt": (gtv, gtm)}
    names, out = _run_stack(
        feed, lambda dsl: _stack(dsl, C, Hf, classes, keep_top_k=5)[1])
    loss, det, pb = names
    assert out[pb][0].shape == (N, 8)
    np.testing.assert_array_equal(out[pb][0], out[pb][1])
    np.testing.assert_allclose(*out[loss], **FWD_TOL)
    assert (out[loss][0] > 0).all()
    _check_det(*out[det])
    assert out[det][0].shape == (B, 5, 7)


@pytest.mark.parametrize("nms_top_k,keep_top_k", [(100, 200), (7, 10),
                                                  (400, 30)])
def test_detection_larger_ragged_case(nms_top_k, keep_top_k):
    """Two aspect ratios and a max size over a 6 × 6 map (288 priors), 5
    classes, 1–4 ground-truth boxes an image, nms_top_k below and above
    the prior count: the loss, its gradients and every row."""
    rng = np.random.default_rng(4)
    C, Hf, classes, B = 3, 6, 5, 3
    def build(dsl):
        return _stack(dsl, C, Hf, classes, keep_top_k=keep_top_k,
                      nms_top_k=nms_top_k, img=60, min_sizes=(12, 24),
                      max_sizes=(20, 40), ars=(1.0, 2.0))[1]
    N = Hf * Hf * (2 * (1 + 2) + 2)   # 288 priors
    gtv, gtm = _gt(rng, B, 4, classes)
    feed = {"img": (np.zeros((B, 3 * 60 * 60), np.float32), None),
            "feat": (np.zeros((B, C * Hf * Hf), np.float32), None),
            "conf": (rng.normal(size=(B, N * classes)).astype(np.float32),
                     None),
            "loc": ((rng.normal(size=(B, N * 4)) * 0.2).astype(np.float32),
                    None),
            "gt": (gtv, gtm)}
    names, out = _run_stack(feed, build)
    assert out[names[2]][0].shape == (N, 8)
    np.testing.assert_allclose(*out[names[0]], **FWD_TOL)
    _check_det(*out[names[1]])
    assert out[names[1]][1][..., 6].sum() > 0


def test_detection_output_rows_at_exact_ties():
    """Rows whose scores tie exactly: two identical priors (one suppressed
    by the other, the lower index kept), two classes with equal
    confidences everywhere (the lower class first), and the −1 padding
    of invalid rows: the same rows as JAX."""
    rng = np.random.default_rng(5)
    C, Hf, classes, B = 2, 3, 4, 2
    N = Hf * Hf
    conf = rng.normal(size=(B, N, classes)).astype(np.float32)
    conf[:, :, 2] = conf[:, :, 1]          # classes 1 and 2 tie
    loc = (rng.normal(size=(B, N, 4)) * 0.1).astype(np.float32)
    conf[:, 4] = conf[:, 3]                # priors 3 and 4: same scores
    loc[:, 4] = loc[:, 3]
    conf[1, :, 3] = -30.0                  # class 3 below the threshold
    gtv, gtm = _gt(rng, B, 2, classes)
    feed = {"img": (np.zeros((B, 3 * 32 * 32), np.float32), None),
            "feat": (np.zeros((B, C * N), np.float32), None),
            "conf": (conf.reshape(B, -1), None),
            "loc": (loc.reshape(B, -1), None), "gt": (gtv, gtm)}
    names, out = _run_stack(
        feed, lambda dsl: _stack(dsl, C, Hf, classes, keep_top_k=40,
                                 nms_top_k=12)[1], grads=False)
    got, want = out[names[1]]
    _check_det(got, want)
    assert (want[..., 6] == 0).any()        # padded invalid rows
    valid = want[0][want[0, :, 6] > 0]
    assert {1.0, 2.0} <= set(valid[:, 0])


def test_nms_fixed_rows_match_jax_per_row():
    """The port's batched NMS against JAX's one-row ``nms_fixed`` over
    every (image, class) row, with filtered boxes at -inf."""
    rng = np.random.default_rng(6)
    B, R, N, P = 2, 3, 40, 15
    lo = rng.random((B, N, 2)) * 0.7
    boxes = np.concatenate([lo, lo + 0.05 + rng.random((B, N, 2)) * 0.3],
                           -1).astype(np.float32)
    scores = rng.random((B, R, N)).astype(np.float32)
    scores[scores < 0.3] = -np.inf
    scores[1, 2] = -np.inf                  # a row with nothing
    idx, ok = tdet.nms_fixed(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.45, P)
    for b in range(B):
        for r in range(R):
            ji, jo = jdet.nms_fixed(jnp.asarray(boxes[b]),
                                    jnp.asarray(scores[b, r]), 0.45, P)
            np.testing.assert_array_equal(idx[b, r].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(ok[b, r].numpy(), np.asarray(jo))
