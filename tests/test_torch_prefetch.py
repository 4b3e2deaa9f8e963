"""The port's input pipeline (``data/prefetch.py``) on the CPU, against the
JAX package's and against synchronous loading.

- ``PrefetchPipeline`` yields the feeds the feeder gives, in order, with
  ``depth`` batches in flight; the JAX pipeline over the same reader and
  feeder gives the same arrays;
- ``train(async_load_data=True)`` ends bit-equal to synchronous loading
  (parameters, optimizer state), at depths 1 and 3, and a
  ``prefetch_reader`` is consumed as it is (a feeder beside it raises);
- a worker's exception surfaces at the consumer after the batches
  prepared before it, and ``close()`` mid-pass stops the worker.
"""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.data.prefetch import PrefetchPipeline as JPipeline
from paddle_tpu_torch.config import dsl
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.data.prefetch import PrefetchPipeline, prefetch_reader
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer.checkpoint import _flatten
from paddle_tpu_torch.trainer.trainer import SGD

V = 40


def _batches(n=5, B=6, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append([(rng.integers(0, V, size=int(rng.integers(1, 9)))
                     .tolist(), int(rng.integers(0, 2))) for _ in range(B)])
    return out


def _feeding(types):
    return {"words": types.integer_value_sequence(V),
            "label": types.integer_value(2)}


def test_pipeline_yields_the_feeders_batches_as_jax_does():
    batches = _batches()
    feeder = DataFeeder(_feeding(ttypes), pad_multiple=4, device="cpu")
    got = list(PrefetchPipeline(lambda: iter(batches), feeder=feeder,
                                depth=2))
    want = [feeder(b) for b in batches]
    jgot = list(JPipeline(lambda: iter(batches),
                          feeder=JFeeder(_feeding(jtypes), pad_multiple=4),
                          depth=2))
    assert len(got) == len(want) == len(jgot) == len(batches)
    for g, w, j in zip(got, want, jgot):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k].value, w[k].value)
            np.testing.assert_array_equal(g[k].value.numpy(),
                                          np.asarray(j[k].value))
            if w[k].mask is not None:
                assert torch.equal(g[k].mask, w[k].mask)
                np.testing.assert_array_equal(g[k].mask.numpy(),
                                              np.asarray(j[k].mask))


def _trainer():
    dsl.reset()
    words = dsl.data(name="words", size=V, is_sequence=True)
    label = dsl.data(name="label", size=2)
    emb = dsl.embedding(input=words, size=6)
    proj = dsl.fc(input=emb, size=16, act="linear")
    h = dsl.pooling(input=dsl.lstmemory(input=proj), pooling_type="max")
    out = dsl.fc(input=h, size=2, act="softmax")
    cost = dsl.classification_cost(input=out, label=label)
    return SGD(cost, update_equation=Adam(learning_rate=1e-2), seed=4,
               device="cpu")


def _state(tr):
    return ({k: v.numpy() for k, v in tr.params.items()},
            _flatten(tr.opt_state))


def _assert_equal_states(a, b):
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("depth", [1, 3])
def test_async_training_is_bit_equal_to_sync(depth):
    batches = _batches()
    feeder = DataFeeder(_feeding(ttypes), pad_multiple=4, device="cpu")
    sync = _trainer()
    sync.train(lambda: iter(batches), feeder=feeder, num_passes=2)
    async_ = _trainer()
    async_.train(lambda: iter(batches), feeder=feeder, num_passes=2,
                 async_load_data=True, prefetch_depth=depth)
    _assert_equal_states(_state(async_), _state(sync))
    assert len(async_.data_wait_seconds) == 2 * len(batches)
    pre = _trainer()
    reader = prefetch_reader(lambda: iter(batches), feeder=feeder,
                             depth=depth)
    assert reader.is_prefetched
    pre.train(reader, num_passes=2)
    _assert_equal_states(_state(pre), _state(sync))
    with pytest.raises(ValueError, match="prefetched"):
        _trainer().train(reader, feeder=feeder, num_passes=1)


def test_worker_error_surfaces_after_prepared_batches():
    batches = _batches(3)

    def reader():
        yield batches[0]
        yield batches[1]
        raise RuntimeError("bad record")

    feeder = DataFeeder(_feeding(ttypes), pad_multiple=4, device="cpu")
    pipe = PrefetchPipeline(reader, feeder=feeder, depth=2)
    it = iter(pipe)
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="bad record"):
        next(it)
    # through the trainer: the step loop sees the worker's error
    with pytest.raises(RuntimeError, match="bad record"):
        _trainer().train(reader, feeder=feeder, num_passes=1,
                         async_load_data=True)


def test_close_mid_pass_stops_the_worker():
    endless = (b for _ in iter(int, 1) for b in _batches(1))
    feeder = DataFeeder(_feeding(ttypes), pad_multiple=4, device="cpu")
    pipe = PrefetchPipeline(lambda: endless, feeder=feeder, depth=2)
    next(iter(pipe))
    pipe.close()
    assert not pipe._thread.is_alive()
    assert not [t for t in threading.enumerate()
                if t is pipe._thread and t.is_alive()]
    with pytest.raises(ValueError, match="depth"):
        PrefetchPipeline(lambda: iter(()), depth=0)
