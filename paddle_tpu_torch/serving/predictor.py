"""Bucketed predictor over a deploy model — the score and generate paths
of ``paddle_tpu/serving/predictor.py``.

The deploy artifact is the merged model (``trainer/merge_model.py``, a
PTM1 file from either package), or any live (graph, params) pair. Batch
sizes come from ``batch_buckets`` and padded sequence lengths from
``length_buckets``: a closed menu, warmed before the first request. A
sequence longer than the largest edge is inadmissible (typed
``BadRequest``). The forward runs eagerly on ``device``; on ``cuda`` its
LSTM layers launch the hand-written recurrence kernel and a CRF decode
its Viterbi kernel. Outputs come back as the layers give them: a decode's
int32 ids [B, T, 1] over the padded batch and length bucket, as the JAX
predictor returns them.

A generating config (a ``beam_search`` group among the outputs) is served
by ``generate_rows``: the encoder network over the bucketed batch, then
``core/generation.py:SequenceGenerator`` (its step's GRU or LSTM cell
launches its kernel on the card). Serving pins one (beam_size,
max_length) pair, the config's unless the caller gives others; any other
pair is a typed 400 that carries the menu (``allowed``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.core.generation import (SequenceGenerator,
                                              generation_params)
from paddle_tpu_torch.core.network import Network
from paddle_tpu_torch.data import types as T
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.serving.errors import BadRequest


def _is_seq(itype) -> bool:
    return itype.seq_type != T.NO_SEQUENCE


def _synth_sample(itype, length: int):
    """An all-zeros sample for one slot at padded length ``length``,
    shaped like real traffic."""
    if itype.seq_type == T.NO_SEQUENCE:
        if itype.type == T.INDEX:
            return 0
        return np.zeros(itype.dim, dtype=np.float32)
    if itype.type == T.INDEX:
        return [0] * length
    return [np.zeros(itype.dim, dtype=np.float32) for _ in range(length)]


class ServingPredictor:
    """Loads a model; scores bucketed batches and, for a generating
    config, beam-searches them."""

    def __init__(self, graph, params: Dict[str, Any],
                 output_names: Sequence[str],
                 feeding: Dict[str, Any], *,
                 batch_buckets: Sequence[int],
                 length_buckets: Optional[Sequence[int]] = None,
                 model_hash: Optional[str] = None,
                 gen_decode_chunk: Optional[int] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.graph = graph
        self.model_hash = str(model_hash) if model_hash else None
        self.model_version = (self.model_hash[:12] if self.model_hash
                              else None)
        self.feeding = dict(feeding)
        self.names = list(self.feeding)
        self.batch_buckets = sorted(int(b) for b in batch_buckets)
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(f"bad batch_buckets: {batch_buckets}")
        nested = [n for n, t in self.feeding.items()
                  if t.seq_type == T.SUB_SEQUENCE]
        if nested:
            # the outer sub-sequence count is a shape axis the bucket menu
            # does not close: refuse at build time
            raise ValueError(
                f"serving does not support nested-sequence (SUB_SEQUENCE)"
                f" inputs yet: {nested} — the outer subsequence count is"
                " an unbucketed shape axis")
        self.has_sequences = any(_is_seq(t) for t in self.feeding.values())
        self.length_buckets = (sorted(int(e) for e in length_buckets)
                               if length_buckets and self.has_sequences
                               else None)
        if self.has_sequences and not self.length_buckets:
            raise ValueError(
                "this model has sequence inputs; serving needs non-empty "
                "length_buckets (--serving_length_buckets) so the shape "
                "menu is closed")
        self.max_seq_len = (self.length_buckets[-1]
                            if self.length_buckets else None)
        # id validation on: an out-of-range id is a loud per-lane
        # BadRequest, not a silent zero-row lookup. One shared length
        # bucket per batch keeps the menu the bucket list.
        self.feeder = DataFeeder(
            self.feeding, batch_buckets=self.batch_buckets,
            length_buckets=self.length_buckets, validate_ids=True,
            shared_length_bucket=True, device=self.device)
        self.output_names = [o.name if hasattr(o, "name") else o
                             for o in output_names]
        # the generation group (if any) is served by the beam search, not
        # the plain forward: the score outputs exclude it
        self._gen_name = next(
            (n for n, l in graph.layers.items()
             if l.type == "beam_search_group"), None)
        score_outputs = [n for n in self.output_names
                         if n != self._gen_name]
        # every parameter the served paths read must be in the table
        needed = Network(graph, outputs=score_outputs + (
            [self._gen_name] if self._gen_name else []))
        self.params = params_from_numpy(params, self.device, needed)
        self.network = (needed if self._gen_name is None
                        else Network(graph, outputs=score_outputs)
                        if score_outputs else None)
        for name, shape in generation_params(graph).items():
            if tuple(np.shape(params.get(name, ()))) != tuple(shape):
                raise KeyError(f"generation parameter {name!r} missing or "
                               f"not of shape {tuple(shape)}")
        self.engine = None
        if self._gen_name is not None:
            self.engine = SequenceGenerator(graph, self._gen_name)
            attrs = self.engine.cfg.attrs
            self.gen_beam_size = int(attrs.get("beam_size", 1))
            self.gen_max_length = int(attrs.get("max_length", 100))
            # None = the config's pinned policy; the engine reads the rest
            self.gen_decode_chunk = gen_decode_chunk
            self.encoder = Network(
                graph, outputs=self.engine.static_input_layers())
        self.warmed = False

    @classmethod
    def from_merged(cls, path: str, feeding: Dict[str, Any],
                    **kwargs) -> "ServingPredictor":
        """Build from a PTM1 merged model (either package's). ``feeding``
        comes from the config; the payload digest becomes the model
        hash."""
        from paddle_tpu_torch.trainer.merge_model import (load_merged_ex,
                                                          merged_digest)
        graph, params, outputs, extras = load_merged_ex(path)
        if extras:
            raise ValueError(
                f"{path}: quantized merged models ({sorted(extras)} "
                "sections) are not served by paddle_tpu_torch yet; merge "
                "without --quantize")
        kwargs.setdefault("model_hash", merged_digest(path))
        return cls(graph, params, outputs, feeding, **kwargs)

    # ------------------------------------------------------------- warmup
    def warmup(self, log=None) -> int:
        """Run every (batch, length) bucket once ahead of traffic (builds
        the kernels and the library handles); returns the number of
        runs."""
        t0 = time.perf_counter()
        runs = 0
        for b in self.batch_buckets:
            lengths = self.length_buckets or [1]
            for ln in lengths:
                row = tuple(_synth_sample(self.feeding[n], ln)
                            for n in self.names)
                if self.network is not None:
                    self.predict_rows([row] * b)
                    runs += 1
                if self.engine is not None and ln == lengths[0]:
                    # the pinned (beam_size, max_length), once per batch
                    # bucket: the search's shapes follow the batch
                    self.generate_rows([row] * b)
                    runs += 1
        self.warmed = True
        if log:
            log(f"serving warmup: {runs} bucket variants ready in "
                f"{time.perf_counter() - t0:.1f}s "
                f"(batch={self.batch_buckets}, "
                f"length={self.length_buckets})")
        return runs

    # --------------------------------------------------------- admission
    def check_sample(self, sample):
        """Cheap host-side admissibility check at enqueue time. Raises
        ``BadRequest``; value types are checked per lane at batch time."""
        if not isinstance(sample, (list, tuple)):
            raise BadRequest(
                f"sample must be a list of {len(self.names)} input "
                f"slots ({self.names}), got {type(sample).__name__}")
        if len(sample) != len(self.names):
            raise BadRequest(
                f"sample has {len(sample)} slots, the model needs "
                f"{len(self.names)} ({self.names})")
        for name, slot in zip(self.names, sample):
            if not _is_seq(self.feeding[name]):
                continue
            if not isinstance(slot, (list, tuple, np.ndarray)):
                raise BadRequest(
                    f"input {name!r} is a sequence slot; got "
                    f"{type(slot).__name__}")
            if self.max_seq_len is not None and len(slot) > self.max_seq_len:
                raise BadRequest(
                    f"input {name!r} has length {len(slot)}, beyond the "
                    f"largest warmed length bucket {self.max_seq_len}; "
                    "serving shapes are a closed menu")

    def padding_row(self) -> tuple:
        """A synthetic all-padding row; the batcher swaps it in for a
        malformed lane."""
        return tuple(_synth_sample(self.feeding[n], 1) for n in self.names)

    def probe_rows(self, rows) -> List[Optional[Exception]]:
        """Per-lane conversion probe after a whole-batch conversion
        failed: converts each row alone (padded to the smallest batch
        bucket) and returns its exception, or None when clean."""
        pad = [self.padding_row()] * (self.batch_buckets[0] - 1)
        out: List[Optional[Exception]] = []
        for row in rows:
            try:
                self.feeder([tuple(row)] + pad)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — typed by the caller
                out.append(e)
        return out

    # ------------------------------------------------------------ scoring
    def _bucket_key(self, feed) -> Tuple[str, int]:
        """(bucket label, padded row count) of a converted feed."""
        padded = int(feed[self.names[0]].value.shape[0])
        key = f"b{padded}"
        for n in self.names:
            if _is_seq(self.feeding[n]):
                key += f"_t{int(feed[n].value.shape[1])}"
                break
        return key, padded

    def predict_rows(self, rows: List[tuple]):
        """Score a bucketed batch. Returns ``(outs, info)``: ``outs`` maps
        output layer name -> np array over the PADDED batch (the caller
        slices real lanes); ``info`` carries ``{bucket, padded_rows,
        pad_ms, compute_ms}``."""
        if self.network is None:
            raise BadRequest("this model has no scoring outputs "
                             "(generation-only config)")
        t0 = time.perf_counter()
        feed = self.feeder(list(rows))
        key, padded = self._bucket_key(feed)
        t1 = time.perf_counter()
        with torch.inference_mode():
            outs = self.network.apply(self.params, feed, train=False)
            out = {n: outs[n].value.cpu().numpy()
                   for n in self.output_names}  # waits for the device
        t2 = time.perf_counter()
        return out, {"bucket": key, "padded_rows": padded,
                     "pad_ms": (t1 - t0) * 1e3,
                     "compute_ms": (t2 - t1) * 1e3}

    # --------------------------------------------------------- generation
    def gen_allowed_menu(self) -> dict:
        """The warmed generation options, carried in closed-menu 400s so
        clients can correct themselves."""
        return {"beam_size": [self.gen_beam_size],
                "max_length": [self.gen_max_length]}

    def check_gen_opts(self, beam_size=None, max_length=None):
        """Serving pins one (beam_size, max_length) pair; any other is
        inadmissible: the 400 names the rejected value and carries the
        menu (``allowed``)."""
        if self.engine is None:
            raise BadRequest("this model has no generation group")
        if beam_size is not None and int(beam_size) != self.gen_beam_size:
            raise BadRequest(
                f"beam_size={beam_size} is not the warmed value "
                f"{self.gen_beam_size} (closed shape menu)",
                allowed=self.gen_allowed_menu())
        if (max_length is not None
                and int(max_length) != self.gen_max_length):
            raise BadRequest(
                f"max_length={max_length} is not the warmed value "
                f"{self.gen_max_length} (closed shape menu)",
                allowed=self.gen_allowed_menu())

    def encode_rows(self, rows: List[tuple]):
        """The encoder alone over a bucketed batch: outer layer name ->
        Argument over the padded batch."""
        if self.engine is None:
            raise BadRequest("this model has no generation group")
        feed = self.feeder(list(rows))
        with torch.inference_mode():
            return self.encoder.apply(self.params, feed, train=False)

    def generate_rows(self, rows: List[tuple]):
        """Beam-search a bucketed batch of encoder inputs. Returns
        ``((tokens, scores, lengths), info)``, each np [B, K, ...] over the
        padded batch; config-pinned hooks apply. ``info`` carries
        ``{bucket, padded_rows, pad_ms, compute_ms, decode_steps,
        steps_saved}``."""
        if self.engine is None:
            raise BadRequest("this model has no generation group")
        t0 = time.perf_counter()
        feed = self.feeder(list(rows))
        key, padded = self._bucket_key(feed)
        t1 = time.perf_counter()
        with torch.inference_mode():
            outer = self.encoder.apply(self.params, feed, train=False)
            out = self.engine.generate(
                self.params, outer, beam_size=self.gen_beam_size,
                max_length=self.gen_max_length,
                decode_chunk=self.gen_decode_chunk)
            tokens, scores, lengths = (t.cpu().numpy() for t in out)
        t2 = time.perf_counter()
        info = self.engine.last_info
        return (tokens, scores, lengths), {
            "bucket": key + f"_k{self.gen_beam_size}",
            "padded_rows": padded,
            "pad_ms": (t1 - t0) * 1e3,
            "compute_ms": (t2 - t1) * 1e3,
            "decode_steps": info.get("decode_steps"),
            "steps_saved": info.get("steps_saved")}
