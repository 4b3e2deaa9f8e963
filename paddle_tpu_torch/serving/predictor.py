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
pair is a typed 400 that carries the menu (``allowed``). ``build_session``
gives the continuous batcher a warmed ``DecodeSession``, or stands down
(a warning and None) where lanes cannot hold the model's static inputs
or the decode policy is the full scan.

**Quantized tier.** A ``--quantize`` PTM1 file loads with its weights in
their storage dtype on the device (int8 as ``torch.int8`` with f32
scales, bf16 as ``torch.bfloat16``; ``compat/from_jax.py:
quantized_params_from_numpy``), read by the score forward, the encoder
and the beam search's step through ``quant.materialize``'s lazy view,
which dequantizes a layer's leaves when the layer runs: no f32 copy of
the whole model is resident. ``model_version`` carries ``+bf16`` /
``+int8``. At the end of ``warmup`` the file's golden rows replay through
the real bucketed path against their recorded fp32 outputs
(``_run_quant_gate``): past the per-dtype tolerance the predictor raises
``QuantGateError`` and never reports warmed; a generation-only config has
no golden rows and the gate stands down with a named warning.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import quant as quant_lib
from paddle_tpu_torch.compat.from_jax import (params_from_numpy,
                                              quantized_params_from_numpy)
from paddle_tpu_torch.core.generation import (SequenceGenerator,
                                              generation_params)
from paddle_tpu_torch.core.network import Network
from paddle_tpu_torch.data import types as T
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.serving.errors import BadRequest, QuantGateError
from paddle_tpu_torch.utils.masks import assert_feed_masks_f32

logger = logging.getLogger("paddle_tpu_torch.serving")


def _is_seq(itype) -> bool:
    return itype.seq_type != T.NO_SEQUENCE


def _synth_sample(itype, length: int):
    """An all-zeros sample for one slot at padded length ``length``,
    shaped like real traffic."""
    if itype.seq_type == T.NO_SEQUENCE:
        if itype.type == T.INDEX:
            return 0
        if itype.type in (T.SPARSE_BINARY, T.SPARSE_FLOAT):
            return []
        return np.zeros(itype.dim, dtype=np.float32)
    if itype.type == T.INDEX:
        return [0] * length
    if itype.type in (T.SPARSE_BINARY, T.SPARSE_FLOAT):
        return [[] for _ in range(length)]
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
                 gen_full_scan: Optional[bool] = None,
                 quant: Optional[Dict[str, Any]] = None,
                 golden: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.graph = graph
        self.model_hash = str(model_hash) if model_hash else None
        self.model_version = (self.model_hash[:12] if self.model_hash
                              else None)
        # the precision tier: its dtype is part of the published version
        self.quant = dict(quant) if quant else None
        self.golden = golden
        self.quant_gate: Optional[Dict[str, Any]] = None
        if self.quant and self.model_version is not None:
            self.model_version += "+" + str(self.quant["dtype"])
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
        self.score_outputs = score_outputs
        # every parameter the served paths read must be in the table
        needed = Network(graph, outputs=score_outputs + (
            [self._gen_name] if self._gen_name else []))
        # a quantized model's params stay in their storage dtype; every
        # forward reads them through the lazy view (_view)
        self.params = (quantized_params_from_numpy(params, self.quant,
                                                   self.device, needed)
                       if self.quant
                       else params_from_numpy(params, self.device, needed))
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
            if self.quant:
                # the step reads its params through the view, one layer
                # at a time
                self.engine._param_view = self._view
            self.gen_beam_size = int(attrs.get("beam_size", 1))
            self.gen_max_length = int(attrs.get("max_length", 100))
            # None = the config's pinned policy; a chunk <= 0 is the full
            # scan; the engine reads the rest
            if gen_decode_chunk is not None and int(gen_decode_chunk) <= 0:
                gen_full_scan, gen_decode_chunk = True, None
            self.gen_full_scan = gen_full_scan
            self.gen_decode_chunk = (int(gen_decode_chunk)
                                     if gen_decode_chunk else None)
            self.encoder = Network(
                graph, outputs=self.engine.static_input_layers())
        self.warmed = False

    @classmethod
    def from_merged(cls, path: str, feeding: Dict[str, Any],
                    **kwargs) -> "ServingPredictor":
        """Build from a PTM1 merged model (either package's). ``feeding``
        comes from the config; the payload digest becomes the model
        hash. A quantized file's ``quant`` and ``golden`` sections pass
        through: the storage-dtype load and the warmup gate."""
        from paddle_tpu_torch.trainer.merge_model import (load_merged_ex,
                                                          merged_digest)
        graph, params, outputs, extras = load_merged_ex(path)
        kwargs.setdefault("model_hash", merged_digest(path))
        kwargs.setdefault("quant", extras.get("quant"))
        kwargs.setdefault("golden", extras.get("golden"))
        return cls(graph, params, outputs, feeding, **kwargs)

    def _view(self, params):
        """The f32 view of a params table: the lazy dequantizing view
        for a quantized model, the table itself otherwise."""
        return quant_lib.materialize(params) if self.quant else params

    def param_bytes(self) -> int:
        """Bytes of the parameters resident on the device (storage
        dtype, scales included)."""
        return sum(t.numel() * t.element_size()
                   for t in self.params.values())

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
        # a quantized model must pass the accuracy gate before it reports
        # warmed: a drifted one raises here
        self._run_quant_gate(log)
        self.warmed = True
        if log:
            log(f"serving warmup: {runs} bucket variants ready in "
                f"{time.perf_counter() - t0:.1f}s "
                f"(batch={self.batch_buckets}, "
                f"length={self.length_buckets})")
        return runs

    # ------------------------------------------------------- quant gate
    def quant_health(self) -> Dict[str, Any]:
        """The precision tier and the gate's verdict, as ``/healthz``
        publishes them."""
        return {"dtype": (self.quant["dtype"] if self.quant else "fp32"),
                "gate": self.quant_gate}

    def _run_quant_gate(self, log=None):
        """Replay the file's golden rows through the real bucketed score
        path and compare each output with its recorded fp32 reference.
        Raises ``QuantGateError`` past the per-dtype tolerance and records
        the verdict either way; without usable golden rows (a
        generation-only config) the gate stands down with a named
        warning."""
        if not self.quant:
            return
        dtype = str(self.quant["dtype"])
        tol = float(self.quant.get("tol", quant_lib.GATE_TOLERANCES[dtype]))
        golden = self.golden
        if self.network is None or not golden or not golden.get("rows"):
            reason = ("no scoring outputs (generation-only config)"
                      if self.network is None
                      else "artifact carries no golden section")
            self.quant_gate = {"checked": False, "dtype": dtype,
                               "tol": tol, "reason": reason}
            logger.warning(
                "quantized model %s: warmup accuracy gate STOOD DOWN "
                "(%s) — serving %s weights unverified",
                self.model_version, reason, dtype)
            return
        rows = [tuple(r) for r in golden["rows"]]
        refs = golden["outputs"]
        bmax = self.batch_buckets[-1]
        deltas: Dict[str, float] = {n: 0.0 for n in refs}
        try:
            for i in range(0, len(rows), bmax):
                chunk = rows[i:i + bmax]
                outs, _info = self.predict_rows(chunk)
                for name, ref in refs.items():
                    d = quant_lib.gate_delta(outs[name][:len(chunk)],
                                             ref[i:i + len(chunk)])
                    deltas[name] = max(deltas[name], d)
        except BadRequest as e:
            raise QuantGateError(
                f"warmup accuracy gate could not replay the golden "
                f"set through the serving menu: {e}", dtype=dtype,
                deltas={}, tol=tol) from e
        worst = max(deltas.values())
        passed = worst <= tol
        self.quant_gate = {"checked": True, "dtype": dtype, "tol": tol,
                           "max_delta": worst, "passed": passed,
                           "outputs": dict(deltas)}
        if not passed:
            raise QuantGateError(
                f"quantized model {self.model_version} drifted past "
                f"the warmup accuracy gate: max output delta "
                f"{worst:.4g} > tolerance {tol:g} for {dtype} "
                f"(per-output: {deltas}) — refusing to go READY",
                dtype=dtype, deltas=deltas, tol=tol)
        if log:
            log(f"quant gate PASSED ({dtype}): max output delta "
                f"{worst:.4g} <= tol {tol:g} over "
                f"{len(rows)} golden rows")

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

    def _feed(self, rows):
        """rows -> feed dict through the bucketing feeder, every mask it
        built checked f32 (``utils/masks.py``) before it reaches the
        network, as the JAX package's serving feed is."""
        return assert_feed_masks_f32(self.feeder(list(rows)), "serving feed")

    def predict_rows(self, rows: List[tuple]):
        """Score a bucketed batch. Returns ``(outs, info)``: ``outs`` maps
        output layer name -> np array over the PADDED batch (the caller
        slices real lanes); ``info`` carries ``{bucket, padded_rows,
        pad_ms, compute_ms}``."""
        if self.network is None:
            raise BadRequest("this model has no scoring outputs "
                             "(generation-only config)")
        t0 = time.perf_counter()
        feed = self._feed(rows)
        key, padded = self._bucket_key(feed)
        t1 = time.perf_counter()
        with torch.inference_mode():
            outs = self.network.apply(self._view(self.params), feed,
                                      train=False)
            out = {n: outs[n].value.cpu().numpy()
                   for n in self.score_outputs}  # waits for the device
        t2 = time.perf_counter()
        return out, {"bucket": key, "padded_rows": padded,
                     "pad_ms": (t1 - t0) * 1e3,
                     "compute_ms": (t2 - t1) * 1e3}

    # --------------------------------------------------------- generation
    def gen_effective_full_scan(self) -> bool:
        """The decode policy in force: the constructor's (the CLI's)
        override when given (a positive chunk asks for chunked decode),
        else the config's pinned ``full_scan``."""
        if self.gen_full_scan is not None:
            return bool(self.gen_full_scan)
        if self.gen_decode_chunk:
            return False
        return bool(self.engine.cfg.attrs.get("full_scan", False))

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
        feed = self._feed(rows)
        with torch.inference_mode():
            return self.encoder.apply(self._view(self.params), feed,
                                      train=False)

    def generate_rows(self, rows: List[tuple]):
        """Beam-search a bucketed batch of encoder inputs. Returns
        ``((tokens, scores, lengths), info)``, each np [B, K, ...] over the
        padded batch; config-pinned hooks apply. ``info`` carries
        ``{bucket, padded_rows, pad_ms, compute_ms, decode_steps,
        steps_saved}``."""
        if self.engine is None:
            raise BadRequest("this model has no generation group")
        t0 = time.perf_counter()
        feed = self._feed(rows)
        key, padded = self._bucket_key(feed)
        t1 = time.perf_counter()
        with torch.inference_mode():
            outer = self.encoder.apply(self._view(self.params), feed,
                                       train=False)
            out = self.engine.generate(
                self.params, outer, beam_size=self.gen_beam_size,
                max_length=self.gen_max_length,
                decode_chunk=self.gen_decode_chunk,
                full_scan=self.gen_full_scan)
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

    def build_session(self, width: int):
        """A warmed continuous-batching ``DecodeSession`` of ``width``
        lanes: it admits one synthetic request, runs one chunk, polls,
        peeks and releases it. The engine calls this from ``start()``
        when ``continuous_batching`` is on.

        Returns None, with a warning (the engine then serves convoy
        batching), when the model's static or boot inputs change shape
        across the length buckets (a sequence-valued static input, such
        as seq2seq's encoded source, pads to its request's bucket, but a
        session's lanes have one shape), or when the decode policy is the
        full scan (no chunk boundaries to admit and retire at)."""
        if self.engine is None:
            raise BadRequest("this model has no generation group")
        outers, shapes = [], set()
        for warm_len in (self.length_buckets or [1]):
            row = tuple(_synth_sample(self.feeding[n], warm_len)
                        for n in self.names)
            outer = self.encode_rows([row])
            feed = self.engine.static_feed_from_outer(outer, row=0)
            shapes.add(tuple(sorted(
                (b, tuple(a.value.shape[1:]),
                 None if a.mask is None else tuple(a.mask.shape[1:]))
                for b, a in feed.items())))
            outers.append(outer)
        if len(shapes) > 1:
            logger.warning(
                "continuous batching stood down: this model's "
                "static/boot generation inputs change shape across the "
                "%d warmed length buckets (a sequence-valued "
                "StaticInput pads per bucket), but a decode session's "
                "lane buffers have one fixed shape. Serving falls back "
                "to convoy batching; use a single "
                "--serving_length_buckets entry to enable continuous "
                "batching for this model.", len(self.length_buckets))
            return None
        if self.gen_effective_full_scan():
            logger.warning(
                "continuous batching stood down: the decode policy is "
                "full_scan (--decode_chunk 0, or pinned in the config) "
                "and a full-length scan has no chunk boundaries to "
                "admit/retire at. Serving falls back to convoy "
                "batching; drop the full-scan override to enable "
                "continuous batching.")
            return None
        sess = self.engine.session(
            self.params, width, beam_size=self.gen_beam_size,
            max_length=self.gen_max_length,
            decode_chunk=self.gen_decode_chunk)
        sess.admit(0, outers[0], row=0)
        sess.run_chunk()
        sess.poll()
        sess.peek(0)
        sess.release(0)
        return sess
