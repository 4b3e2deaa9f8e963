"""Config-declared metric evaluators: the port of
``paddle_tpu/trainer/metrics.py``'s registry with the two evaluators the
sequence tagger declares, ``chunk`` (``ChunkEvaluator.cpp``: chunk F1) and
``sum`` (``SumEvaluator``, ``Evaluator.cpp``), and the CTC acoustic
model's ``ctc_edit_distance`` (``CTCErrorEvaluator.cpp``).

Each follows the reference's start / eval(batch) / finish protocol on the
host, over numpy arrays the trainer fetched from the device. The other
evaluator types of the JAX package are later work: building one raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import inspect
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("paddle_tpu_torch.trainer")

_EVALUATORS: Dict[str, type] = {}

# the JAX package's evaluator types (and aliases) without a port yet
NOT_PORTED = ("classification_error", "seq_classification_error", "rankauc",
              "auc", "last-column-auc", "precision_recall", "pnpair",
              "column_sum", "last-column-sum",
              "value_printer", "gradient_printer", "max_id_printer",
              "maxid_printer", "max_frame_printer",
              "classification_error_printer", "seq_text_printer",
              "detection_map")


def register_evaluator(name: str):
    def deco(cls):
        _EVALUATORS[name] = cls
        cls.type_name = name
        return cls
    return deco


class EvaluatorBase:
    """start/eval/finish protocol (``Evaluator.h``). Subclasses implement
    ``eval_batch(output, label=None, weight=None, mask=None)`` with numpy
    arrays and ``value()``."""

    type_name = "?"

    def __init__(self, name: Optional[str] = None):
        self.name = name or self.type_name
        self.start()

    def start(self):
        raise NotImplementedError

    def eval_batch(self, output, label=None, weight=None, mask=None):
        raise NotImplementedError

    def value(self) -> float:
        raise NotImplementedError


@register_evaluator("chunk")
class ChunkEvaluator(EvaluatorBase):
    """``ChunkEvaluator.cpp``: F1 over chunks decoded from tag sequences.

    With ``tag_num`` tags per scheme (IOB: B,I / IOE: I,E / IOBES:
    B,I,E,S / plain: one tag), a label is ``chunk_type * tag_num + tag``
    and the outside label is ``num_chunk_types * tag_num``.
    """

    SCHEMES = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}
    # reads the layer's decoded-ids view when it carries one
    # (crf_decoding with a label; the reference reads output_.ids)
    wants_ids = True

    def __init__(self, name=None, chunk_scheme: str = "IOB",
                 num_chunk_types: int = 1, excluded_chunk_types=()):
        if chunk_scheme not in self.SCHEMES:
            raise ValueError(f"bad chunk_scheme {chunk_scheme}")
        self.scheme = chunk_scheme
        self.tag_num = self.SCHEMES[chunk_scheme]
        self.num_chunk_types = num_chunk_types
        self.excluded = set(excluded_chunk_types)
        super().__init__(name)

    def start(self):
        self.num_label = 0.0
        self.num_output = 0.0
        self.num_correct = 0.0

    def _decode(self, t: int):
        """label id -> (tag, chunk_type), or None for the outside label."""
        other = self.num_chunk_types * self.tag_num
        if t < 0 or t >= other:
            return None
        ctype, tag = divmod(int(t), self.tag_num)
        return tag, ctype

    def _is_start(self, prev, cur):
        """Does ``cur`` begin a chunk after ``prev`` (isChunkBegin)?"""
        if cur is None:
            return False
        tag, ctype = cur
        if self.scheme == "plain":
            return True
        if prev is None or prev[1] != ctype:
            return True
        if self.scheme == "IOB":
            return tag == 0                       # B
        if self.scheme == "IOE":
            return prev[0] == 1                   # previous was E
        # IOBES: B=0, I=1, E=2, S=3
        return tag in (0, 3) or prev[0] in (2, 3)

    def _is_end(self, cur, nxt):
        """Does ``cur`` end its chunk before ``nxt`` (isChunkEnd)?"""
        if cur is None:
            return False
        tag, ctype = cur
        if self.scheme == "plain":
            return True
        if nxt is None or nxt[1] != ctype:
            return True
        if self.scheme == "IOB":
            return nxt[0] == 0                    # next is B
        if self.scheme == "IOE":
            return tag == 1                       # E
        return tag in (2, 3) or nxt[0] in (0, 3)  # IOBES

    def _segments(self, tags: Sequence[int]):
        """(begin, end, type) chunks (getSegments)."""
        decoded = [self._decode(t) for t in tags]
        out = []
        start = None
        for i, cur in enumerate(decoded):
            prev = decoded[i - 1] if i > 0 else None
            nxt = decoded[i + 1] if i + 1 < len(decoded) else None
            if self._is_start(prev, cur):
                start = i
            if cur is not None and start is None:
                start = i  # tolerate a malformed prediction (I without B)
            if self._is_end(cur, nxt) and start is not None:
                out.append((start, i, cur[1]))
                start = None
            if cur is None:
                start = None
        return [(b, e, c) for (b, e, c) in out if c not in self.excluded]

    def eval_batch(self, output, label=None, weight=None, mask=None):
        """output: predicted tag ids [B, T] (or [B, T, 1]); label the
        same; mask [B, T] marks each row's real steps."""
        pred = np.asarray(output)
        lab = np.asarray(label)
        if pred.ndim == 3 and pred.shape[-1] == 1:
            pred = pred[..., 0]
        if lab.ndim == 3 and lab.shape[-1] == 1:
            lab = lab[..., 0]
        if pred.ndim == 1:
            pred, lab = pred[None], lab[None]
            mask = None if mask is None else np.asarray(mask)[None]
        for b in range(pred.shape[0]):
            n = (int(np.asarray(mask)[b].sum()) if mask is not None
                 else pred.shape[1])
            p_chunks = set(self._segments(pred[b, :n].tolist()))
            l_chunks = set(self._segments(lab[b, :n].tolist()))
            self.num_output += len(p_chunks)
            self.num_label += len(l_chunks)
            self.num_correct += len(p_chunks & l_chunks)

    def value(self):
        p = self.num_correct / max(self.num_output, 1e-12)
        r = self.num_correct / max(self.num_label, 1e-12)
        return 2 * p * r / max(p + r, 1e-12)


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance (the core of ``CTCErrorEvaluator.cpp``)."""
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, np.int64)
        cur[0] = i
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return int(prev[lb])


def ctc_best_path(log_probs: np.ndarray, blank: int) -> List[int]:
    """Greedy best-path decoding: argmax per frame, collapse repeats,
    drop blanks."""
    out: List[int] = []
    prev = -1
    for t in np.argmax(log_probs, axis=-1).tolist():
        if t != prev and t != blank:
            out.append(t)
        prev = t
    return out


@register_evaluator("ctc_edit_distance")
class CTCErrorEvaluator(EvaluatorBase):
    """``CTCErrorEvaluator.cpp``: the edit distance between the best-path
    decode of the frame scores and the label sequence, over the summed
    reference lengths. The trainer passes the output's frame mask and the
    label, not the label's mask (as the JAX trainer wires it), so a padded
    label row's tail counts as reference tokens; ``label_mask`` is read
    where a caller gives it."""

    def __init__(self, name=None, blank: Optional[int] = None):
        self.blank = blank
        super().__init__(name)

    def start(self):
        self.total_dist = 0.0
        self.total_len = 0.0
        self.seqs = 0

    def eval_batch(self, output, label=None, weight=None, mask=None,
                   label_mask=None):
        """output: [B, T, C] frame scores; label: [B, L] int ids."""
        out = np.asarray(output)
        lab = np.asarray(label)
        if out.ndim == 2:
            out, lab = out[None], lab[None]
        blank = self.blank if self.blank is not None else out.shape[-1] - 1
        for b in range(out.shape[0]):
            T = (int(np.asarray(mask)[b].sum()) if mask is not None
                 else out.shape[1])
            L = (int(np.asarray(label_mask)[b].sum())
                 if label_mask is not None else lab.shape[1])
            hyp = ctc_best_path(out[b, :T], blank)
            ref = [int(x) for x in lab[b, :L]]
            self.total_dist += edit_distance(hyp, ref)
            self.total_len += max(len(ref), 1)
            self.seqs += 1

    def value(self):
        return self.total_dist / max(self.total_len, 1e-12)


@register_evaluator("sum")
class SumEvaluator(EvaluatorBase):
    """The mean of an output over the rows (or the real steps of a
    sequence): with ``crf_decoding``'s error indicator, the share of
    sequences decoded wrong."""

    def start(self):
        self.total = 0.0
        self.count = 0.0

    def eval_batch(self, output, label=None, weight=None, mask=None):
        out = np.asarray(output, np.float64)
        if mask is not None:
            out = out * np.asarray(mask)[..., None]
        if weight is not None:
            w = np.asarray(weight, np.float64).reshape(
                (-1,) + (1,) * (out.ndim - 1))
            out = out * w
        self.total += float(out.sum())
        self.count += (float(np.asarray(mask).sum()) if mask is not None
                       else out.shape[0])

    def value(self):
        return self.total / max(self.count, 1.0)


def build_from_configs(configs: Sequence[dict]):
    """EvaluatorConfig-shaped dicts (``ModelDef.evaluators``, as
    ``dsl.evaluator`` records them) -> [(evaluator, input_layer_names,
    roles)]. ``roles`` says how many leading inputs are outputs and whether
    a label and a weight follow. A type the JAX package has but the port
    does not yet raises ``NotImplementedError``; an unknown type is skipped
    with a warning, as in the JAX package."""
    built = []
    for cfg in configs or []:
        tname = cfg.get("type")
        if tname in NOT_PORTED:
            raise NotImplementedError(
                f"evaluator type {tname!r} is not ported yet; "
                f"paddle_tpu_torch has {sorted(_EVALUATORS)}")
        cls = _EVALUATORS.get(tname)
        if cls is None:
            logger.warning("evaluator type %r not supported; skipping",
                           tname)
            continue
        accepted = set(inspect.signature(cls.__init__).parameters)
        kwargs = {k: v for k, v in cfg.items()
                  if k in accepted and k not in ("input_layers", "type")}
        built.append((cls(**kwargs), list(cfg.get("input_layers", [])),
                      cfg["_roles"]))
    return built
