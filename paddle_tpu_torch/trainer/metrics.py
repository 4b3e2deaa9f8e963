"""Config-declared metric evaluators: the port of
``paddle_tpu/trainer/metrics.py``, the ``gserver/evaluators`` family
(``Evaluator.{h,cpp}``, ``ChunkEvaluator.cpp``, ``CTCErrorEvaluator.cpp``,
``DetectionMAPEvaluator.cpp``): classification error (per frame and per
sequence), the AUCs (bucketed and ranking), precision/recall, pnpair,
chunk F1, CTC edit distance, sum and column sum, the printers and
detection mAP.

Each follows the reference's start / eval(batch) / value protocol on the
host, over numpy arrays the trainer fetched from the device. An unknown
type is skipped with a warning, as in the JAX package.
"""

from __future__ import annotations

import inspect
import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("paddle_tpu_torch.trainer")

_EVALUATORS: Dict[str, type] = {}

# evaluator types of the JAX package without a port: none
NOT_PORTED = ()


def register_evaluator(name: str):
    def deco(cls):
        _EVALUATORS[name] = cls
        cls.type_name = name
        return cls
    return deco


class EvaluatorBase:
    """start/eval/value protocol (``Evaluator.h``). Subclasses implement
    ``eval_batch(output, label=None, weight=None, mask=None)`` with numpy
    arrays and ``value()``."""

    type_name = "?"
    # printers: value() prints, so the trainer reads them once a pass
    prints_on_value = False

    def __init__(self, name: Optional[str] = None):
        self.name = name or self.type_name
        self.start()

    def start(self):
        raise NotImplementedError

    def eval_batch(self, output, label=None, weight=None, mask=None):
        raise NotImplementedError

    def value(self) -> float:
        raise NotImplementedError


def _align_label(label, out_T):
    """Trim/pad a feeder-padded label sequence to the output's padded
    length (positions align semantically; masks carry truth)."""
    label = np.asarray(label)
    if label.ndim >= 2 and label.shape[1] != out_T:
        if label.shape[1] > out_T:
            return label[:, :out_T]
        pad = [(0, 0), (0, out_T - label.shape[1])] + \
            [(0, 0)] * (label.ndim - 2)
        return np.pad(label, pad)
    return label


@register_evaluator("classification_error")
class ClassificationErrorEvaluator(EvaluatorBase):
    """``ClassificationErrorEvaluator`` — fraction argmax(output) != label;
    honors sample weights and sequence masks."""

    def __init__(self, name=None, top_k: int = 1):
        self.top_k = top_k
        super().__init__(name)

    def start(self):
        self.wrong = 0.0
        self.count = 0.0

    def eval_batch(self, output, label=None, weight=None, mask=None):
        output = np.asarray(output)
        label = np.asarray(label)
        if output.ndim >= 3:
            label = _align_label(label, output.shape[1])
        if self.top_k == 1:
            hit = np.argmax(output, axis=-1) == label
        else:
            topk = np.argsort(-output, axis=-1)[..., :self.top_k]
            hit = (topk == label[..., None]).any(axis=-1)
        wrong = (~hit).astype(np.float64)
        w = np.ones_like(wrong) if weight is None else np.asarray(weight)
        if mask is not None:
            w = w * np.asarray(mask)
        self.wrong += float((wrong * w).sum())
        self.count += float(w.sum())

    def value(self):
        return self.wrong / max(self.count, 1.0)


@register_evaluator("seq_classification_error")
class SeqClassificationErrorEvaluator(ClassificationErrorEvaluator):
    """``SequenceClassificationErrorEvaluator`` (``Evaluator.cpp:172``):
    sequence-level error — if ANY frame of a sequence is wrong, the whole
    sequence counts as one error; the denominator is the number of
    sequences."""

    def eval_batch(self, output, label=None, weight=None, mask=None):
        output = np.asarray(output)
        label = np.asarray(label)
        if self.top_k == 1:
            hit = np.argmax(output, axis=-1) == label
        else:
            topk = np.argsort(-output, axis=-1)[..., :self.top_k]
            hit = (topk == label[..., None]).any(axis=-1)
        wrong = (~hit).astype(np.float64)
        if mask is not None:
            wrong = wrong * np.asarray(mask)
        # [B, T] frame errors -> per-sequence any()
        seq_wrong = (wrong.reshape(wrong.shape[0], -1).sum(axis=-1) > 0)
        self.wrong += float(seq_wrong.sum())
        self.count += float(wrong.shape[0])


@register_evaluator("rankauc")
class RankAucEvaluator(EvaluatorBase):
    """``RankAucEvaluator`` (``Evaluator.cpp:503``): per-sequence ranking
    AUC over (score, click, pageview) triples; value is the mean
    per-sequence AUC. The tie-handling trapezoid walk mirrors
    ``calcRankAuc`` exactly."""

    def start(self):
        self.total = 0.0
        self.n_seq = 0.0

    @staticmethod
    def _calc(score, click, pv):
        order = np.argsort(-score, kind="stable")
        auc = click_sum = old_click_sum = 0.0
        no_click = no_click_sum = 0.0
        last = float(score[order[0]]) + 1.0
        for i in order:
            s = float(score[i])
            if last != s:
                auc += (click_sum + old_click_sum) * no_click / 2.0
                old_click_sum = click_sum
                no_click = 0.0
                last = s
            no_click += float(pv[i]) - float(click[i])
            no_click_sum += no_click
            click_sum += float(click[i])
        auc += (click_sum + old_click_sum) * no_click / 2.0
        denom = click_sum * no_click_sum
        return 0.0 if denom == 0.0 else auc / denom

    def eval_batch(self, output, label=None, weight=None, mask=None):
        # inputs: output scores, click (label), optional pv (weight)
        score = np.asarray(output)
        if score.ndim == 3:
            score = score[..., 0]
        click = np.asarray(label).reshape(score.shape)
        pv = (np.ones_like(score) if weight is None
              else np.asarray(weight).reshape(score.shape))
        if score.ndim == 1:
            score, click, pv = score[None], click[None], pv[None]
        for b in range(score.shape[0]):
            n = int(np.asarray(mask)[b].sum()) if mask is not None \
                else score.shape[1]
            if n <= 0:
                continue
            self.total += self._calc(score[b, :n], click[b, :n], pv[b, :n])
            self.n_seq += 1.0

    def value(self):
        return self.total / max(self.n_seq, 1.0)


@register_evaluator("auc")
class AucEvaluator(EvaluatorBase):
    """``AucEvaluator`` (Evaluator.h:252): bucketed ROC-AUC. The reference
    histograms P(positive) into fixed bins (statPos_/statNeg_) and
    integrates by trapezoid; identical scheme here with ``num_bins``."""

    def __init__(self, name=None, num_bins: int = 4096, column: int = -1):
        self.num_bins = num_bins
        self.column = column
        super().__init__(name)

    def start(self):
        self.stat_pos = np.zeros(self.num_bins, np.float64)
        self.stat_neg = np.zeros(self.num_bins, np.float64)

    def eval_batch(self, output, label=None, weight=None, mask=None):
        output = np.asarray(output)
        if output.ndim > 1:
            col = self.column if self.column >= 0 else output.shape[-1] - 1
            score = output[..., col]
        else:
            score = output
        score = score.reshape(-1)
        label = np.asarray(label).reshape(-1)
        w = (np.ones_like(score, np.float64) if weight is None
             else np.asarray(weight, np.float64).reshape(-1))
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            score, label, w = score[keep], label[keep], w[keep]
        idx = np.clip((score * self.num_bins).astype(np.int64),
                      0, self.num_bins - 1)
        np.add.at(self.stat_pos, idx[label > 0], w[label > 0])
        np.add.at(self.stat_neg, idx[label <= 0], w[label <= 0])

    def value(self):
        # walk bins from high score to low, trapezoid over (FP, TP) curve —
        # same calcAuc as the reference.
        tot_pos = self.stat_pos.sum()
        tot_neg = self.stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.5
        tp = np.cumsum(self.stat_pos[::-1])
        fp = np.cumsum(self.stat_neg[::-1])
        tpr = np.concatenate([[0.0], tp / tot_pos])
        fpr = np.concatenate([[0.0], fp / tot_neg])
        trapz = getattr(np, "trapezoid", np.trapz)
        return float(trapz(tpr, fpr))


@register_evaluator("precision_recall")
class PrecisionRecallEvaluator(EvaluatorBase):
    """``PrecisionRecallEvaluator``: per-class TP/FP/FN with macro-averaged
    precision/recall/F1; ``positive_label`` selects single-class mode as in
    the reference config."""

    def __init__(self, name=None, positive_label: int = -1):
        self.positive_label = positive_label
        super().__init__(name)

    def start(self):
        self.tp: Dict[int, float] = {}
        self.fp: Dict[int, float] = {}
        self.fn: Dict[int, float] = {}

    def eval_batch(self, output, label=None, weight=None, mask=None):
        pred = np.argmax(np.asarray(output), axis=-1).reshape(-1)
        label = np.asarray(label).reshape(-1)
        w = (np.ones_like(pred, np.float64) if weight is None
             else np.asarray(weight, np.float64).reshape(-1))
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            pred, label, w = pred[keep], label[keep], w[keep]
        for c in np.unique(np.concatenate([pred, label])):
            c = int(c)
            self.tp[c] = self.tp.get(c, 0.0) + float(
                w[(pred == c) & (label == c)].sum())
            self.fp[c] = self.fp.get(c, 0.0) + float(
                w[(pred == c) & (label != c)].sum())
            self.fn[c] = self.fn.get(c, 0.0) + float(
                w[(pred != c) & (label == c)].sum())

    def _prf(self, c):
        tp, fp, fn = self.tp.get(c, 0), self.fp.get(c, 0), self.fn.get(c, 0)
        p = tp / max(tp + fp, 1e-12)
        r = tp / max(tp + fn, 1e-12)
        f = 2 * p * r / max(p + r, 1e-12)
        return p, r, f

    def value(self):
        if self.positive_label >= 0:
            return self._prf(self.positive_label)[2]
        classes = sorted(set(self.tp) | set(self.fp) | set(self.fn))
        if not classes:
            return 0.0
        return float(np.mean([self._prf(c)[2] for c in classes]))


@register_evaluator("pnpair")
class PnpairEvaluator(EvaluatorBase):
    """``PnpairEvaluator``: for ranking — over all pairs within a query
    group, count pairs ordered correctly (pos scored above neg) vs
    incorrectly; value = correct/incorrect ratio."""

    def start(self):
        self.records: List = []

    def eval_batch(self, output, label=None, weight=None, mask=None,
                   query_id=None):
        score = np.asarray(output)
        if score.ndim > 1:
            score = score[..., -1]
        score = score.reshape(-1)
        label = np.asarray(label).reshape(-1)
        qid = (np.zeros_like(label) if query_id is None
               else np.asarray(query_id).reshape(-1))
        w = (np.ones_like(score, np.float64) if weight is None
             else np.asarray(weight, np.float64).reshape(-1))
        for s, l, q, ww in zip(score, label, qid, w):
            self.records.append((int(q), float(s), float(l), float(ww)))

    def value(self):
        pos, neg, tie = 0.0, 0.0, 0.0
        groups = defaultdict(list)
        for q, s, l, w in self.records:
            groups[q].append((s, l, w))
        for items in groups.values():
            for i in range(len(items)):
                for j in range(i + 1, len(items)):
                    (s1, l1, w1), (s2, l2, w2) = items[i], items[j]
                    if l1 == l2:
                        continue
                    w = (w1 + w2) / 2
                    hi, lo = (s1, s2) if l1 > l2 else (s2, s1)
                    if hi > lo:
                        pos += w
                    elif hi < lo:
                        neg += w
                    else:
                        tie += w
        return (pos + 0.5 * tie) / max(neg + 0.5 * tie, 1e-12)


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


@register_evaluator("column_sum")
class ColumnSumEvaluator(EvaluatorBase):
    def __init__(self, name=None, column: int = 0):
        self.column = column
        super().__init__(name)

    def start(self):
        self.total = 0.0
        self.count = 0.0

    def eval_batch(self, output, label=None, weight=None, mask=None):
        out = np.asarray(output, np.float64)
        col = out[..., self.column].reshape(-1)
        w = (np.ones_like(col) if weight is None
             else np.asarray(weight, np.float64).reshape(-1))
        if mask is not None:
            w = w * np.asarray(mask).reshape(-1)
        self.total += float((col * w).sum())
        self.count += float(w.sum())

    def value(self):
        return self.total / max(self.count, 1.0)


def _matrix_str(m) -> str:
    """Row-per-line space-separated rendering (``Matrix::print``)."""
    m = np.asarray(m, np.float64)
    m = m.reshape(m.shape[0], -1) if m.ndim > 1 else m.reshape(1, -1)
    return "\n".join(" ".join(f"{v:g}" for v in row) for row in m) + "\n"


@register_evaluator("value_printer")
class ValuePrinter(EvaluatorBase):
    """``ValuePrinter`` (``Evaluator.cpp:1008``): prints each watched
    layer's output. Format follows ``Argument::printValueString``:
    ``layer=<name> value:\\n<matrix>`` (+ sequence pos when masked)."""

    prints_on_value = True

    def start(self):
        self.last = None
        self.last_mask = None

    def eval_batch(self, output, label=None, weight=None, mask=None):
        self.last = np.asarray(output)
        self.last_mask = None if mask is None else np.asarray(mask)

    def value(self):
        v, m = self.last, self.last_mask
        pos_str = ""
        if m is not None and v is not None and v.ndim >= 2:
            # pack padded [B, T, ...] to the reference's flat
            # [total_frames, D] layout so the printed matrix and the
            # sequence pos vector describe the same rows
            lens = m.sum(axis=-1).astype(int)
            rows = [v[b, :lens[b]].reshape(lens[b], -1)
                    for b in range(v.shape[0])]
            v = (np.concatenate(rows, axis=0) if rows
                 else v.reshape(0, v.shape[-1]))
            pos = np.concatenate([[0], np.cumsum(lens)])
            pos_str = ("layer=" + self.name + " sequence pos:\n"
                       + " ".join(str(int(p)) for p in pos) + "\n")
        print("layer=" + self.name + " value:\n"
              + _matrix_str(v) + pos_str, end="")
        return 0.0


@register_evaluator("gradient_printer")
class GradientPrinter(EvaluatorBase):
    """``GradientPrinter`` (``Evaluator.cpp:1046``): prints
    d(cost)/d(layer output) — ``Argument.grad`` in the reference. The
    trainer takes it from the step's own backward (the layer's output
    among the tensors ``torch.autograd.grad`` differentiates) and sets
    ``last``."""

    prints_on_value = True
    wants_grad = True

    def start(self):
        self.last = None

    def eval_batch(self, output, label=None, weight=None, mask=None,
                   grad=None):
        if grad is not None:
            self.last = np.asarray(grad)

    def value(self):
        if self.last is None:
            print(f"layer={self.name} grad: (not computed)")
        else:
            print("layer=" + self.name + " grad matrix:\n"
                  + _matrix_str(self.last), end="")
        return 0.0


@register_evaluator("max_id_printer")
class MaxIdPrinter(EvaluatorBase):
    """``MaxIdPrinter`` (``Evaluator.cpp:1088``, registered as
    ``max_id_printer``): per row, the top ``num_results`` ids with their
    values, ``id : value, `` repeated. The JAX package's older name
    ``maxid_printer`` stays an alias."""

    prints_on_value = True

    def __init__(self, name=None, num_results: int = 1):
        self.num_results = max(int(num_results or 1), 1)
        super().__init__(name)

    def start(self):
        self.ids = None
        self.values = None

    def eval_batch(self, output, label=None, weight=None, mask=None):
        out = np.asarray(output)
        out = out.reshape(-1, out.shape[-1])
        k = min(self.num_results, out.shape[-1])
        idx = np.argsort(-out, axis=-1)[:, :k]
        self.ids = idx
        self.values = np.take_along_axis(out, idx, axis=-1)

    def value(self):
        if self.ids is None:
            return 0.0
        lines = []
        for row_i, row_v in zip(self.ids, self.values):
            lines.append("".join(f"{int(i)} : {float(v):g}, "
                                 for i, v in zip(row_i, row_v)))
        print("layer=" + self.name + " row max id vector:\n"
              + "\n".join(lines) + "\n", end="")
        return 0.0


@register_evaluator("max_frame_printer")
class MaxFramePrinter(EvaluatorBase):
    """``MaxFramePrinter`` (``Evaluator.cpp:1142``): for a width-1
    sequence output, prints each sequence's top ``num_results`` frames as
    ``time_index : value, `` plus ``total N frames``."""

    prints_on_value = True

    def __init__(self, name=None, num_results: int = 1):
        self.num_results = max(int(num_results or 1), 1)
        super().__init__(name)

    def start(self):
        self.lines: List[str] = []

    def eval_batch(self, output, label=None, weight=None, mask=None):
        out = np.asarray(output)
        if out.ndim == 3:
            out = out[..., 0]
        if out.ndim == 1:
            out = out[None]
        for b in range(out.shape[0]):
            n = int(np.asarray(mask)[b].sum()) if mask is not None \
                else out.shape[1]
            if n <= 0:
                continue
            seq = out[b, :n]
            k = min(self.num_results, n)
            idx = np.argsort(-seq, kind="stable")[:k]
            self.lines.append(
                "".join(f"{int(i)} : {float(seq[i]):g}, " for i in idx)
                + f"total {n} frames")

    def value(self):
        print("layer=" + self.name + " sequence max frames:\n"
              + "\n".join(self.lines) + "\n", end="")
        return 0.0


@register_evaluator("classification_error_printer")
class ClassificationErrorPrinter(EvaluatorBase):
    """``ClassificationErrorPrinter`` (``Evaluator.cpp:1346``): prints the
    per-sample 0/1 error matrix (``calcError``) and, for sequences, the
    start-position vector."""

    prints_on_value = True

    def start(self):
        self.err = None
        self.last_mask = None

    def eval_batch(self, output, label=None, weight=None, mask=None):
        out = np.asarray(output)
        lab = np.asarray(label)
        err = (np.argmax(out, axis=-1) != lab).astype(np.float64)
        if mask is not None:
            err = err * np.asarray(mask)
        self.err = err
        self.last_mask = None if mask is None else np.asarray(mask)

    def value(self):
        if self.err is None:
            return 0.0
        out = ("Printer=" + self.name + " Classification Error:\n"
               + _matrix_str(self.err.reshape(-1, 1)))
        if self.last_mask is not None:
            lens = self.last_mask.sum(axis=-1).astype(int)
            pos = np.concatenate([[0], np.cumsum(lens)])
            out += ("Printer=" + self.name + " sequence pos vector:\n"
                    + " ".join(str(int(p)) for p in pos) + "\n")
        print(out, end="")
        return 0.0


@register_evaluator("seq_text_printer")
class SeqTextPrinter(EvaluatorBase):
    prints_on_value = True
    """``utils/SeqTextPrinter`` analogue: map id sequences through a dict
    file and print."""

    def __init__(self, name=None, dict_file: Optional[str] = None,
                 id_input=None):
        self.vocab = None
        if dict_file:
            with open(dict_file) as f:
                self.vocab = [line.rstrip("\n") for line in f]
        super().__init__(name)

    def start(self):
        self.lines: List[str] = []

    def eval_batch(self, output, label=None, weight=None, mask=None):
        ids = np.asarray(output)
        if ids.ndim == 1:
            ids = ids[None]
        for b in range(ids.shape[0]):
            n = int(np.asarray(mask)[b].sum()) if mask is not None \
                else ids.shape[1]
            toks = [self.vocab[int(i)] if self.vocab else str(int(i))
                    for i in ids[b, :n]]
            self.lines.append(" ".join(toks))

    def value(self):
        print("\n".join(self.lines))
        return 0.0


@register_evaluator("detection_map")
class DetectionMAPEvaluator(EvaluatorBase):
    """``DetectionMAPEvaluator.cpp``: mean average precision over detection
    outputs. output rows (per image): [keep_top_k, 7] =
    (label, score, xmin, ymin, xmax, ymax, valid) — the detection_output
    layer's format; label rows: [M, 6] = (label, xmin, ymin, xmax, ymax,
    difficult), with label < 0 marking padding rows.
    ap_type: "11point" (default) or "integral"."""

    def __init__(self, name=None, overlap_threshold: float = 0.5,
                 background_id: int = 0, evaluate_difficult: bool = False,
                 ap_type: str = "11point"):
        self.overlap_threshold = overlap_threshold
        self.background_id = background_id
        self.evaluate_difficult = evaluate_difficult
        self.ap_type = ap_type
        super().__init__(name)

    def start(self):
        # per class: list of (score, is_tp) + ground-truth count
        self.dets: Dict[int, List] = {}
        self.n_gt: Dict[int, int] = {}

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def eval_batch(self, output, label=None, weight=None, mask=None):
        out = np.asarray(output)
        gt = np.asarray(label)
        if out.ndim == 2:
            out, gt = out[None], gt[None]
        if out.shape[-1] != 7:
            out = out.reshape(out.shape[0], -1, 7)
        if gt.shape[-1] != 6:
            gt = gt.reshape(gt.shape[0], -1, 6)
        for b in range(out.shape[0]):
            gts = [g for g in gt[b] if g[0] >= 0]
            for g in gts:
                c = int(g[0])
                if self.evaluate_difficult or not g[5]:
                    self.n_gt[c] = self.n_gt.get(c, 0) + 1
            matched = [False] * len(gts)
            dets = [d for d in out[b] if d[6] > 0 and d[0] != self.background_id]
            dets.sort(key=lambda d: -d[1])
            for d in dets:
                c = int(d[0])
                best, best_i = 0.0, -1
                for i, g in enumerate(gts):
                    if int(g[0]) != c:
                        continue
                    o = self._iou(d[2:6], g[1:5])
                    if o > best:
                        best, best_i = o, i
                tp = False
                if best >= self.overlap_threshold and best_i >= 0:
                    g = gts[best_i]
                    if not self.evaluate_difficult and g[5]:
                        continue  # difficult match: ignore the detection
                    if not matched[best_i]:
                        matched[best_i] = True
                        tp = True
                self.dets.setdefault(c, []).append((float(d[1]), tp))

    def _ap(self, recs, precs):
        if self.ap_type == "integral":
            ap, prev_r = 0.0, 0.0
            for r, p in zip(recs, precs):
                ap += p * (r - prev_r)
                prev_r = r
            return ap
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            ps = [p for r, p in zip(recs, precs) if r >= t]
            ap += (max(ps) if ps else 0.0) / 11.0
        return ap

    def value(self):
        aps = []
        for c, n_gt in self.n_gt.items():
            dets = sorted(self.dets.get(c, []), key=lambda d: -d[0])
            tp_cum = fp_cum = 0
            recs, precs = [], []
            for score, tp in dets:
                tp_cum += tp
                fp_cum += not tp
                recs.append(tp_cum / max(n_gt, 1))
                precs.append(tp_cum / max(tp_cum + fp_cum, 1))
            aps.append(self._ap(recs, precs) if dets else 0.0)
        return float(np.mean(aps)) if aps else 0.0



# the canonical registration is max_id_printer (the reference's string,
# Evaluator.cpp:1088); the JAX package's older spelling stays an alias
_EVALUATORS["maxid_printer"] = MaxIdPrinter

# reference EvaluatorConfig.type -> registry name
_TYPE_ALIASES = {
    "last-column-auc": "auc",
    "last-column-sum": "column_sum",
}


def build_from_configs(configs: Sequence[dict]):
    """EvaluatorConfig-shaped dicts (``ModelDef.evaluators``, as
    ``dsl.evaluator`` records them) -> [(evaluator, input_layer_names,
    roles)]. ``roles`` says how many leading inputs are outputs and
    whether a label, a weight and a query id follow. An unknown type is
    skipped with a warning, as in the JAX package."""
    built = []
    for cfg in configs or []:
        tname = _TYPE_ALIASES.get(cfg.get("type"), cfg.get("type"))
        cls = _EVALUATORS.get(tname)
        if cls is None:
            logger.warning("evaluator type %r not supported; skipping",
                           cfg.get("type"))
            continue
        accepted = set(inspect.signature(cls.__init__).parameters)
        kwargs = {k: v for k, v in cfg.items()
                  if k in accepted and k not in ("input_layers", "type")}
        roles = cfg.get("_roles") or {
            "n_outputs": 1,
            "has_label": len(cfg.get("input_layers", [])) > 1,
            "has_weight": False}
        built.append((cls(**kwargs), list(cfg.get("input_layers", [])),
                      roles))
    return built
