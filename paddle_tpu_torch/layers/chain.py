"""Sequence cost layers: the port of ``paddle_tpu/layers/chain.py``, the
linear-chain CRF (``CRFLayer.cpp``, ``CRFDecodingLayer.cpp``,
``LinearChainCRF.cpp``) and CTC (``CTCLayer.cpp``, ``WarpCTCLayer.cpp``,
``LinearChainCTC.cpp``).

The parameter layout is the reference CRF's (``LinearChainCRF.cpp:28-45``):
one (C+2, C) matrix whose row 0 is the start potential a, row 1 the end
potential b, rows 2.. the transitions w[prev, next]. The likelihood's log Z
and the Viterbi decode run through ``ops/crf.py`` (the CUDA kernels on the
card); the gold-path score is gathered in plain torch under autograd.

CTC hands the log-probs and the labels to ``ops/ctc.py:
ctc_ll_from_log_probs``: on the card the fused kernels derive the
blank-interleaved extended labels themselves, read the log-probs at them
and write the gradient into the log-probs; on the CPU the plain
composition builds the extended labels, gathers the emissions (autograd's
scatter-add is the gather's transpose) and runs the recursions' plain
versions. ``extended_labels`` lives in ``ops/ctc.py`` and is re-exported
here.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.ops.crf import crf_log_z, crf_viterbi
from paddle_tpu_torch.ops.ctc import (  # noqa: F401 (re-export)
    ctc_ll_from_log_probs, extended_labels)


def crf_log_likelihood(x, labels, mask, w):
    """Per-sequence log P(labels | x) [B] for a linear-chain CRF: the gold
    path's score minus log Z. x [B,T,C] emission scores, labels [B,T] int,
    mask [B,T], w [(C+2), C] packed (start, end, transitions)."""
    a, b, trans = w[0], w[1], w[2:]
    labels = labels.long()
    emit = torch.gather(x, 2, labels[:, :, None])[:, :, 0]
    emit = (emit * mask).sum(dim=1)
    prev_l, next_l = labels[:, :-1], labels[:, 1:]
    pair_m = mask[:, 1:] * mask[:, :-1]
    tr = (trans[prev_l, next_l] * pair_m).sum(dim=1)
    start = a[labels[:, 0]]
    lengths = mask.sum(dim=1).long()
    last = torch.gather(labels, 1,
                        torch.clamp_min(lengths - 1, 0)[:, None])[:, 0]
    gold = emit + tr + start + b[last]
    return gold - crf_log_z(x, mask.to(x.dtype), trans, a, b)


def crf_decode(x, mask, w):
    """Viterbi decoding: ([B,T] int32 best path ids, [B] path scores)."""
    return crf_viterbi(x.contiguous(), mask.to(x.dtype).contiguous(),
                       w[2:].contiguous(), w[0].contiguous(),
                       w[1].contiguous())


def _mask(x: Argument):
    return x.mask if x.mask is not None else x.value.new_ones(
        x.value.shape[:2])


@register_layer("crf")
class CRFLayer(LayerImpl):
    """``CRFLayer.cpp``: cost layer; inputs = (emission, label[, weight]).
    Output: per-sequence negative log-likelihood [B, 1]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def params(self, cfg, in_infos):
        C = in_infos[0].size
        return {"w0": ParamSpec(shape=(C + 2, C))}

    def apply(self, cfg, params, ins, ctx):
        x, label = ins[0], ins[1]
        cost = -crf_log_likelihood(x.value, label.value, _mask(x),
                                   params["w0"])
        if len(ins) > 2:
            cost = cost * ins[2].value.reshape(cost.shape)
        return Argument(value=cost[:, None])


@register_layer("crf_decoding")
class CRFDecodingLayer(LayerImpl):
    """``CRFDecodingLayer.cpp``: Viterbi decode. Without a label input the
    output is the decoded tag sequence ([B, T, 1] int32 with the mask);
    with one, a per-sequence 0/1 error indicator [B, 1] (1 = the decode
    differs from the gold tags at a real step), with the decoded path in
    ``state["ids"]`` and its mask in ``state["ids_mask"]`` (what the chunk
    evaluator reads)."""

    def infer(self, cfg, in_infos):
        if len(in_infos) > 1:
            return ShapeInfo(size=1)
        return ShapeInfo(size=1, is_sequence=True)

    def params(self, cfg, in_infos):
        C = in_infos[0].size
        return {"w0": ParamSpec(shape=(C + 2, C))}

    def apply(self, cfg, params, ins, ctx):
        x = ins[0]
        mask = _mask(x)
        with torch.no_grad():  # argmax has no gradient
            path, _ = crf_decode(x.value, mask, params["w0"])
        if len(ins) > 1:
            gold = ins[1].value.to(path.dtype)
            wrong = ((path != gold) & (mask > 0)).any(dim=1)
            return Argument(value=wrong.to(torch.float32)[:, None],
                            state={"ids": path, "ids_mask": mask})
        return Argument(value=path[:, :, None], mask=mask)


# --------------------------------------------------------------------- CTC
def ctc_loss(log_probs, labels, in_mask, label_mask, blank):
    """Per-sequence CTC negative log-likelihood [B], the function of
    ``paddle_tpu/layers/chain.py:ctc_loss``. log_probs [B,T,C] log softmax
    outputs; labels [B,L] ints (no blanks); in_mask [B,T]; label_mask
    [B,L]; blank a class id. Empty transcripts (``ext_lens`` = 1) count
    the blank path only."""
    return ctc_ll_from_log_probs(log_probs, labels, in_mask, label_mask,
                                 blank, negate=True)


@register_layer("ctc", "warp_ctc")
class CTCLayer(LayerImpl):
    """``CTCLayer.cpp``: inputs = (pre-softmax scores [B,T,C], label
    sequence). The blank is ``attrs["blank"]``, else C - 1
    (``LinearChainCTC.cpp``); with ``norm_by_times`` the cost divides by
    the sequence's frame count. ``warp_ctc`` (``WarpCTCLayer.cpp``, the
    same math behind a GPU library) is an alias. Output: [B, 1]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def apply(self, cfg, params, ins, ctx):
        x, label = ins[0], ins[1]
        in_mask = _mask(x)
        lab = label.value
        if lab.dim() == 3:
            lab = lab[:, :, 0]
        log_probs = torch.log_softmax(x.value, dim=-1)
        blank = cfg.attrs.get("blank", x.value.shape[-1] - 1)
        cost = ctc_loss(log_probs, lab, in_mask, _mask(label), blank)
        if cfg.attrs.get("norm_by_times", False):
            cost = cost / torch.clamp_min(in_mask.sum(dim=1), 1.0)
        return Argument(value=cost[:, None])
