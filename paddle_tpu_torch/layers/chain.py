"""Sequence cost layers: the port of ``paddle_tpu/layers/chain.py``, the
linear-chain CRF (``CRFLayer.cpp``, ``CRFDecodingLayer.cpp``,
``LinearChainCRF.cpp``) and CTC (``CTCLayer.cpp``, ``WarpCTCLayer.cpp``,
``LinearChainCTC.cpp``).

The parameter layout is the reference CRF's (``LinearChainCRF.cpp:28-45``):
one (C+2, C) matrix whose row 0 is the start potential a, row 1 the end
potential b, rows 2.. the transitions w[prev, next]. The likelihood's log Z
and the Viterbi decode run through ``ops/crf.py`` (the CUDA kernels on the
card); the gold-path score is gathered in plain torch under autograd.

CTC builds the blank-interleaved extended labels and gathers the
emissions in plain torch (autograd's scatter-add is the gather's
transpose), and runs the alpha and beta recursions through ``ops/ctc.py``
(the CUDA kernels on the card).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.ops.crf import crf_log_z, crf_viterbi
from paddle_tpu_torch.ops.ctc import ctc_ll


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
def extended_labels(labels, label_mask, blank):
    """The blank-interleaved extended labels of ``paddle_tpu/layers/
    chain.py:ctc_loss``: ext [B, S] = [blank, l1, blank, l2, ..., blank]
    (S = 2 L + 1, long), ext_lens [B] = 2 L_b + 1 (int32, L_b the sum of
    ``label_mask``), valid_s [B, S] (s < ext_lens) and can_skip [B, S] (the
    jump from s-2 to s: ext[s] is no blank and differs from ext[s-2]),
    both bool."""
    B, S = labels.shape[0], 2 * labels.shape[1] + 1
    dev = labels.device
    ext = torch.full((B, S), int(blank), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_lens = 2 * label_mask.sum(dim=1).to(torch.int32) + 1
    valid_s = torch.arange(S, device=dev)[None, :] < ext_lens[:, None]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext], dim=1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    return ext, ext_lens, valid_s, can_skip


def ctc_loss(log_probs, labels, in_mask, label_mask, blank):
    """Per-sequence CTC negative log-likelihood [B], spelled as
    ``paddle_tpu/layers/chain.py:ctc_loss``. log_probs [B,T,C] log softmax
    outputs; labels [B,L] ints (no blanks); in_mask [B,T]; label_mask
    [B,L]; blank a class id. Empty transcripts (``ext_lens`` = 1) count
    the blank path only."""
    B, T, _ = log_probs.shape
    ext, ext_lens, valid_s, can_skip = extended_labels(labels, label_mask,
                                                       blank)
    # the emissions of every (t, extended state), gathered once (autograd's
    # scatter-add is the gather's transpose); the recursions run in
    # ops/ctc.py
    emit = torch.gather(log_probs, 2,
                        ext[:, None, :].expand(B, T, ext.shape[1]))
    dt = log_probs.dtype
    return -ctc_ll(emit, in_mask.to(dt), valid_s.to(dt), can_skip.to(dt),
                   ext_lens)


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
