"""SSD detection layers: priorbox, multibox_loss, detection_output
(``PriorBox.cpp``, ``MultiBoxLossLayer.cpp``, ``DetectionOutputLayer.cpp``
with ``DetectionUtil.cpp``). The port's counterpart of
``paddle_tpu/layers/detection.py``: matching, mining and NMS as
fixed-shape tensor programs. Hard-negative mining is a rank threshold;
NMS is one loop of ``min(nms_top_k, N)`` trips over every image and class
at once (``[B, C - 1, N]`` scores), which keeps the JAX package's rows.

Box encoding matches the reference: corner boxes normalised to [0, 1],
offsets encoded relative to the prior's centre and size, scaled by the
variance. Sorts are stable, so ties fall as in JAX (``lax.top_k`` and
``jnp.argsort`` take the lower index first; ``argmax`` the first maximum).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer


def make_prior_boxes(fh, fw, img_h, img_w, min_sizes, max_sizes,
                     aspect_ratios, variance, device="cpu"):
    """[N, 4] corner boxes and [N, 4] variances for an fh × fw feature map
    (``PriorBox.cpp``'s forward), clipped to [0, 1]."""
    boxes = []
    step_x, step_y = 1.0 / fw, 1.0 / fh
    for i in range(fh):
        for j in range(fw):
            cx, cy = (j + 0.5) * step_x, (i + 0.5) * step_y
            for k, ms in enumerate(min_sizes):
                bw, bh = ms / img_w, ms / img_h
                boxes.append([cx - bw / 2, cy - bh / 2,
                              cx + bw / 2, cy + bh / 2])
                if max_sizes:
                    s = math.sqrt(ms * max_sizes[k])
                    bw, bh = s / img_w, s / img_h
                    boxes.append([cx - bw / 2, cy - bh / 2,
                                  cx + bw / 2, cy + bh / 2])
                for ar in aspect_ratios:
                    if abs(ar - 1.0) < 1e-6:
                        continue
                    for a in (ar, 1.0 / ar):
                        bw = ms * math.sqrt(a) / img_w
                        bh = ms / math.sqrt(a) / img_h
                        boxes.append([cx - bw / 2, cy - bh / 2,
                                      cx + bw / 2, cy + bh / 2])
    b = torch.clamp(torch.tensor(boxes, dtype=torch.float32, device=device),
                    0.0, 1.0)
    v = torch.tensor(variance, dtype=torch.float32,
                     device=device).expand(b.shape)
    return b, v


def _areas(b):
    return torch.clamp_min((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                           0.0)


def iou_matrix(a, b):
    """IoU between [..., N, 4] and [..., M, 4] corner boxes → [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _areas(a)[..., :, None] + _areas(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode_box(gt, prior, var):
    """Encode gt corner boxes against priors (DetectionUtil encodeBBox)."""
    pw = prior[..., 2] - prior[..., 0]
    ph = prior[..., 3] - prior[..., 1]
    pcx = (prior[..., 0] + prior[..., 2]) / 2
    pcy = (prior[..., 1] + prior[..., 3]) / 2
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    return torch.stack([
        (gcx - pcx) / pw / var[..., 0],
        (gcy - pcy) / ph / var[..., 1],
        torch.log(torch.clamp_min(gw / pw, 1e-10)) / var[..., 2],
        torch.log(torch.clamp_min(gh / ph, 1e-10)) / var[..., 3]], dim=-1)


def decode_box(loc, prior, var):
    pw = prior[..., 2] - prior[..., 0]
    ph = prior[..., 3] - prior[..., 1]
    pcx = (prior[..., 0] + prior[..., 2]) / 2
    pcy = (prior[..., 1] + prior[..., 3]) / 2
    cx = loc[..., 0] * var[..., 0] * pw + pcx
    cy = loc[..., 1] * var[..., 1] * ph + pcy
    w = torch.exp(loc[..., 2] * var[..., 2]) * pw
    h = torch.exp(loc[..., 3] * var[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register_layer("priorbox")
class PriorBoxLayer(LayerImpl):
    """Inputs (feature layer, image layer); attrs min_size, max_size,
    aspect_ratio, variance. Output [N, 8]: box corners and variances."""

    def _count(self, cfg, info):
        n_min = len(cfg.attrs["min_size"])
        n_max = len(cfg.attrs.get("max_size", []))
        n_ar = len([a for a in cfg.attrs.get("aspect_ratio", [])
                    if abs(a - 1.0) > 1e-6])
        return info.height * info.width * (n_min * (1 + 2 * n_ar) + n_max)

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=self._count(cfg, in_infos[0]) * 8)

    def apply(self, cfg, params, ins, ctx):
        info, img = ctx.in_infos[0], ctx.in_infos[1]
        b, v = make_prior_boxes(
            info.height, info.width, img.height, img.width,
            cfg.attrs["min_size"], cfg.attrs.get("max_size", []),
            cfg.attrs.get("aspect_ratio", [1.0]),
            cfg.attrs.get("variance", [0.1, 0.1, 0.2, 0.2]),
            device=ins[0].value.device)
        return Argument(value=torch.cat([b, v], dim=-1))


@register_layer("multibox_loss")
class MultiBoxLossLayer(LayerImpl):
    """Inputs (priorbox [N, 8], ground truth [B, G, 5] (class, xmin, ymin,
    xmax, ymax) with its mask, loc [B, N·4], conf [B, N·C]), the
    reference's order. Each prior matches its best ground truth above
    ``overlap_threshold``, and each ground truth's best prior is forced
    positive (a scatter-max, so a padded box never clears a real one);
    smooth-L1 over positives plus the softmax loss over positives and the
    ``neg_pos_ratio`` × positives hardest negatives, over the positive
    count. Output: per-sample cost [B, 1]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def apply(self, cfg, params, ins, ctx):
        prior_a, gt_a, loc_a, conf_a = ins
        C = cfg.attrs["num_classes"]
        thresh = cfg.attrs.get("overlap_threshold", 0.5)
        neg_ratio = cfg.attrs.get("neg_pos_ratio", 3.0)
        bg = cfg.attrs.get("background_id", 0)
        priors = prior_a.value[:, :4]
        var = prior_a.value[:, 4:]
        N = priors.shape[0]
        gt = gt_a.value                                   # [B, G, 5]
        B = gt.shape[0]
        gtm = (gt_a.mask if gt_a.mask is not None
               else gt.new_ones(gt.shape[:2]))
        conf = conf_a.value.reshape(B, N, C)
        loc = loc_a.value.reshape(B, N, 4)

        iou = iou_matrix(priors, gt[..., 1:]) * gtm[:, None, :]  # [B, N, G]
        best_iou = iou.amax(dim=2)
        best_gt = torch.argmax(iou, dim=2)                   # [B, N]
        best_prior = torch.argmax(iou, dim=1)                # [B, G]
        forced = torch.zeros((B, N), dtype=torch.int32,
                             device=gt.device).scatter_reduce(
            1, best_prior, (gtm > 0).to(torch.int32), "amax",
            include_self=True) > 0
        pos = (best_iou > thresh) | forced
        matched = torch.gather(gt, 1, best_gt.unsqueeze(-1).expand(-1, -1, 5))
        target_loc = encode_box(matched[..., 1:], priors, var)
        target_cls = torch.where(pos, matched[..., 0].long(),
                                 torch.full_like(best_gt, bg))
        d = loc - target_loc
        sl1 = torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5).sum(-1)
        loc_loss = (sl1 * pos).sum(1)
        logp = F.log_softmax(conf, dim=-1)
        ce = -torch.gather(logp, 2, target_cls.unsqueeze(-1))[..., 0]
        num_pos = pos.sum(1, dtype=torch.int32)
        # hard negatives: the top neg_ratio * num_pos by loss
        neg_score = torch.where(pos, torch.full_like(ce, -math.inf), ce)
        order = torch.argsort(-neg_score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=order.device).expand(B, N))
        n_neg = (neg_ratio * num_pos.to(torch.float32)).to(torch.int32)
        neg = ~pos & (rank < n_neg.unsqueeze(1))
        conf_loss = (ce * (pos | neg)).sum(1)
        denom = torch.clamp_min(num_pos.to(torch.float32), 1.0)
        return Argument(value=((loc_loss + conf_loss) / denom).unsqueeze(1))


def nms_fixed(boxes, scores, iou_thresh, max_out):
    """Greedy NMS of every row at once with a fixed trip count: ``boxes``
    [B, N, 4], ``scores`` [B, R, N] (R rows per image, a suppressed or
    filtered box at -inf) → (indices [B, R, max_out], valid [B, R,
    max_out]). Each trip keeps each row's best box and suppresses the
    boxes over ``iou_thresh`` against it (JAX ``nms_fixed``, one row per
    call there)."""
    B, R, N = scores.shape
    sc = scores.clone()
    area = _areas(boxes)                                  # [B, N]
    neg_inf = torch.full((), -math.inf, device=sc.device)
    idx = torch.zeros((B, R, max_out), dtype=torch.long, device=sc.device)
    ok = torch.zeros((B, R, max_out), dtype=torch.bool, device=sc.device)
    for i in range(max_out):
        best = torch.argmax(sc, dim=2)                    # [B, R]
        idx[:, :, i] = best
        ok[:, :, i] = torch.gather(sc, 2, best.unsqueeze(-1))[..., 0] > neg_inf
        bb = torch.gather(boxes, 1, best.unsqueeze(-1).expand(-1, -1, 4))
        lt = torch.maximum(bb[:, :, None, :2], boxes[:, None, :, :2])
        rb = torch.minimum(bb[:, :, None, 2:], boxes[:, None, :, 2:])
        wh = torch.clamp_min(rb - lt, 0.0)
        inter = wh[..., 0] * wh[..., 1]                   # [B, R, N]
        union = _areas(bb)[..., None] + area[:, None, :] - inter
        ious = torch.where(union > 0, inter / union, torch.zeros_like(inter))
        sc = torch.where(ious > iou_thresh, neg_inf, sc)
        sc.scatter_(2, best.unsqueeze(-1), neg_inf.expand(B, R, 1))
    return idx, ok


@register_layer("detection_output")
class DetectionOutputLayer(LayerImpl):
    """Inputs (priorbox, loc, conf), the reference's order. Decode, the
    per-class NMS over the scores above ``confidence_threshold``, then the
    ``keep_top_k`` best of all classes. Output [B, keep_top_k, 7]: (label,
    score, xmin, ymin, xmax, ymax, valid)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.attrs.get("keep_top_k", 200) * 7)

    def apply(self, cfg, params, ins, ctx):
        prior_a, loc_a, conf_a = ins
        C = cfg.attrs["num_classes"]
        bg = cfg.attrs.get("background_id", 0)
        conf_th = cfg.attrs.get("confidence_threshold", 0.01)
        nms_th = cfg.attrs.get("nms_threshold", 0.45)
        nms_top = cfg.attrs.get("nms_top_k", 100)
        keep_top = cfg.attrs.get("keep_top_k", 200)
        priors = prior_a.value[:, :4]
        var = prior_a.value[:, 4:]
        N = priors.shape[0]
        B = conf_a.value.shape[0]
        conf = torch.softmax(conf_a.value.reshape(B, N, C), dim=-1)
        boxes = decode_box(loc_a.value.reshape(B, N, 4), priors, var)
        per_cls = min(nms_top, N)
        classes = [c for c in range(C) if c != bg]
        cc = conf[:, :, classes].transpose(1, 2)          # [B, C - 1, N]
        sc = torch.where(cc > conf_th, cc, torch.full_like(cc, -math.inf))
        idx, ok = nms_fixed(boxes, sc, nms_th, per_cls)
        R = len(classes)
        scores = torch.where(ok, torch.gather(cc, 2, idx),
                             torch.zeros_like(cc[..., :1])).reshape(B, -1)
        labels = torch.tensor(classes, dtype=torch.float32,
                              device=conf.device).repeat_interleave(
            per_cls).expand(B, -1)
        bxs = torch.gather(boxes, 1, idx.reshape(B, R * per_cls, 1).expand(
            -1, -1, 4))
        oks = ok.reshape(B, -1)
        k = min(keep_top, scores.shape[1])
        # lax.top_k's order: best first, the lower index first among ties
        ranked = torch.where(oks, scores, torch.full_like(scores, -1.0))
        top, ti = torch.sort(ranked, dim=1, descending=True, stable=True)
        top, ti = top[:, :k], ti[:, :k]
        out = torch.cat([
            torch.gather(labels, 1, ti).unsqueeze(-1), top.unsqueeze(-1),
            torch.gather(bxs, 1, ti.unsqueeze(-1).expand(-1, -1, 4)),
            (top > 0).unsqueeze(-1).to(torch.float32)], dim=-1)
        if k < keep_top:
            out = F.pad(out, (0, 0, 0, keep_top - k))
        return Argument(value=out)
