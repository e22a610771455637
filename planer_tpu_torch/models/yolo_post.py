"""YOLO-v3 host-side postprocessing: box decode, score filter and NMS.

A copy of ``planer_tpu/models/yolo_post.py``.  The data-dependent tail
(variable box counts) runs on the host, on the three head tensors (or the
decoded boxes) the program returns.  ``detect`` filters scores and
suppresses boxes with the native C++ code (``planer_tpu_torch.native``),
which raises where it cannot build; ``_nms_numpy`` and
``native.score_filter_numpy`` are their plain versions, for the tests.
NMS orders equal scores by index (a stable sort) in both versions.
"""
from __future__ import annotations

import numpy as np

from .yolov3 import YOLO_ANCHORS

__all__ = ["decode_heads", "nms", "detect"]


def _sigmoid(x):
    with np.errstate(over="ignore"):
        return 1.0 / (1.0 + np.exp(-x))


def decode_heads(heads, img_size: int = 416, num_classes: int | None = None,
                 anchors=None):
    """heads: [stride32, stride16, stride8] raw tensors (N, 3*(5+C), H, W).

    Returns (N, total_boxes, 5 + C): [cx, cy, w, h, obj, cls...] in pixels.
    ``num_classes`` defaults to the value implied by the head channel count.
    """
    anchors = anchors or YOLO_ANCHORS
    if num_classes is None:
        num_classes = np.asarray(heads[0]).shape[1] // 3 - 5
    outs = []
    for t, stride in zip(heads, (32, 16, 8)):
        t = np.asarray(t)
        n, ch, h, w = t.shape
        na = len(anchors[stride])
        t = t.reshape(n, na, 5 + num_classes, h, w).transpose(0, 1, 3, 4, 2)
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        xy = (_sigmoid(t[..., 0:2])
              + np.stack([gx, gy], -1)[None, None]) * stride
        a = np.asarray(anchors[stride], np.float32).reshape(1, na, 1, 1, 2)
        wh = np.exp(np.clip(t[..., 2:4], -20, 20)) * a
        obj = _sigmoid(t[..., 4:5])
        cls = _sigmoid(t[..., 5:])
        dec = np.concatenate([xy, wh, obj, cls], axis=-1)
        outs.append(dec.reshape(n, -1, 5 + num_classes))
    return np.concatenate(outs, axis=1)


def _nms_numpy(boxes, scores, iou_thresh: float = 0.45, top_k: int = 300):
    """Greedy NMS, pure-numpy reference implementation."""
    x1 = boxes[:, 0] - boxes[:, 2] / 2
    y1 = boxes[:, 1] - boxes[:, 3] / 2
    x2 = boxes[:, 0] + boxes[:, 2] / 2
    y2 = boxes[:, 1] + boxes[:, 3] / 2
    areas = (x2 - x1) * (y2 - y1)
    # scan ALL candidates (no pre-truncation) so this path is behaviorally
    # identical to the native C++ kernel in dense scenes; equal scores in
    # index order, as its stable sort leaves them
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size and len(keep) < top_k:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-9)
        order = order[1:][iou <= iou_thresh]
    return np.asarray(keep, np.int64)


def nms(boxes, scores, iou_thresh: float = 0.45, top_k: int = 300):
    """Greedy NMS on [cx, cy, w, h] boxes; returns kept indices: the native
    C++ code (planer_tpu_torch.native)."""
    from .. import native
    return native.nms(boxes, scores, iou_thresh, top_k)


def detect(net, img, conf_thresh: float = 0.25, iou_thresh: float = 0.45,
           num_classes: int | None = None, min_wh: float = 2.0,
           return_candidates: bool = False):
    """Full pipeline: forward on the card -> host decode -> per-class NMS.

    ``img``: (N, 3, S, S) float32.  Returns a list (per image) of
    (x1, y1, x2, y2, score, class_id) float arrays.  Boxes smaller than
    ``min_wh`` pixels are dropped and coordinates clipped to the image.
    ``return_candidates``: also return the per-image PRE-NMS candidate
    arrays (same 6-column layout) — used by eval.detection_agreement's
    NMS near-tie margin filter.
    """
    size = img.shape[-1]
    heads = net(img)
    if isinstance(heads, (tuple, list)):
        dec = decode_heads(heads, img_size=size, num_classes=num_classes)
    else:  # net built with decode=True: a single (N, boxes, 5+C) tensor
        dec = np.asarray(heads)
        assert dec.ndim == 3, (
            f"expected decoded (N, boxes, 5+C) output, got shape {dec.shape}")
    results = []
    cands = []
    from .. import native
    for bi in range(dec.shape[0]):
        d = dec[bi]
        idx, cls_id, cls_sc = native.score_filter(d, conf_thresh)
        d = d[idx]
        # drop degenerate boxes, cap to image scale
        ok = (d[:, 2] >= min_wh) & (d[:, 3] >= min_wh) \
            & (d[:, 2] <= 4 * size) & (d[:, 3] <= 4 * size)
        d, cls_id, cls_sc = d[ok], cls_id[ok], cls_sc[ok]
        # runner-up class score per candidate (class-flip stability signal)
        if d.shape[1] >= 7:  # >= 2 classes
            sc_all = d[:, 4:5] * d[:, 5:]
            s2_all = np.partition(sc_all, -2, axis=1)[:, -2] if len(d) \
                else np.zeros(0, np.float32)
        else:
            s2_all = np.zeros(len(d), np.float32)
        if return_candidates:
            cx1 = np.clip(d[:, 0] - d[:, 2] / 2, 0, size)
            cy1 = np.clip(d[:, 1] - d[:, 3] / 2, 0, size)
            cx2 = np.clip(d[:, 0] + d[:, 2] / 2, 0, size)
            cy2 = np.clip(d[:, 1] + d[:, 3] / 2, 0, size)
            cands.append(np.stack(
                [cx1, cy1, cx2, cy2, cls_sc,
                 cls_id.astype(np.float32), s2_all], 1) if len(d)
                else np.zeros((0, 7), np.float32))
        out = []
        for c in np.unique(cls_id):
            mc = cls_id == c
            keep = nms(d[mc, :4], cls_sc[mc], iou_thresh)
            bx = d[mc][keep]
            sc = cls_sc[mc][keep]
            x1 = np.clip(bx[:, 0] - bx[:, 2] / 2, 0, size)
            y1 = np.clip(bx[:, 1] - bx[:, 3] / 2, 0, size)
            x2 = np.clip(bx[:, 0] + bx[:, 2] / 2, 0, size)
            y2 = np.clip(bx[:, 1] + bx[:, 3] / 2, 0, size)
            cols = [x1, y1, x2, y2, sc,
                    np.full_like(sc, c, dtype=np.float32)]
            if return_candidates:
                cols.append(s2_all[mc][keep])
            out.append(np.stack(cols, 1))
        ncol = 7 if return_candidates else 6
        results.append(np.concatenate(out, 0) if out
                       else np.zeros((0, ncol), np.float32))
    if return_candidates:
        return results, cands
    return results
