"""Detection ops: the port of ``paddle_tpu/vision/ops.py``, with the JAX
package's semantics where they differ from Paddle's (the JAX module is
the reference).

- ``roi_align`` / ``roi_pool`` / ``psroi_pool`` and their layers: the
  samples of every box gather rows of the channels-last feature map
  (``(N*H*W, C)``), so a box costs no copy of its image; the gradient
  with respect to ``x`` is the gathers' scatter-add.  ``roi_align``'s
  ``sampling_ratio=-1`` is the JAX docstring's fixed 2 x 2 grid a bin,
  not Paddle's adaptive one.  ``roi_pool`` is exact for any box: its
  bins are reduced in chunks of boxes sorted by their bin span, each bin
  read as a window of the chunk's largest span with the indices clamped
  into the bin (a repeated pixel leaves a max unchanged);
- ``nms_mask``: greedy by descending score (a stable sort) over the IoU
  matrix, swept on the input's device as a fixed-point iteration
  (``keep[i] = no kept j < i overlaps i``, from all kept, until two
  sweeps agree: the greedy mask is the map's only fixed point, reached in
  at most as many sweeps as the longest suppression chain); ``nms``
  moves the mask to the host for the kept indices, as the JAX ``nms``
  does, and returns them as int64 (the JAX function gives int32);
- ``yolo_box`` and ``yolo_loss``: elementwise decode and the YOLOv3 loss
  with its scatters as ``index_put_(accumulate=True)``;
- ``deform_conv2d`` (v1, and v2 with ``mask``): one bilinear gather a tap,
  then one ``(N*Ho*Wo, kh*kw*Cin) x (kh*kw*Cin, Cout)`` product;
- ``read_file`` / ``decode_jpeg``: host ops on PIL, the result on the
  card unless ``device="cpu"``; PIL is imported only inside them.

Sample coordinates are computed in float32 from float32 boxes, as the
JAX ops compute them (``jnp.asarray(boxes, jnp.float32)``); values and
weights are multiplied in the feature map's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..framework.errors import enforce
from ..nn import initializer as I
from ..nn.layer import Layer
from .models.utils import ConvNormActivation  # noqa: F401

__all__ = ["yolo_box", "roi_align", "roi_pool", "psroi_pool", "RoIAlign",
           "RoIPool", "PSRoIPool", "nms", "nms_mask", "deform_conv2d",
           "DeformConv2D", "read_file", "decode_jpeg", "ConvNormActivation",
           "yolo_loss"]

# elements of one chunk of roi_pool's windows (float32: 512 MB)
_ROI_POOL_CHUNK = 1 << 27


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _tensor(v, device=None, dtype=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device if device is not None else v.device,
                    dtype=dtype if dtype is not None else v.dtype)
    return torch.as_tensor(np.asarray(v), device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# bilinear sampling shared core
# ---------------------------------------------------------------------------
def _bilinear_rows(rows, img, y, x, H: int, W: int):
    """Bilinear samples of ``rows`` (``(N*H*W, C)``, the channels-last
    feature map) at fractional ``(y, x)`` of image ``img`` (all three
    broadcast to one shape S): ``(*S, C)``.  Corners outside the image
    contribute 0 (the JAX ``_bilinear_sample``)."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = y - y0
    wx1 = x - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    img = img * (H * W)
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = y0i + dy
            xx = x0i + dx
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            flat = img + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
            flat, wgt = torch.broadcast_tensors(flat, wy * wx * valid)
            v = rows.index_select(0, flat.reshape(-1)).reshape(
                *flat.shape, rows.shape[1])
            out = out + v * wgt[..., None]
    return out


def _div(a, b):
    """``a / b`` rounded as a true division on every device: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python scalar divisor (1 ulp
    off for a divisor such as 7), so the divisor goes in as a tensor of
    ``a``'s dtype on ``a``'s device (the JAX ops, run eagerly, divide)."""
    return a / torch.full((), float(b), dtype=a.dtype, device=a.device)


def _rows(x):
    """``x`` (N, C, H, W) as its channels-last rows ``(N*H*W, C)``."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _box_batch_index(boxes_num, total: int, device):
    """(num_boxes,) image index of each box from the per-image counts."""
    counts = np.asarray(boxes_num.cpu() if isinstance(boxes_num, torch.Tensor)
                        else boxes_num).astype(np.int64).reshape(-1)
    enforce(int(counts.sum()) == int(total),
            f"sum(boxes_num)={int(counts.sum())} must equal the number of "
            f"boxes {int(total)}")
    return torch.from_numpy(np.repeat(np.arange(len(counts)), counts)).to(
        device)


_ROI_ALIGN_WARNED = False


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True):
    """Mask R-CNN RoIAlign: ``(num_boxes, C, ph, pw)``, each bin the mean
    of ``sampling_ratio`` x ``sampling_ratio`` bilinear samples.

    ``sampling_ratio=-1`` is the JAX package's fixed grid of **2 x 2
    samples a bin** (Paddle's adaptive ``ceil(roi_size / pooled_size)``
    grid has a data-dependent shape).  RoIs larger than ``2 *
    output_size`` feature pixels are under-sampled against Paddle; a
    one-time ``RuntimeWarning`` says so when such boxes come from the host
    (a CPU tensor or an array: boxes on the card are not read back for
    it)."""
    ph, pw = _pair(output_size)
    x = _tensor(x)
    boxes = _tensor(boxes, x.device, torch.float32)
    img = _box_batch_index(boxes_num, boxes.shape[0], x.device)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    global _ROI_ALIGN_WARNED
    if (sampling_ratio <= 0 and not _ROI_ALIGN_WARNED
            and boxes.device.type == "cpu" and boxes.numel()):
        b = boxes.numpy()
        if (np.any((b[:, 2] - b[:, 0]) * spatial_scale > 2.0 * pw)
                or np.any((b[:, 3] - b[:, 1]) * spatial_scale > 2.0 * ph)):
            _ROI_ALIGN_WARNED = True
            import warnings
            warnings.warn(
                "roi_align(sampling_ratio=-1) uses a fixed 2x2 sample grid "
                "per bin; at least one RoI exceeds 2x the pooled output "
                "size and is under-sampled against Paddle's adaptive grid "
                "- pass an explicit sampling_ratio to match",
                RuntimeWarning, stacklevel=2)
    H, W = x.shape[2], x.shape[3]
    b = boxes * spatial_scale - off
    x1, y1, x2, y2 = (b[:, i].reshape(-1, 1, 1, 1, 1) for i in range(4))
    rw = torch.clamp(x2 - x1, min=1e-6 if aligned else 1.0)
    rh = torch.clamp(y2 - y1, min=1e-6 if aligned else 1.0)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    f32 = dict(device=x.device, dtype=torch.float32)
    iy = torch.arange(ph, **f32).reshape(1, ph, 1, 1, 1)
    ix = torch.arange(pw, **f32).reshape(1, 1, pw, 1, 1)
    sy = torch.arange(sr, **f32).reshape(1, 1, 1, sr, 1)
    sx = torch.arange(sr, **f32).reshape(1, 1, 1, 1, sr)
    ys = y1 + (iy + _div(sy + 0.5, sr)) * bin_h       # (B, ph, 1, sr, 1)
    xs = x1 + (ix + _div(sx + 0.5, sr)) * bin_w       # (B, 1, pw, 1, sr)
    vals = _bilinear_rows(_rows(x), img.reshape(-1, 1, 1, 1, 1), ys, xs,
                          H, W)                       # (B, ph, pw, sr, sr, C)
    return vals.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0):
    """Fast R-CNN RoIPool: the max over each quantised bin, ``(num_boxes,
    C, ph, pw)``.  Bin edges come from the unclipped rounded RoI, then
    each bin's pixel range is clipped to the image; an empty bin is 0 (the
    JAX ``roi_pool``)."""
    ph, pw = _pair(output_size)
    x = _tensor(x)
    n_img, C, H, W = x.shape
    boxes = _tensor(boxes, x.device, torch.float32)
    img = _box_batch_index(boxes_num, boxes.shape[0], x.device)
    nb = boxes.shape[0]
    q = torch.round(boxes * spatial_scale)
    x1, y1, x2, y2 = (q[:, i:i + 1] for i in range(4))
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    # times the float32 reciprocal, as XLA compiles the JAX op's division
    # by the pooled size (its boxes run under lax.map, jitted): the bin
    # edges are ceilings, and 3 * (7 * (1/3)) rounds above 7
    bin_h, bin_w = rh * (1.0 / ph), rw * (1.0 / pw)
    f32 = dict(device=x.device, dtype=torch.float32)
    iy = torch.arange(ph, **f32)[None]
    ix = torch.arange(pw, **f32)[None]
    hs = torch.clamp(y1 + torch.floor(iy * bin_h), 0, H).long()   # (B, ph)
    he = torch.clamp(y1 + torch.ceil((iy + 1) * bin_h), 0, H).long()
    ws = torch.clamp(x1 + torch.floor(ix * bin_w), 0, W).long()   # (B, pw)
    we = torch.clamp(x1 + torch.ceil((ix + 1) * bin_w), 0, W).long()
    out = x.new_zeros(nb, ph, pw, C)
    if nb == 0:
        return out.permute(0, 3, 1, 2)
    span_h = (he - hs).amax(1).clamp(min=1)
    span_w = (we - ws).amax(1).clamp(min=1)
    spans = torch.stack([span_h, span_w], 1).cpu().numpy()
    order = np.argsort(spans[:, 0] * spans[:, 1], kind="stable")
    rows = _rows(x)
    start = 0
    while start < nb:
        # the largest run of boxes (by span) whose windows fit one chunk
        stop = start + 1
        sh, sw = spans[order[start]]
        while stop < nb:
            nh, nw = np.maximum((sh, sw), spans[order[stop]])
            if (stop + 1 - start) * ph * pw * nh * nw * C > _ROI_POOL_CHUNK:
                break
            sh, sw, stop = nh, nw, stop + 1
        sel = torch.from_numpy(order[start:stop]).to(x.device)
        b_hs, b_he = hs[sel], he[sel]
        b_ws, b_we = ws[sel], we[sel]
        r = torch.minimum(b_hs[:, :, None] + torch.arange(
            int(sh), device=x.device), (b_he - 1).clamp(min=0)[:, :, None])
        c = torch.minimum(b_ws[:, :, None] + torch.arange(
            int(sw), device=x.device), (b_we - 1).clamp(min=0)[:, :, None])
        r = r.clamp(max=H - 1)
        c = c.clamp(max=W - 1)
        flat = (img[sel].reshape(-1, 1, 1, 1, 1) * (H * W)
                + r[:, :, None, :, None] * W + c[:, None, :, None, :])
        win = rows.index_select(0, flat.reshape(-1)).reshape(
            *flat.shape, C)                          # (b, ph, pw, sh, sw, C)
        best = win.amax(dim=(3, 4))
        empty = ((b_he <= b_hs)[:, :, None] | (b_we <= b_ws)[:, None, :])
        out = out.index_put((sel,), torch.where(
            empty[..., None], torch.zeros_like(best), best))
        start = stop
    return out.permute(0, 3, 1, 2)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0):
    """Position-sensitive RoI pooling: ``x`` has C = out_channels * ph * pw
    and bin (i, j) averages its own channel group (channel c of bin (i, j)
    is ``c * ph * pw + i * pw + j``) over 4 x 4 samples at floored
    positions clipped into the image: ``(num_boxes, out_channels, ph,
    pw)``."""
    ph, pw = _pair(output_size)
    x = _tensor(x)
    n_img, C, H, W = x.shape
    enforce(C % (ph * pw) == 0,
            f"psroi_pool needs channels {C} divisible by {ph * pw}")
    out_c = C // (ph * pw)
    boxes = _tensor(boxes, x.device, torch.float32)
    img = _box_batch_index(boxes_num, boxes.shape[0], x.device)
    sr = 4
    b = boxes * spatial_scale
    x1, y1, x2, y2 = (b[:, i].reshape(-1, 1, 1, 1, 1) for i in range(4))
    rh = torch.clamp(y2 - y1, min=0.1)
    rw = torch.clamp(x2 - x1, min=0.1)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    f32 = dict(device=x.device, dtype=torch.float32)
    iy = torch.arange(ph, **f32).reshape(1, ph, 1, 1, 1)
    ix = torch.arange(pw, **f32).reshape(1, 1, pw, 1, 1)
    sy = torch.arange(sr, **f32).reshape(1, 1, 1, sr, 1)
    sx = torch.arange(sr, **f32).reshape(1, 1, 1, 1, sr)
    ys = torch.floor(y1 + iy * bin_h + _div(sy + 0.5, sr) * bin_h)
    xs = torch.floor(x1 + ix * bin_w + _div(sx + 0.5, sr) * bin_w)
    yc = ys.clamp(0, H - 1).long()                   # (B, ph, 1, sr, 1)
    xc = xs.clamp(0, W - 1).long()                   # (B, 1, pw, 1, sr)
    dev = x.device
    chan = (torch.arange(out_c, device=dev).reshape(out_c, 1, 1) * (ph * pw)
            + torch.arange(ph, device=dev).reshape(1, ph, 1) * pw
            + torch.arange(pw, device=dev).reshape(1, 1, pw))
    flat = (img.reshape(-1, 1, 1, 1, 1, 1) * (C * H * W)
            + chan.reshape(1, out_c, ph, pw, 1, 1) * (H * W)
            + yc[:, None, :, :, :, :] * W + xc[:, None, :, :, :, :])
    vals = x.reshape(-1).index_select(0, flat.reshape(-1)).reshape(
        flat.shape)                                  # (B, oc, ph, pw, sr, sr)
    return vals.mean(dim=(4, 5))


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale: float = 1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(RoIAlign):
    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(RoIAlign):
    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------
def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def nms_mask(boxes, scores=None, iou_threshold: float = 0.3):
    """Greedy NMS as an (N,) bool keep mask on the boxes' device.

    Boxes are visited in descending score order (ties in index order); a
    box is kept iff it overlaps (IoU > threshold) no higher-ranked kept
    box.  The sweep is a fixed-point iteration over the whole mask,
    each pass one (N, N) reduction, with one readback a pass to stop."""
    boxes = _tensor(boxes, dtype=torch.float32)
    n = boxes.shape[0]
    dev = boxes.device
    order = (torch.argsort(-_tensor(scores, dev, torch.float32), stable=True)
             if scores is not None else torch.arange(n, device=dev))
    overlap = _iou_matrix(boxes[order]) > iou_threshold
    # row i: the higher-ranked boxes that i overlaps
    overlap &= torch.ones(n, n, dtype=torch.bool, device=dev).tril(-1)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(n + 1):
        new = ~(overlap & keep[None, :]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros(n, dtype=torch.bool, device=dev).index_put(
        (order,), keep)


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None):
    """Greedy NMS returning the kept indices, by descending score when
    ``scores`` are given (as the JAX ``nms``: ``np.argsort(-scores)`` of
    the kept boxes on the host), at most ``top_k``; with
    ``category_idxs`` each category is offset by ``max(boxes) + 1`` so
    that categories never suppress each other.  The indices are int64 on
    the boxes' device (the JAX function returns int32)."""
    boxes = _tensor(boxes, dtype=torch.float32)
    if category_idxs is not None:
        enforce(categories is not None,
                "categories must accompany category_idxs")
        span = boxes.max() + 1.0
        offsets = _tensor(category_idxs, boxes.device,
                          torch.float32)[:, None] * span
        shifted = boxes + offsets
    else:
        shifted = boxes
    keep = nms_mask(shifted, scores, iou_threshold).cpu().numpy()
    idx = np.nonzero(keep)[0]
    if scores is not None:
        s = (scores.detach().cpu().numpy() if isinstance(scores, torch.Tensor)
             else np.asarray(scores))[idx]
        idx = idx[np.argsort(-s)]
    if top_k is not None:
        idx = idx[:top_k]
    return torch.from_numpy(idx.astype(np.int64)).to(boxes.device)


# ---------------------------------------------------------------------------
# YOLO decode
# ---------------------------------------------------------------------------
def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float,
             downsample_ratio: int, clip_bbox: bool = True,
             scale_x_y: float = 1.0, iou_aware: bool = False,
             iou_aware_factor: float = 0.5):
    """Decode a YOLOv3 head to ``(boxes (N, A*H*W, 4) xyxy, scores (N,
    A*H*W, class_num))``.  ``x`` is (N, A*(5+cls), H, W), or (N,
    A*(6+cls), H, W) with ``iou_aware`` (the leading A channels the IoU
    logits; confidence ``obj^(1-f) * iou^f``).  A confidence not above
    ``conf_thresh`` zeroes its box and scores."""
    x = _tensor(x)
    n, c, h, w = x.shape
    a = len(anchors) // 2
    anchors_arr = _tensor(anchors, x.device, torch.float32).reshape(a, 2)
    img_size = _tensor(img_size, x.device, torch.float32)   # (N, 2) h, w
    if iou_aware:
        enforce(c == a * (6 + class_num),
                f"iou_aware yolo_box expects {a * (6 + class_num)} "
                f"channels, got {c}")
        iou = torch.sigmoid(x[:, :a])
        x = x[:, a:]
    else:
        enforce(c == a * (5 + class_num),
                f"yolo_box expects {a * (5 + class_num)} channels, got {c}")
    feats = x.reshape(n, a, 5 + class_num, h, w)
    tx, ty = feats[:, :, 0], feats[:, :, 1]
    tw, th = feats[:, :, 2], feats[:, :, 3]
    obj = torch.sigmoid(feats[:, :, 4])
    if iou_aware:
        obj = (obj ** (1.0 - iou_aware_factor)) * (iou ** iou_aware_factor)
    cls_prob = torch.sigmoid(feats[:, :, 5:])

    f32 = dict(device=x.device, dtype=torch.float32)
    gx = torch.arange(w, **f32).reshape(1, 1, 1, w)
    gy = torch.arange(h, **f32).reshape(1, 1, h, 1)
    bias = 0.5 * (scale_x_y - 1.0)
    cx = _div(torch.sigmoid(tx) * scale_x_y - bias + gx, w)
    cy = _div(torch.sigmoid(ty) * scale_x_y - bias + gy, h)
    input_h = downsample_ratio * h
    input_w = downsample_ratio * w
    bw = _div(torch.exp(tw) * anchors_arr[:, 0].reshape(1, a, 1, 1), input_w)
    bh = _div(torch.exp(th) * anchors_arr[:, 1].reshape(1, a, 1, 1), input_h)

    im_h = img_size[:, 0].reshape(n, 1, 1, 1)
    im_w = img_size[:, 1].reshape(n, 1, 1, 1)
    x1 = (cx - bw / 2) * im_w
    y1 = (cy - bh / 2) * im_h
    x2 = (cx + bw / 2) * im_w
    y2 = (cy + bh / 2) * im_h
    if clip_bbox:
        x1 = torch.minimum(torch.clamp(x1, min=0), im_w - 1)
        y1 = torch.minimum(torch.clamp(y1, min=0), im_h - 1)
        x2 = torch.minimum(torch.clamp(x2, min=0), im_w - 1)
        y2 = torch.minimum(torch.clamp(y2, min=0), im_h - 1)

    conf = obj[..., None] * torch.movedim(cls_prob, 2, -1)  # (n,a,h,w,cls)
    mask = (obj > conf_thresh)[..., None]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * mask
    scores = conf * mask
    return (boxes.reshape(n, a * h * w, 4),
            scores.reshape(n, a * h * w, class_num))


# ---------------------------------------------------------------------------
# Deformable convolution
# ---------------------------------------------------------------------------
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups: int = 1, groups: int = 1,
                  mask=None):
    """Deformable convolution, v1, or v2 when ``mask`` is given.

    x: (N, Cin, H, W); offset: (N, 2*kh*kw, Ho, Wo) as (dy, dx) pairs a
    tap; mask: (N, kh*kw, Ho, Wo); weight: (Cout, Cin, kh, kw).  Each tap
    is a bilinear gather of the channels-last rows at its shifted
    position (0 outside the image), then one product with the kernel
    over (tap, channel).  ``groups`` and ``deformable_groups`` must be 1,
    as in the JAX op."""
    x = _tensor(x)
    offset = _tensor(offset)
    weight = _tensor(weight)
    enforce(groups == 1 and deformable_groups == 1,
            "deform_conv2d: groups/deformable_groups > 1 not supported "
            "in this build")
    n, cin, H, W = x.shape
    cout, _, kh, kw = weight.shape
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    ho = (H + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    wo = (W + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    enforce(offset.shape[1] == 2 * kh * kw,
            f"offset channels {offset.shape[1]} != 2*kh*kw {2 * kh * kw}")
    dev = x.device
    oy = torch.arange(ho, device=dev) * s[0] - p[0]
    ox = torch.arange(wo, device=dev) * s[1] - p[1]
    ky = torch.arange(kh, device=dev) * d[0]
    kx = torch.arange(kw, device=dev) * d[1]
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).to(
        offset.dtype)                                # (ho, 1, kh, 1)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).to(
        offset.dtype)                                # (1, wo, 1, kw)
    off = offset.reshape(n, kh, kw, 2, ho, wo)
    dy = off[:, :, :, 0].permute(0, 3, 4, 1, 2)      # (n, ho, wo, kh, kw)
    dx = off[:, :, :, 1].permute(0, 3, 4, 1, 2)
    ys = base_y[None] + dy
    xs = base_x[None] + dx
    img = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1)
    cols = _bilinear_rows(_rows(x), img, ys, xs, H, W)  # (n,ho,wo,kh,kw,C)
    if mask is not None:
        m = _tensor(mask).reshape(n, kh, kw, ho, wo).permute(0, 3, 4, 1, 2)
        cols = cols * m[..., None]
    wmat = weight.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    out = cols.reshape(n * ho * wo, kh * kw * cin) @ wmat.t()
    out = out.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)
    if bias is not None:
        out = out + _tensor(bias).reshape(1, -1, 1, 1)
    return out


class DeformConv2D(Layer):
    """Learnable ``weight`` (Cout, Cin/groups, kh, kw) and ``bias``, both
    ``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (``bias_attr=False`` for
    none); offset (and mask) come in at call time from a companion conv.
    Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, deformable_groups=1,
                 groups=1, weight_attr=None, bias_attr=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        k = _pair(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._dg, self._groups = deformable_groups, groups
        fan_in = in_channels * k[0] * k[1] // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = I.create_parameter(
            (out_channels, in_channels // groups, k[0], k[1]),
            default_initializer=I.Uniform(-bound, bound), attr=weight_attr,
            device=dev)
        self.bias = (None if bias_attr is False else I.create_parameter(
            (out_channels,), is_bias=True,
            default_initializer=I.Uniform(-bound, bound), attr=bias_attr,
            device=dev))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self._stride, self._padding, self._dilation,
                             self._dg, self._groups, mask)


# ---------------------------------------------------------------------------
# image IO (host side)
# ---------------------------------------------------------------------------
def read_file(filename: str, device=None):
    """The file's bytes as a uint8 tensor on ``device`` (None means
    ``cuda``)."""
    dev = resolve_device(device)
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).copy()
    return torch.from_numpy(data).to(dev)


def decode_jpeg(x, mode: str = "unchanged", device=None):
    """Decode a JPEG byte tensor to (C, H, W) uint8 on the host with PIL
    (``mode`` ``"unchanged"``, ``"gray"`` or ``"rgb"``), the result on
    ``device`` (None means ``cuda``)."""
    import io

    from PIL import Image

    dev = resolve_device(device)
    raw = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    img = Image.open(io.BytesIO(raw.tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else np.transpose(arr, (2, 0, 1))
    return torch.from_numpy(np.array(arr)).to(dev)


# ---------------------------------------------------------------------------
# YOLOv3 loss
# ---------------------------------------------------------------------------
def _bce(logit, target):
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num: int,
              ignore_thresh: float, downsample_ratio: int, gt_score=None,
              use_label_smooth: bool = True, name=None,
              scale_x_y: float = 1.0):
    """The YOLOv3 training loss, (N,): per image the sum of the location
    terms (BCE on x / y, L1 on w / h, weighted by 2 - w*h), objectness
    (BCE; negatives whose best IoU with a ground-truth box exceeds
    ``ignore_thresh`` are ignored) and class BCE (label smoothing
    ``1/class_num``).

    x: (N, A*(5+C), H, W); gt_box: (N, B, 4) normalised center-xywh;
    gt_label: (N, B) (boxes of zero width or height are padding);
    anchors: pixel pairs of every anchor; anchor_mask: this head's.  A
    ground-truth box belongs to the anchor of best wh-IoU over all anchors
    (the first on ties), and to this head if that anchor is in its
    mask."""
    x = _tensor(x)
    dev = x.device
    gt_box = _tensor(gt_box, dev, torch.float32)
    gt_label = _tensor(gt_label, dev, torch.int64)
    n, c, h, w = x.shape
    a = len(anchor_mask)
    enforce(c == a * (5 + class_num),
            f"yolo_loss expects {a * (5 + class_num)} channels, got {c}")
    all_anchors = _tensor(anchors, dev, torch.float32).reshape(-1, 2)
    mask_arr = _tensor(anchor_mask, dev, torch.int64)
    mask_anchors = all_anchors[mask_arr]
    input_h = float(downsample_ratio * h)
    input_w = float(downsample_ratio * w)
    b = gt_box.shape[1]
    gt_score = (torch.ones(n, b, device=dev) if gt_score is None
                else _tensor(gt_score, dev, torch.float32))

    feats = x.reshape(n, a, 5 + class_num, h, w)
    px, py = feats[:, :, 0], feats[:, :, 1]
    pw, ph = feats[:, :, 2], feats[:, :, 3]
    pobj = feats[:, :, 4]
    pcls = feats[:, :, 5:]

    valid = (gt_box[:, :, 2] > 0) & (gt_box[:, :, 3] > 0)   # (n, b)

    # the responsible anchor of each box: best wh-IoU over every anchor
    gw = gt_box[:, :, 2] * input_w
    gh = gt_box[:, :, 3] * input_h
    inter = (torch.minimum(gw[:, :, None], all_anchors[:, 0])
             * torch.minimum(gh[:, :, None], all_anchors[:, 1]))
    union = ((gw * gh)[:, :, None]
             + (all_anchors[:, 0] * all_anchors[:, 1]) - inter)
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=2)
    in_head = best[:, :, None] == mask_arr                   # (n, b, a)
    head_slot = torch.where(in_head.any(2),
                            torch.argmax(in_head.to(torch.int32), 2), -1)
    responsible = valid & (head_slot >= 0)

    gi = torch.clamp((gt_box[:, :, 0] * w).to(torch.int64), 0, w - 1)
    gj = torch.clamp((gt_box[:, :, 1] * h).to(torch.int64), 0, h - 1)

    # targets scattered over the (n, a, h, w) grid
    slot = torch.where(responsible, head_slot, 0)
    ni = torch.arange(n, device=dev)[:, None].expand(n, b)
    sel = (ni, slot, gj, gi)
    on = responsible.to(torch.float32)

    def scat(values):
        z = torch.zeros(n, a, h, w, device=dev)
        return z.index_put(sel, values * on, accumulate=True)

    obj_t = scat(gt_score)
    obj_pos = scat(torch.ones_like(gt_score))
    tx = scat(gt_box[:, :, 0] * w - gi.to(torch.float32))
    ty = scat(gt_box[:, :, 1] * h - gj.to(torch.float32))
    aw = mask_anchors[slot, 0]
    ah = mask_anchors[slot, 1]
    tw = scat(torch.log(torch.clamp(gw / torch.clamp(aw, min=1e-9),
                                    min=1e-9)))
    th = scat(torch.log(torch.clamp(gh / torch.clamp(ah, min=1e-9),
                                    min=1e-9)))
    # box-scale weight 2 - w*h de-emphasises large boxes
    bweight = scat(2.0 - gt_box[:, :, 2] * gt_box[:, :, 3])

    delta = 1.0 / class_num if use_label_smooth and class_num > 1 else 0.0
    lbl = torch.clamp(gt_label, 0, class_num - 1)
    cls_t = torch.zeros(n, a, class_num, h, w, device=dev).index_put(
        (ni, slot, lbl, gj, gi), on, accumulate=True)
    cls_t = torch.clamp(cls_t, 0.0, 1.0)
    if delta:
        cls_t = cls_t * (1.0 - delta) + delta / class_num

    pos = obj_pos
    loss_xy = pos * bweight * (_bce(px, tx) + _bce(py, ty))
    loss_wh = pos * bweight * 0.5 * (torch.abs(pw - tw) + torch.abs(ph - th))

    # the ignore mask: negatives that overlap a box beyond the threshold
    f32 = dict(device=dev, dtype=torch.float32)
    gx_grid = torch.arange(w, **f32).reshape(1, 1, 1, w)
    gy_grid = torch.arange(h, **f32).reshape(1, 1, h, 1)
    bias = 0.5 * (scale_x_y - 1.0)
    cx = _div(torch.sigmoid(px) * scale_x_y - bias + gx_grid, w)
    cy = _div(torch.sigmoid(py) * scale_x_y - bias + gy_grid, h)
    bw = _div(torch.exp(torch.clamp(pw, -10, 10))
              * mask_anchors[:, 0].reshape(1, a, 1, 1), input_w)
    bh = _div(torch.exp(torch.clamp(ph, -10, 10))
              * mask_anchors[:, 1].reshape(1, a, 1, 1), input_h)
    p1 = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                     dim=-1)                         # (n, a, h, w, 4)
    g1 = torch.stack([gt_box[:, :, 0] - gt_box[:, :, 2] / 2,
                      gt_box[:, :, 1] - gt_box[:, :, 3] / 2,
                      gt_box[:, :, 0] + gt_box[:, :, 2] / 2,
                      gt_box[:, :, 1] + gt_box[:, :, 3] / 2], dim=-1)
    px1 = p1[:, :, :, :, None, :]
    gb1 = g1[:, None, None, None, :, :]
    iw = torch.clamp(torch.minimum(px1[..., 2], gb1[..., 2])
                     - torch.maximum(px1[..., 0], gb1[..., 0]), min=0)
    ih = torch.clamp(torch.minimum(px1[..., 3], gb1[..., 3])
                     - torch.maximum(px1[..., 1], gb1[..., 1]), min=0)
    inter2 = iw * ih
    area_p = (px1[..., 2] - px1[..., 0]) * (px1[..., 3] - px1[..., 1])
    area_g = (gb1[..., 2] - gb1[..., 0]) * (gb1[..., 3] - gb1[..., 1])
    iou = inter2 / torch.clamp(area_p + area_g - inter2, min=1e-9)
    iou = torch.where(valid[:, None, None, None, :], iou,
                      torch.zeros((), dtype=iou.dtype, device=dev))
    best_iou = iou.amax(dim=-1)                      # (n, a, h, w)
    noobj_mask = ((best_iou <= ignore_thresh) & (pos == 0)).to(torch.float32)

    loss_obj = (pos * obj_t * _bce(pobj, torch.ones_like(pobj))
                + noobj_mask * _bce(pobj, torch.zeros_like(pobj)))
    loss_cls = pos[:, :, None] * _bce(pcls, cls_t)

    return (loss_xy.sum(dim=(1, 2, 3)) + loss_wh.sum(dim=(1, 2, 3))
            + loss_obj.sum(dim=(1, 2, 3)) + loss_cls.sum(dim=(1, 2, 3, 4)))
