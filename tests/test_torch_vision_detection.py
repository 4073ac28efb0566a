"""Port parity of the detection ops (``paddle_tpu_torch/vision/ops.py``)
on the CPU, against the JAX package's ``paddle_tpu/vision/ops.py`` on the
same numpy inputs, float32 on both sides, the JAX side eager:

- ``roi_align`` (``sampling_ratio`` -1, the JAX fixed 2 x 2 grid, and 3;
  ``aligned`` both ways), ``roi_pool`` (boxes across the image's edge,
  empty bins) and ``psroi_pool``, and their layers: values, and the
  gradient with respect to ``x`` of a seeded cotangent;
- ``nms``: kept indices equal, with tied scores, without scores, with
  categories and ``top_k``; ``nms_mask`` equal; the indices are int64
  where JAX gives int32 (pinned);
- ``yolo_box``, plain and ``iou_aware``, clipped or not, with
  ``scale_x_y``: boxes and scores;
- ``yolo_loss``: the loss and its gradient with respect to ``x``; the
  assignments exact: the cells whose w / h logits get a gradient (the
  responsible anchors) and those whose objectness logit gets one (the
  responsible and the not-ignored negatives) are the same cells;
- ``deform_conv2d`` v1 and v2 (``mask``), strided and dilated, and
  ``DeformConv2D``'s state dict: values and the gradients with respect to
  x, offset, mask, weight and bias;
- ``read_file`` / ``decode_jpeg`` on a JPEG that PIL writes to the test's
  directory (the same bytes and pixels as JAX's).

Tolerances: values within 1e-5 of each tensor's range (the same float32
arithmetic, summed in another order), gradients within 1e-4 of theirs (the
port's are scatter-adds of the gathers); indices, masks, assignments and
decoded pixels exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.vision import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work.  Under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores and spin: six translation recipes run at once took 916 s
    each with eight threads and 5 s each with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VALUE_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, ref, what, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()), 1e-6)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _value_and_grads(jfn, tfn, arrays, seed=7):
    """Values of both functions on the numpy ``arrays`` and the gradients
    of ``sum(out * g)`` (g seeded) with respect to each array."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    g = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    tout = tfn(*targs)
    (tout * torch.from_numpy(g)).sum().backward()
    return (tout.detach(), np.asarray(jout),
            [t.grad for t in targs], [np.asarray(j) for j in jgrads])


def _check(jfn, tfn, arrays, names):
    tout, jout, tgrads, jgrads = _value_and_grads(jfn, tfn, arrays)
    _close(tout, jout, "value", VALUE_TOL)
    for name, t, j in zip(names, tgrads, jgrads):
        _close(t, j, f"grad {name}", GRAD_TOL)


def _rois(seed, n, h, w, scale):
    """``n`` boxes (x1, y1, x2, y2) in image pixels of an ``h`` x ``w``
    map at ``scale``: sizes from a pixel to past the map, some across its
    edges."""
    r = np.random.RandomState(seed)
    x1 = r.uniform(-4, w / scale - 2, n)
    y1 = r.uniform(-4, h / scale - 2, n)
    bw = r.uniform(0.5, w / scale * 0.9, n)
    bh = r.uniform(0.5, h / scale * 0.9, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


FEAT = np.random.RandomState(1).randn(2, 4, 12, 14).astype(np.float32)
BOXES = _rois(2, 9, 12, 14, 0.5)
BOXES_NUM = [5, 4]


@pytest.mark.parametrize("sampling_ratio,aligned", [(-1, True), (3, True),
                                                    (-1, False)])
def test_roi_align_matches_jax(sampling_ratio, aligned):
    def jfn(x):
        return jops.roi_align(x, BOXES, BOXES_NUM, (3, 4), 0.5,
                              sampling_ratio, aligned)

    def tfn(x):
        return tops.roi_align(x, torch.from_numpy(BOXES), BOXES_NUM, (3, 4),
                              0.5, sampling_ratio, aligned)
    _check(jfn, tfn, [FEAT], ["x"])


def test_roi_pool_matches_jax():
    # a box wholly outside the map gives empty bins (0 and no gradient)
    boxes = np.concatenate([BOXES, [[40.0, 30.0, 60.0, 50.0]]]).astype(
        np.float32)

    def jfn(x):
        return jops.roi_pool(x, boxes, [5, 5], 3, 0.5)

    def tfn(x):
        return tops.roi_pool(x, torch.from_numpy(boxes), [5, 5], 3, 0.5)
    tout, jout, tgrads, jgrads = _value_and_grads(jfn, tfn, [FEAT])
    np.testing.assert_array_equal(tout.numpy(), jout)   # maxima are exact
    assert not tout[-1].any()
    _close(tgrads[0], jgrads[0], "grad x", GRAD_TOL)


def test_roi_pool_chunks_agree(monkeypatch):
    """The chunked reduction: one box a chunk gives the same values."""
    x = torch.from_numpy(FEAT)
    whole = tops.roi_pool(x, torch.from_numpy(BOXES), BOXES_NUM, 3, 0.5)
    monkeypatch.setattr(tops, "_ROI_POOL_CHUNK", 1)
    assert torch.equal(tops.roi_pool(x, torch.from_numpy(BOXES), BOXES_NUM,
                                     3, 0.5), whole)


def test_psroi_pool_matches_jax():
    x = np.random.RandomState(3).randn(2, 2 * 3 * 3, 10, 12).astype(
        np.float32)
    boxes = _rois(4, 7, 10, 12, 0.5)

    def jfn(x):
        return jops.psroi_pool(x, boxes, [3, 4], 3, 0.5)

    def tfn(x):
        return tops.psroi_pool(x, torch.from_numpy(boxes), [3, 4], 3, 0.5)
    _check(jfn, tfn, [x], ["x"])


def test_roi_layers_are_the_functions():
    x, b = torch.from_numpy(FEAT), torch.from_numpy(BOXES)
    for layer, fn in ((tops.RoIAlign, tops.roi_align),
                      (tops.RoIPool, tops.roi_pool)):
        assert torch.equal(layer(2, 0.5)(x, b, BOXES_NUM),
                           fn(x, b, BOXES_NUM, 2, 0.5))
    xp = torch.randn(2, 8, 6, 6)
    assert torch.equal(tops.PSRoIPool(2, 0.5)(xp, b, BOXES_NUM),
                       tops.psroi_pool(xp, b, BOXES_NUM, 2, 0.5))


def test_roi_align_warns_once_for_large_boxes(monkeypatch):
    monkeypatch.setattr(tops, "_ROI_ALIGN_WARNED", False)
    big = np.array([[0, 0, 30, 30]], np.float32)
    with pytest.warns(RuntimeWarning, match="2x2"):
        tops.roi_align(torch.from_numpy(FEAT[:1]), torch.from_numpy(big),
                       [1], 2, 0.5)
    assert tops._ROI_ALIGN_WARNED


def _nms_boxes(seed, n):
    """Clusters of overlapping boxes, with repeated scores."""
    r = np.random.RandomState(seed)
    centers = r.uniform(10, 90, (n // 6 + 1, 2))
    c = centers[r.randint(0, len(centers), n)] + r.randn(n, 2) * 3
    wh = r.uniform(8, 20, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = np.round(r.uniform(0, 1, n), 1).astype(np.float32)   # ties
    return boxes, scores


@pytest.mark.parametrize("kw", [
    {"iou_threshold": 0.3}, {"iou_threshold": 0.5, "use_scores": True},
    {"iou_threshold": 0.5, "use_scores": True, "top_k": 7},
    {"iou_threshold": 0.4, "use_scores": True, "categories": 4},
    {"iou_threshold": 0.4, "use_scores": True, "categories": 4, "top_k": 5},
], ids=["boxes", "scores", "top_k", "categories", "categories_top_k"])
def test_nms_indices_match_jax(kw):
    boxes, scores = _nms_boxes(5, 60)
    args = {"iou_threshold": kw["iou_threshold"], "top_k": kw.get("top_k")}
    if kw.get("use_scores"):
        args["scores"] = scores
    if "categories" in kw:
        cats = np.random.RandomState(6).randint(0, kw["categories"], 60)
        args.update(category_idxs=cats,
                    categories=list(range(kw["categories"])))
    jidx = np.asarray(jops.nms(jnp.asarray(boxes), **args))
    targs = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in args.items()}
    tidx = tops.nms(torch.from_numpy(boxes), **targs)
    assert tidx.dtype == torch.int64 and jidx.dtype == np.int32
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    assert 0 < len(jidx) < 60


def test_nms_mask_matches_jax():
    boxes, scores = _nms_boxes(8, 90)
    for thr in (0.2, 0.5, 0.8):
        jm = np.asarray(jops.nms_mask(jnp.asarray(boxes),
                                      jnp.asarray(scores), thr))
        tm = tops.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                           thr)
        np.testing.assert_array_equal(tm.numpy(), jm)


ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
           198, 373, 326]


@pytest.mark.parametrize("iou_aware,clip,scale_x_y", [
    (False, True, 1.0), (False, False, 1.05), (True, True, 1.0)])
def test_yolo_box_matches_jax(iou_aware, clip, scale_x_y):
    a, cls = 3, 4
    c = a * (6 + cls) if iou_aware else a * (5 + cls)
    x = np.random.RandomState(9).randn(2, c, 5, 6).astype(np.float32)
    img = np.array([[160, 192], [150, 200]], np.float32)
    anchors = ANCHORS[:6]
    jb, js = jops.yolo_box(x, img, anchors, cls, 0.4, 32, clip, scale_x_y,
                           iou_aware, 0.4)
    tb, ts = tops.yolo_box(torch.from_numpy(x), torch.from_numpy(img),
                           anchors, cls, 0.4, 32, clip, scale_x_y, iou_aware,
                           0.4)
    _close(tb, jb, "boxes", VALUE_TOL)
    _close(ts, js, "scores", VALUE_TOL)
    np.testing.assert_array_equal(tb.numpy() == 0, np.asarray(jb) == 0)


def _yolo_inputs(seed, n=2, b=6, h=7, w=7, cls=5):
    r = np.random.RandomState(seed)
    x = (r.randn(n, 3 * (5 + cls), h, w) * 0.5).astype(np.float32)
    xy = r.uniform(0.05, 0.95, (n, b, 2))
    wh = r.uniform(0.02, 0.8, (n, b, 2))
    gt = np.concatenate([xy, wh], -1).astype(np.float32)
    gt[:, -2:] = 0.0                           # padding rows
    labels = r.randint(0, cls, (n, b))
    return x, gt, labels, r.uniform(0.5, 1.0, (n, b)).astype(np.float32)


@pytest.mark.parametrize("mask,smooth,score", [
    ([3, 4, 5], True, False), ([0, 1, 2], False, True),
    ([6, 7, 8], True, True)])
def test_yolo_loss_and_assignments_match_jax(mask, smooth, score):
    x, gt, labels, gt_score = _yolo_inputs(11)
    kw = dict(anchors=ANCHORS, anchor_mask=mask, class_num=5,
              ignore_thresh=0.5, downsample_ratio=32,
              use_label_smooth=smooth, scale_x_y=1.05)

    def jfn(x):
        return jops.yolo_loss(x, gt, labels,
                              gt_score=gt_score if score else None, **kw)

    def tfn(x):
        return tops.yolo_loss(x, torch.from_numpy(gt),
                              torch.from_numpy(labels),
                              gt_score=(torch.from_numpy(gt_score) if score
                                        else None), **kw)
    tout, jout, tgrads, jgrads = _value_and_grads(jfn, tfn, [x])
    _close(tout, jout, "loss", VALUE_TOL)
    _close(tgrads[0], jgrads[0], "grad x", GRAD_TOL)
    tg = tgrads[0].numpy().reshape(2, 3, 10, 7, 7)
    jg = jgrads[0].reshape(2, 3, 10, 7, 7)
    responsible = jg[:, :, 2] != 0
    np.testing.assert_array_equal(tg[:, :, 2] != 0, responsible)
    np.testing.assert_array_equal(tg[:, :, 4] != 0, jg[:, :, 4] != 0)
    if mask == [3, 4, 5]:
        assert responsible.any()


@pytest.mark.parametrize("stride,padding,dilation,v2,bias", [
    (1, 1, 1, True, True), (2, 1, 1, False, True), (1, 2, 2, True, False)])
def test_deform_conv2d_matches_jax(stride, padding, dilation, v2, bias):
    r = np.random.RandomState(12)
    n, cin, cout, h, w = 2, 3, 4, 7, 8
    ho = (h + 2 * padding - 2 * dilation - 1) // stride + 1
    wo = (w + 2 * padding - 2 * dilation - 1) // stride + 1
    x = r.randn(n, cin, h, w).astype(np.float32)
    offset = (r.randn(n, 18, ho, wo) * 1.5).astype(np.float32)
    weight = (r.randn(cout, cin, 3, 3) * 0.3).astype(np.float32)
    arrays = [x, offset, weight]
    if bias:
        arrays.append(r.randn(cout).astype(np.float32))
    if v2:
        arrays.append(r.uniform(0, 1, (n, 9, ho, wo)).astype(np.float32))

    def call(ops):
        def fn(x, offset, weight, *rest):
            b = rest[0] if bias else None
            m = rest[-1] if v2 else None
            return ops.deform_conv2d(x, offset, weight, b, stride, padding,
                                     dilation, mask=m)
        return fn
    names = ["x", "offset", "weight"] + (["bias"] if bias else []) + (
        ["mask"] if v2 else [])
    _check(call(jops), call(tops), arrays, names)


def test_deform_conv2d_layer_state_dict_matches_jax():
    jl = jops.DeformConv2D(3, 4, 3, padding=1)
    tl = tops.DeformConv2D(3, 4, 3, padding=1, device="cpu")
    jsd = {k: np.array(v) for k, v in jl.state_dict().items()}
    assert sorted(tl.state_dict()) == sorted(jsd)
    load_jax_state(tl, jsd)
    r = np.random.RandomState(13)
    x = r.randn(1, 3, 5, 5).astype(np.float32)
    off = r.randn(1, 18, 5, 5).astype(np.float32)
    with torch.no_grad():
        _close(tl(torch.from_numpy(x), torch.from_numpy(off)),
               jl(jnp.asarray(x), jnp.asarray(off)), "layer", VALUE_TOL)
    assert tops.DeformConv2D(3, 4, 3, bias_attr=False,
                             device="cpu").bias is None


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    from PIL import Image
    r = np.random.RandomState(14)
    path = str(tmp_path / "img.jpg")
    Image.fromarray(r.randint(0, 255, (17, 23, 3), np.uint8)).save(path)
    jraw = np.asarray(jops.read_file(path))
    traw = tops.read_file(path, device="cpu")
    assert traw.dtype == torch.uint8
    np.testing.assert_array_equal(traw.numpy(), jraw)
    for mode in ("unchanged", "gray", "rgb"):
        timg = tops.decode_jpeg(traw, mode, device="cpu")
        np.testing.assert_array_equal(timg.numpy(), np.asarray(
            jops.decode_jpeg(jraw, mode)))
    assert tuple(tops.decode_jpeg(traw, "gray", device="cpu").shape) == (
        1, 17, 23)


@pytest.mark.parametrize("make", [
    lambda: tops.DeformConv2D(3, 4, 3),
    lambda: tops.read_file(__file__),
    lambda: tops.decode_jpeg(np.zeros(4, np.uint8))])
def test_entry_points_need_a_card_unless_cpu_is_asked(make):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(UnavailableError):
        make()
