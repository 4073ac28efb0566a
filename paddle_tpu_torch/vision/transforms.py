"""Vision transforms: the port of ``paddle_tpu/vision/transforms.py``,
host-side numpy for the data pipeline.  Every random transform draws from
numpy's global RNG with the JAX module's calls in its order, so under one
``np.random.seed`` both give the same arrays."""
from __future__ import annotations

import numpy as np

__all__ = ["Compose", "Normalize", "ToTensor", "Resize", "RandomCrop",
           "RandomHorizontalFlip", "CenterCrop", "Transpose"]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean, std, data_format="CHW"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        if self.data_format == "CHW":
            shape = (-1,) + (1,) * (x.ndim - 1)
        else:
            shape = (1,) * (x.ndim - 1) + (-1,)
        return (x - self.mean.reshape(shape)) / self.std.reshape(shape)


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def __call__(self, x):
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        if x.ndim == 2:
            x = x[None]
        elif x.ndim == 3:
            x = x.transpose(2, 0, 1)
        return np.ascontiguousarray(x, np.float32)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, x):
        return np.asarray(x).transpose(self.order)


class Resize:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        x = np.asarray(x)
        hwc = x.ndim == 3
        h, w = (x.shape[0], x.shape[1])
        th, tw = self.size
        ys = (np.arange(th) * (h / th)).astype(np.int64)
        xs = (np.arange(tw) * (w / tw)).astype(np.int64)
        return x[ys][:, xs] if hwc or x.ndim == 2 else x


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        x = np.asarray(x)
        h, w = x.shape[0], x.shape[1]
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        return x[i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, x):
        x = np.asarray(x)
        if self.padding:
            pad = [(self.padding, self.padding), (self.padding, self.padding)]
            pad += [(0, 0)] * (x.ndim - 2)
            x = np.pad(x, pad)
        h, w = x.shape[0], x.shape[1]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return x[i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, x):
        if np.random.rand() < self.prob:
            return np.asarray(x)[:, ::-1].copy()
        return np.asarray(x)


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, x):
        if np.random.rand() < self.prob:
            return np.asarray(x)[::-1].copy()
        return np.asarray(x)


class Pad:
    """Pad HW(C) images (reference transforms Pad; constant mode)."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, int):
            padding = (padding, padding, padding, padding)  # l, t, r, b
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, x):
        x = np.asarray(x)
        l, t, r, b = self.padding
        pad = [(t, b), (l, r)] + [(0, 0)] * (x.ndim - 2)
        if self.padding_mode == "constant":
            return np.pad(x, pad, constant_values=self.fill)
        return np.pad(x, pad, mode=self.padding_mode)


class Grayscale:
    """RGB HWC -> grayscale with `num_output_channels` copies."""

    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def __call__(self, x):
        orig_dtype = np.asarray(x).dtype
        x = np.asarray(x, np.float32)
        g = np.clip(_rgb_to_gray(x), 0, 255)
        out = np.stack([g] * self.num_output_channels, axis=-1)
        return out.astype(np.uint8) if orig_dtype == np.uint8 else out


def _jitter_out(y, orig_dtype):
    """uint8 inputs clip back to uint8 [0,255]; float inputs stay float
    clipped to their natural [0,1] range."""
    if orig_dtype == np.uint8:
        return np.clip(y, 0, 255).astype(np.uint8)
    return np.clip(y, 0.0, 1.0).astype(orig_dtype)


def _rgb_to_gray(x):
    """ITU-R BT.601 luma, trailing-channel RGB."""
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _factor_range(value):
    """Paddle jitter-value semantics: scalar v → [max(0, 1-v), 1+v];
    (lo, hi) pair passes through.  Returns None when inactive."""
    if isinstance(value, (tuple, list)):
        lo, hi = float(value[0]), float(value[1])
    else:
        if value == 0:
            return None
        lo, hi = max(0.0, 1.0 - value), 1.0 + value
    if lo == hi == 1.0:
        return None
    return lo, hi


class BrightnessTransform:
    def __init__(self, value):
        self.range = _factor_range(value)

    def __call__(self, x):
        if self.range is None:
            return np.asarray(x)
        orig = np.asarray(x).dtype
        alpha = np.random.uniform(*self.range)
        return _jitter_out(np.asarray(x, np.float32) * alpha, orig)


class ContrastTransform:
    def __init__(self, value):
        self.range = _factor_range(value)

    def __call__(self, x):
        if self.range is None:
            return np.asarray(x)
        orig = np.asarray(x).dtype
        alpha = np.random.uniform(*self.range)
        x = np.asarray(x, np.float32)
        mean = x.mean()
        return _jitter_out(mean + alpha * (x - mean), orig)


class SaturationTransform:
    def __init__(self, value):
        self.range = _factor_range(value)

    def __call__(self, x):
        if self.range is None:
            return np.asarray(x)
        orig = np.asarray(x).dtype
        alpha = np.random.uniform(*self.range)
        x = np.asarray(x, np.float32)
        gray = _rgb_to_gray(x)[..., None]
        return _jitter_out(gray + alpha * (x - gray), orig)


class HueTransform:
    """Approximate hue jitter by rotating RGB channels toward the rolled
    image (cheap host-side analog; reference uses HSV rotation)."""

    def __init__(self, value):
        if isinstance(value, (tuple, list)):
            self.range = (float(value[0]), float(value[1]))
        elif value == 0:
            self.range = None
        else:
            self.range = (-float(value), float(value))

    def __call__(self, x):
        if self.range is None:
            return np.asarray(x)
        orig = np.asarray(x).dtype
        # blend weight = |sampled hue shift|: this channel-roll analog has
        # no direction, so the shift's MAGNITUDE drives the blend for both
        # scalar and (lo, hi) forms (a (-0.5, -0.1) range jitters like
        # (0.1, 0.5))
        alpha = np.clip(np.abs(np.random.uniform(*self.range)), 0.0, 1.0)
        x = np.asarray(x, np.float32)
        rolled = np.roll(x, 1, axis=-1)
        return _jitter_out((1 - alpha) * x + alpha * rolled, orig)


class ColorJitter:
    """Compose brightness/contrast/saturation/hue jitters in random order
    (reference transforms ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation), HueTransform(hue)]

    def __call__(self, x):
        order = np.random.permutation(len(self.ts))
        for i in order:
            x = self.ts[i](x)
        return x


class RandomResizedCrop:
    """Random scale/aspect crop then resize (reference
    RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, x):
        x = np.asarray(x)
        h, w = x.shape[0], x.shape[1]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                crop = x[i:i + ch, j:j + cw]
                return Resize(self.size)(crop)
        return Resize(self.size)(CenterCrop(min(h, w))(x))


class RandomRotation:
    """Rotate by a random multiple-of-90-free angle via coordinate
    mapping (nearest-neighbor, constant fill)."""

    def __init__(self, degrees):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)

    def __call__(self, x):
        x = np.asarray(x)
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        h, w = x.shape[0], x.shape[1]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.mgrid[0:h, 0:w]
        ys = cy + (yy - cy) * np.cos(angle) + (xx - cx) * np.sin(angle)
        xs = cx - (yy - cy) * np.sin(angle) + (xx - cx) * np.cos(angle)
        yn = np.clip(np.round(ys), 0, h - 1).astype(np.int64)
        xn = np.clip(np.round(xs), 0, w - 1).astype(np.int64)
        valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
        out = x[yn, xn]
        return np.where(valid[(...,) + (None,) * (x.ndim - 2)], out, 0)


__all__ += ["RandomVerticalFlip", "Pad", "Grayscale", "BrightnessTransform",
            "ContrastTransform", "SaturationTransform", "HueTransform",
            "ColorJitter", "RandomResizedCrop", "RandomRotation"]


# ---------------------------------------------------------------------------
# Functional forms (reference vision/transforms/functional.py) + the
# BaseTransform class-transform base.  Host-side numpy like the classes.
# ---------------------------------------------------------------------------
class BaseTransform:
    """Reference transforms.BaseTransform: keys-aware transform base.
    Subclasses implement _apply_image (and optionally _apply_boxes /
    _apply_mask); __call__ routes inputs per ``keys``."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        raise NotImplementedError

    def _apply_boxes(self, boxes):
        return boxes

    def _apply_mask(self, mask):
        return mask

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return self._apply_image(inputs)
        outs = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            outs.append(fn(data) if fn is not None else data)
        return tuple(outs)


def to_tensor(pic, data_format: str = "CHW"):
    out = ToTensor()(pic)
    return out if data_format == "CHW" else out.transpose(1, 2, 0)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


def resize(img, size, interpolation: str = "bilinear"):
    return Resize(size)(img)


def pad(img, padding, fill=0, padding_mode: str = "constant"):
    return Pad(padding, fill, padding_mode)(img)


def crop(img, top: int, left: int, height: int, width: int):
    return np.asarray(img)[top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def rotate(img, angle: float, interpolation: str = "nearest",
           expand: bool = False, center=None, fill=0):
    """Rotate an HWC image by ``angle`` degrees (nearest-neighbor inverse
    mapping, host-side)."""
    x = np.asarray(img)
    h, w = x.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    yy, xx = np.mgrid[0:h, 0:w]
    # inverse rotation: output pixel ← source position
    sx = cos * (xx - cx) + sin * (yy - cy) + cx
    sy = -sin * (xx - cx) + cos * (yy - cy) + cy
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    inside = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.full_like(x, fill)
    out[inside] = x[syi[inside], sxi[inside]]
    return out


def to_grayscale(img, num_output_channels: int = 1):
    return Grayscale(num_output_channels)(img)


def adjust_brightness(img, brightness_factor: float):
    orig = np.asarray(img).dtype
    return _jitter_out(np.asarray(img, np.float32) * brightness_factor,
                       orig)


def adjust_contrast(img, contrast_factor: float):
    orig = np.asarray(img).dtype
    x = np.asarray(img, np.float32)
    mean = x.mean()
    return _jitter_out(mean + contrast_factor * (x - mean), orig)


def adjust_hue(img, hue_factor: float):
    orig = np.asarray(img).dtype
    x = np.asarray(img, np.float32)
    alpha = float(np.clip(abs(hue_factor), 0.0, 1.0))
    return _jitter_out((1 - alpha) * x + alpha * np.roll(x, 1, axis=-1),
                       orig)


def normalize(img, mean, std, data_format: str = "CHW",
              to_rgb: bool = False):
    return Normalize(mean, std, data_format)(img)


__all__ += ["BaseTransform", "to_tensor", "hflip", "vflip", "resize",
            "pad", "crop", "center_crop", "rotate", "to_grayscale",
            "adjust_brightness", "adjust_contrast", "adjust_hue",
            "normalize"]
