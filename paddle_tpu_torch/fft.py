"""paddle.fft of the port: ``paddle_tpu/fft.py`` on ``torch.fft`` (cuFFT
on the card; reference python/paddle/fft.py), with the paddle argument
names and order.  ``hfft2`` / ``ihfft2`` / ``hfftn`` / ``ihfftn`` are built
as in the JAX package, on the identity hfftn(x, norm) ==
irfftn(conj(x), the swapped norm)."""
from __future__ import annotations

import torch

from .framework.dtype import as_tensor, convert_dtype, creation_device

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2",
           "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _arr(x):
    return as_tensor(x)


def _dims(axes):
    return None if axes is None else tuple(axes)


def fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(_arr(x), n=n, dim=axis, norm=norm)


def ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(_arr(x), n=n, dim=axis, norm=norm)


def rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(_arr(x), n=n, dim=axis, norm=norm)


def irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(_arr(x), n=n, dim=axis, norm=norm)


def hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(_arr(x), n=n, dim=axis, norm=norm)


def ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(_arr(x), n=n, dim=axis, norm=norm)


def fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.fft2(_arr(x), s=s, dim=_dims(axes), norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.ifft2(_arr(x), s=s, dim=_dims(axes), norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.rfft2(_arr(x), s=s, dim=_dims(axes), norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfft2(_arr(x), s=s, dim=_dims(axes), norm=norm)


def fftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.fftn(_arr(x), s=s, dim=_dims(axes), norm=norm)


def ifftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.ifftn(_arr(x), s=s, dim=_dims(axes), norm=norm)


def rfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.rfftn(_arr(x), s=s, dim=_dims(axes), norm=norm)


def irfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.irfftn(_arr(x), s=s, dim=_dims(axes), norm=norm)


def fftfreq(n, d=1.0, dtype="float32"):
    return torch.fft.fftfreq(n, d=d, dtype=convert_dtype(dtype),
                             device=creation_device())


def rfftfreq(n, d=1.0, dtype="float32"):
    return torch.fft.rfftfreq(n, d=d, dtype=convert_dtype(dtype),
                              device=creation_device())


def fftshift(x, axes=None):
    return torch.fft.fftshift(_arr(x), dim=_dims(axes))


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(_arr(x), dim=_dims(axes))


def _inv_norm(norm: str) -> str:
    """hfftn(x, norm) == irfftn(conj(x), swapped norm) (scipy identity:
    the hermitian transform swaps the forward / backward scaling)."""
    return {"backward": "forward", "forward": "backward",
            "ortho": "ortho"}[norm]


def hfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfftn(torch.conj_physical(_arr(x)), s=s,
                            dim=_dims(axes), norm=_inv_norm(norm))


def ihfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.conj_physical(torch.fft.rfftn(
        _arr(x), s=s, dim=_dims(axes), norm=_inv_norm(norm)))


def hfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.irfftn(torch.conj_physical(_arr(x)), s=s,
                            dim=_dims(axes), norm=_inv_norm(norm))


def ihfftn(x, s=None, axes=None, norm="backward"):
    return torch.conj_physical(torch.fft.rfftn(
        _arr(x), s=s, dim=_dims(axes), norm=_inv_norm(norm)))
