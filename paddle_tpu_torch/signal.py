"""paddle.signal of the port: ``paddle_tpu/signal.py`` in PyTorch
(reference python/paddle/signal.py: frame:32, overlap_add:154, stft:237,
istft:391).

Framing is a strided view (``Tensor.unfold``), overlap-add an
``index_add`` over the output positions, and the DFTs run in ``torch.fft``
(cuFFT on the card); every op is batched over leading dims and
differentiable.  Output layout matches the reference: stft returns
``[..., n_fft(/2+1), num_frames]`` (frequency-major).  The checks raise
the JAX package's ``enforce`` messages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF

from .framework.dtype import as_tensor
from .framework.errors import enforce

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _arr(x, like=None):
    return as_tensor(x, like=like)


def frame(x, frame_length: int, hop_length: int, axis: int = -1):
    """Slice overlapping frames: ``[..., seq]`` -> ``[..., frame_length,
    num_frames]`` for axis=-1 (axis=0 puts frames first:
    ``[num_frames, frame_length, ...]``)."""
    x = _arr(x)
    enforce(axis in (0, -1), "frame: axis must be 0 or -1")
    enforce(hop_length > 0, f"frame: hop_length={hop_length} must be > 0")
    seq = x.shape[axis]
    enforce(frame_length <= seq,
            f"frame: frame_length={frame_length} > seq_length={seq}")
    if axis == -1:
        return x.unfold(-1, frame_length, hop_length).transpose(-1, -2)
    return torch.movedim(x.unfold(0, frame_length, hop_length), -1, 1)


def overlap_add(x, hop_length: int, axis: int = -1):
    """Inverse of :func:`frame`: ``[..., frame_length, num_frames]`` ->
    ``[..., seq]`` summing overlaps (reference signal.py:154)."""
    x = _arr(x)
    enforce(axis in (0, -1), "overlap_add: axis must be 0 or -1")
    if axis == 0:
        # (num_frames, frame_length, ...) -> (..., fl, nf)
        x = torch.movedim(torch.movedim(x, 0, -1), 0, -2)
    fl, nf = x.shape[-2], x.shape[-1]
    out_len = (nf - 1) * hop_length + fl
    pos = (np.arange(fl)[:, None]
           + hop_length * np.arange(nf)[None, :]).reshape(-1)
    flat = x.reshape(x.shape[:-2] + (fl * nf,))
    out = torch.zeros(x.shape[:-2] + (out_len,), dtype=x.dtype,
                      device=x.device)
    out = out.index_add(-1, torch.as_tensor(pos, device=x.device), flat)
    if axis == 0:
        out = torch.movedim(out, -1, 0)
    return out


def _pad_last(x, pad: int, mode: str):
    """``jnp.pad`` of the last axis by ``pad`` on each side, in any of its
    modes (reflect, symmetric, edge, wrap, constant), for any leading
    dims and dtype."""
    if mode == "constant":
        return tF.pad(x, (pad, pad))
    idx = np.pad(np.arange(x.shape[-1]), (pad, pad), mode=mode)
    return x.index_select(-1, torch.as_tensor(idx, device=x.device))


def _resolve_window(window, win_length: int, n_fft: int, dtype, device):
    if window is None:
        w = torch.ones(win_length, dtype=dtype, device=device)
    else:
        w = _arr(window, _device_like(device)).to(dtype)
        enforce(tuple(w.shape) == (win_length,),
                f"window must have shape ({win_length},), got "
                f"{tuple(w.shape)}")
    if win_length < n_fft:     # center-pad to n_fft (reference behavior)
        lpad = (n_fft - win_length) // 2
        w = tF.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def _device_like(device):
    """An empty tensor on ``device``: the ``like`` of a conversion."""
    return torch.empty(0, device=device)


def _real_dtype(x):
    return x.real.dtype if x.is_complex() else x.dtype


def stft(x, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, window=None,
         center: bool = True, pad_mode: str = "reflect",
         normalized: bool = False, onesided: bool = True):
    """Short-time Fourier transform (reference signal.py:237): returns
    ``[..., n_fft//2 + 1 (or n_fft), num_frames]`` complex frames."""
    x = _arr(x)
    hop_length = n_fft // 4 if hop_length is None else hop_length
    enforce(hop_length > 0, f"stft: hop_length={hop_length} must be > 0")
    win_length = n_fft if win_length is None else win_length
    enforce(0 < win_length <= n_fft,
            f"stft: need 0 < win_length={win_length} <= n_fft={n_fft}")
    enforce(not (onesided and x.is_complex()),
            "stft: onesided is not supported for complex inputs")
    w = _resolve_window(window, win_length, n_fft, x.dtype, x.device)
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    frames = frame(x, n_fft, hop_length, axis=-1)      # (..., n_fft, nf)
    frames = frames * w[:, None]
    spec = (torch.fft.rfft(frames, dim=-2) if onesided
            else torch.fft.fft(frames, dim=-2))
    if normalized:
        spec = spec * (n_fft ** -0.5)
    return spec


def istft(x, n_fft: int, hop_length: Optional[int] = None,
          win_length: Optional[int] = None, window=None,
          center: bool = True, normalized: bool = False,
          onesided: bool = True, length: Optional[int] = None,
          return_complex: bool = False):
    """Inverse STFT, least-squares / NOLA form (reference
    signal.py:391)."""
    x = _arr(x)
    hop_length = n_fft // 4 if hop_length is None else hop_length
    enforce(hop_length > 0, f"istft: hop_length={hop_length} must be > 0")
    win_length = n_fft if win_length is None else win_length
    enforce(0 < win_length <= n_fft,
            f"istft: need 0 < win_length={win_length} <= n_fft={n_fft}")
    enforce(x.dim() >= 2, "istft: input must be [..., n_fft(/2+1), frames]")
    enforce(not (return_complex and onesided),
            "istft: return_complex=True requires onesided=False")
    w = _resolve_window(window, win_length, n_fft, _real_dtype(x), x.device)
    if normalized:
        x = x * (n_fft ** 0.5)
    frames = (torch.fft.irfft(x, n=n_fft, dim=-2) if onesided
              else torch.fft.ifft(x, dim=-2))
    if not return_complex and frames.is_complex():
        frames = frames.real
    frames = frames * w[:, None]
    y = overlap_add(frames, hop_length, axis=-1)
    # the NOLA check and the normalization by the summed squared window
    # envelope, both on the host window: one small host read
    wsq_np = w.detach().double().cpu().numpy() ** 2
    nf = int(x.shape[-1])
    env_np = np.zeros((nf - 1) * hop_length + n_fft)
    for j in range(nf):
        env_np[j * hop_length:j * hop_length + n_fft] += wsq_np
    chk = env_np[n_fft // 2:len(env_np) - n_fft // 2] if center else env_np
    enforce(chk.size == 0 or chk.min() > 1e-11,
            "istft: window fails the NOLA condition (zero overlap-add "
            f"coverage with hop_length={hop_length})")
    env = torch.as_tensor(np.maximum(env_np, 1e-11),
                          dtype=_real_dtype(y), device=y.device)
    y = y / env
    if center:
        pad = n_fft // 2
        # drop the left padding; an explicit length keeps real samples of
        # the last frames' tails (torch semantics) instead of cropping
        y = y[..., pad:] if length is not None \
            else y[..., pad:y.shape[-1] - pad]
    if length is not None:
        if y.shape[-1] < length:   # zero-pad past frame coverage
            y = tF.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y
