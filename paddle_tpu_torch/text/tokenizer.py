"""BERT-style WordPiece tokenizer with a native C core: the port of
``paddle_tpu/text/tokenizer.py``.

Canonical BERT WordPiece: optional lowercasing, whitespace pre-split,
ASCII punctuation isolated, greedy longest-match-first subwords with
``##`` continuations, a whole word -> ``[UNK]`` when it cannot be
segmented.  The hot loop is C (the port's own copy of
``text/_native/wordpiece.c``), built at first use by the port's
``utils.cpp_extension.load`` into the gitignored ``build/``; a Python
implementation with identical semantics (byte-level matching) is the
fallback and the parity oracle.  ``use_native=None`` tries the C core and
falls back silently; ``use_native=True`` raises when it cannot be built.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..framework.log import get_logger

__all__ = ["WordPieceTokenizer"]

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_SRC = os.path.join(_DIR, "wordpiece.c")

_lib = None
_lib_lock = threading.Lock()
# the C core's stack buffer bounds subword candidates at 509 bytes;
# max_word_len is clamped to this on BOTH paths so they stay identical
_MAX_WORD_BYTES = 509
_PUNCT = set(chr(c) for c in range(33, 48)) | \
    set(chr(c) for c in range(58, 65)) | \
    set(chr(c) for c in range(91, 97)) | \
    set(chr(c) for c in range(123, 127))


def _load_lib():
    """Build through ``utils.cpp_extension.load`` (content-keyed cache,
    atomic rename).  Any failure leaves the Python path, as the
    ``use_native=None`` contract says."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        try:
            from ..utils.cpp_extension import load as cpp_load
            lib = cpp_load("wordpiece", [_SRC])
            lib.wp_new.restype = ctypes.c_void_p
            lib.wp_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int32, ctypes.c_int64]
            lib.wp_free.argtypes = [ctypes.c_void_p]
            lib.wp_encode.restype = ctypes.c_int64
            lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int64]
        except Exception as e:
            get_logger().warning(
                "native wordpiece core unavailable (%s); python fallback",
                e)
            _lib = False
            return None
        _lib = lib
        return lib


class WordPieceTokenizer:
    """``encode(text) -> List[int]`` over a BERT-style vocab.

    ``vocab``: dict token→id or a sequence of tokens (ids = positions).
    ``use_native=None`` tries the C core and falls back silently.
    """

    def __init__(self, vocab, unk_token: str = "[UNK]",
                 lowercase: bool = True, max_word_len: int = 100,
                 use_native: Optional[bool] = None):
        if not isinstance(vocab, dict):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab: Dict[str, int] = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token
        self.unk_id = self.vocab.get(unk_token, 0)
        self.lowercase = lowercase
        self.max_word_len = min(int(max_word_len), _MAX_WORD_BYTES)
        # byte-keyed view for the oracle: greedy matching is BYTE-level
        # exactly like the C core (invalid-utf8 intermediates simply
        # never match, so multibyte chars segment correctly)
        self._bvocab = {t.encode("utf-8"): i for t, i in self.vocab.items()}
        self._handle = None
        self._id_remap = None
        if use_native is not False:
            self._init_native(required=bool(use_native))

    # -- native core --------------------------------------------------------
    def _init_native(self, required: bool):
        lib = _load_lib()
        if lib is None:
            if required:
                raise RuntimeError("native wordpiece core unavailable")
            return
        # the C side needs a SORTED table; remap its indices back to ids
        toks = sorted(self.vocab)
        self._id_remap = np.asarray([self.vocab[t] for t in toks],
                                    np.int32)
        raw = [t.encode("utf-8") for t in toks]
        packed = b"\0".join(raw) + b"\0"
        offsets = np.zeros(len(raw), np.int64)
        off = 0
        for i, r in enumerate(raw):
            offsets[i] = off
            off += len(r) + 1
        handle = lib.wp_new(
            packed, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(raw), len(packed))
        if handle:
            self._handle = handle
            self._lib = lib

    def __del__(self):
        if getattr(self, "_handle", None):
            try:
                self._lib.wp_free(self._handle)
            except Exception:  # noqa: swallow — best-effort finalizer
                pass

    @property
    def uses_native(self) -> bool:
        return self._handle is not None

    # -- encoding -----------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        if self.lowercase:
            text = text.lower()
        if self._handle is not None:
            cap = max(16, 2 * len(text) + 8)
            out = np.empty(cap, np.int32)
            n = self._lib.wp_encode(
                self._handle, text.encode("utf-8"), -1,
                self.max_word_len,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
            ids = out[:min(n, cap)]
            # vectorized remap: a python per-token loop here dominates the
            # whole encode for MB-scale inputs (C core output is sorted-
            # table indices; <0 marks UNK)
            remapped = np.where(ids < 0, np.int32(self.unk_id),
                                self._id_remap[np.clip(ids, 0, None)])
            return remapped.tolist()
        return self._encode_py(text)

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), self.unk_token) for i in ids]
        out = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)

    # -- python oracle (identical semantics) --------------------------------
    def _split(self, text: str) -> List[str]:
        words, cur = [], []
        for ch in text:
            if ch in (" ", "\t", "\n", "\r"):
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif ch in _PUNCT:
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words

    def _encode_py(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._split(text):
            wb = word.encode("utf-8")
            if len(wb) > self.max_word_len:
                ids.append(self.unk_id)
                continue
            start, word_ids = 0, []
            bad = False
            while start < len(wb):
                end = len(wb)
                found = None
                while end > start:
                    sub = wb[start:end]
                    if start > 0:
                        sub = b"##" + sub
                    if sub in self._bvocab:
                        found = self._bvocab[sub]
                        break
                    end -= 1
                if found is None:
                    bad = True
                    break
                word_ids.append(found)
                start = end
            ids.extend([self.unk_id] if bad else word_ids)
        return ids
