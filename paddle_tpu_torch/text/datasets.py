"""The WMT translation datasets: the port of ``paddle_tpu/text/
datasets.py:250-362`` (reference ``text/datasets/wmt14.py``,
``wmt16.py``).

Nothing is downloaded: each dataset builds the JAX module's deterministic
synthetic corpus, item for item (the same seeds, the same draws, the same
permutation).  The task is learnable: the target is the source mapped
through a fixed random permutation of the dictionary, so a seq2seq model
can drive the loss to zero.  Items are ``(src_ids, trg_ids,
trg_ids_next)`` int64 arrays: ``trg_ids`` starts with ``<s>`` (0) and
``trg_ids_next`` ends with ``<e>`` (1)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..framework.errors import enforce
from ..io import Dataset

__all__ = ["WMT14", "WMT16"]


class _WMTBase(Dataset):
    START_ID, END_ID, UNK_ID = 0, 1, 2
    _N_SPECIAL = 3

    def _build(self, n: int, seed: int, src_size: int, trg_size: int,
               min_len: int = 4, max_len: int = 16):
        rng = np.random.RandomState(seed)
        content = min(src_size, trg_size) - self._N_SPECIAL
        enforce(content > 0, "dict_size must exceed the 3 special tokens")
        # one permutation for every split (seeded by the dictionary alone):
        # train and test / gen are the same task
        perm = np.arange(content)
        np.random.RandomState(97 + content).shuffle(perm)
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        for _ in range(n):
            length = rng.randint(min_len, max_len + 1)
            src = rng.randint(0, content, length)
            trg = perm[src]
            self.src_ids.append((src + self._N_SPECIAL).astype(np.int64))
            self.trg_ids.append(np.concatenate(
                [[self.START_ID], trg + self._N_SPECIAL]).astype(np.int64))
            self.trg_ids_next.append(np.concatenate(
                [trg + self._N_SPECIAL, [self.END_ID]]).astype(np.int64))

    @staticmethod
    def _make_dict(size: int, prefix: str, reverse: bool):
        words = {0: "<s>", 1: "<e>", 2: "<unk>"}
        for i in range(3, size):
            words[i] = f"{prefix}{i}"
        if reverse:
            return words
        return {w: i for i, w in words.items()}

    def __getitem__(self, idx):
        return (self.src_ids[idx], self.trg_ids[idx],
                self.trg_ids_next[idx])

    def __len__(self):
        return len(self.src_ids)


class WMT14(_WMTBase):
    """EN -> FR token streams (synthetic); one dictionary size for both
    sides.  ``data_file`` is refused: the corpus format is not parsed."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 dict_size: int = 30000,
                 synthetic_size: Optional[int] = None):
        enforce(data_file is None,
                "WMT14 corpus parsing is not supported; omit data_file for "
                "the synthetic corpus")
        enforce(mode in ("train", "test", "gen"),
                "mode must be train|test|gen")
        enforce(dict_size > 0, "dict_size should be set as positive number")
        self.mode, self.dict_size = mode, dict_size
        n = ({"train": 4096, "test": 512, "gen": 128}[mode]
             if synthetic_size is None else synthetic_size)
        self._build(n, {"train": 41, "test": 43, "gen": 47}[mode],
                    dict_size, dict_size)

    def get_dict(self, reverse: bool = False):
        """(src_dict, trg_dict); id -> word when ``reverse``."""
        return (self._make_dict(self.dict_size, "en", reverse),
                self._make_dict(self.dict_size, "fr", reverse))


class WMT16(_WMTBase):
    """EN <-> DE token streams (synthetic) with a dictionary size per
    side.  ``data_file`` is refused."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_dict_size: int = -1, trg_dict_size: int = -1,
                 lang: str = "en", synthetic_size: Optional[int] = None):
        enforce(data_file is None,
                "WMT16 corpus parsing is not supported; omit data_file for "
                "the synthetic corpus")
        enforce(mode in ("train", "test", "val"),
                "mode must be train|test|val")
        enforce(lang in ("en", "de"), "lang must be en|de")
        enforce(src_dict_size > 0 and trg_dict_size > 0,
                "dict_size should be set as positive number")
        self.mode, self.lang = mode, lang
        self.src_dict_size, self.trg_dict_size = src_dict_size, trg_dict_size
        n = ({"train": 4096, "test": 512, "val": 512}[mode]
             if synthetic_size is None else synthetic_size)
        self._build(n, {"train": 53, "test": 59, "val": 61}[mode],
                    src_dict_size, trg_dict_size)

    def get_dict(self, lang: str, reverse: bool = False):
        """The dictionary of ``lang`` ('en' | 'de'); id -> word when
        ``reverse``."""
        enforce(lang in ("en", "de"), "lang must be en|de")
        size = (self.src_dict_size if lang == self.lang
                else self.trg_dict_size)
        return self._make_dict(size, lang, reverse)
