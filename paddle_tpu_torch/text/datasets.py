"""Text datasets: the port of ``paddle_tpu/text/datasets.py`` (reference
``text/datasets/{imdb,imikolov,uci_housing,conll05,movielens,wmt14,
wmt16}.py``).

Nothing is downloaded: each dataset builds the JAX module's deterministic
synthetic corpus, item for item (the same seeds, the same draws).
``Imdb`` (a tar of ``<mode>/pos`` and ``<mode>/neg`` documents, words
hashed by crc32) and ``UCIHousing`` (a whitespace table, 80 / 20 split)
also read a local ``data_file``; the other corpora raise on one rather
than train on synthetic data.  ``MovieInfo`` / ``UserInfo`` are the
Movielens record types.

The WMT datasets' task is learnable: the target is the source mapped
through a fixed random permutation of the dictionary, so a seq2seq model
can drive the loss to zero.  Their items are ``(src_ids, trg_ids,
trg_ids_next)`` int64 arrays: ``trg_ids`` starts with ``<s>`` (0) and
``trg_ids_next`` ends with ``<e>`` (1)."""
from __future__ import annotations

import os
import tarfile
from typing import Optional

import numpy as np

from ..framework.errors import enforce
from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens",
           "MovieInfo", "UserInfo", "WMT14", "WMT16"]


class Imdb(Dataset):
    """Binary sentiment classification; items are (word-id sequence, label)
    (reference text/datasets/imdb.py)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, synthetic_size: Optional[int] = None,
                 vocab_size: int = 5000, seq_len: int = 64):
        enforce(mode in ("train", "test"), "mode must be train|test")
        self.mode = mode
        self.word_idx = {f"w{i}": i for i in range(vocab_size)}
        if data_file is not None:
            enforce(os.path.exists(data_file),
                    f"Imdb data_file {data_file!r} does not exist")
            self.docs, self.labels = self._load_tar(data_file, mode)
            return
        n = synthetic_size or (2048 if mode == "train" else 256)
        rng = np.random.RandomState(3 if mode == "train" else 5)
        self.labels = rng.randint(0, 2, n).astype(np.int64)
        # class-conditional unigram bias makes the task learnable
        self.docs = []
        for y in self.labels:
            lo = 0 if y == 0 else vocab_size // 2
            self.docs.append(rng.randint(
                lo, lo + vocab_size // 2, seq_len).astype(np.int64))

    def _load_tar(self, path: str, mode: str):
        import zlib
        docs, labels = [], []
        vocab = len(self.word_idx)
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                if f"{mode}/pos" in member.name:
                    y = 1
                elif f"{mode}/neg" in member.name:
                    y = 0
                else:
                    continue
                data = tf.extractfile(member).read().decode(
                    "utf-8", "ignore").split()
                # crc32 is stable across processes (builtin hash() is
                # randomized by PYTHONHASHSEED) — reload-safe word ids
                docs.append(np.asarray(
                    [zlib.crc32(w.encode()) % vocab for w in data],
                    np.int64))
                labels.append(y)
        return docs, np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset; items are n-token windows
    (reference text/datasets/imikolov.py)."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 50,
                 synthetic_size: Optional[int] = None,
                 vocab_size: int = 2000):
        enforce(data_file is None,
                "Imikolov corpus parsing is not supported in this "
                "environment; omit data_file to use the synthetic stream")
        self.window_size = window_size
        n = synthetic_size or (4096 if mode == "train" else 512)
        rng = np.random.RandomState(11 if mode == "train" else 13)
        # markov-ish stream: next word depends on previous (learnable)
        stream = np.empty(n + window_size, np.int64)
        stream[0] = rng.randint(vocab_size)
        for i in range(1, len(stream)):
            stream[i] = (stream[i - 1] * 31 + 7) % vocab_size \
                if rng.rand() < 0.8 else rng.randint(vocab_size)
        self.windows = np.lib.stride_tricks.sliding_window_view(
            stream, window_size)[:n]

    def __getitem__(self, idx):
        return self.windows[idx]

    def __len__(self):
        return len(self.windows)


class UCIHousing(Dataset):
    """13-feature housing regression (reference text/datasets/
    uci_housing.py); items are (features, price)."""

    FEATURE_DIM = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 synthetic_size: Optional[int] = None):
        if data_file is not None:
            enforce(os.path.exists(data_file),
                    f"UCIHousing data_file {data_file!r} does not exist")
            raw = np.loadtxt(data_file).astype(np.float32)
            # canonical 80/20 split by mode — train and test must differ
            cut = int(len(raw) * 0.8)
            raw = raw[:cut] if mode == "train" else raw[cut:]
        else:
            n = synthetic_size or (404 if mode == "train" else 102)
            rng = np.random.RandomState(17 if mode == "train" else 19)
            x = rng.randn(n, self.FEATURE_DIM).astype(np.float32)
            w = np.linspace(-2, 2, self.FEATURE_DIM).astype(np.float32)
            y = x @ w + 0.1 * rng.randn(n).astype(np.float32)
            raw = np.concatenate([x, y[:, None]], axis=1)
        self.features = raw[:, :-1]
        self.prices = raw[:, -1:]

    def __getitem__(self, idx):
        return self.features[idx], self.prices[idx]

    def __len__(self):
        return len(self.features)


class Conll05st(Dataset):
    """SRL sequence-labeling schema: (word_ids, predicate_ids, label_ids)
    (reference text/datasets/conll05.py)."""

    NUM_LABELS = 67

    def __init__(self, data_file: Optional[str] = None,
                 synthetic_size: Optional[int] = None, seq_len: int = 30,
                 vocab_size: int = 5000):
        enforce(data_file is None,
                "Conll05st corpus parsing is not supported in this "
                "environment; omit data_file for the synthetic schema")
        n = synthetic_size or 1024
        rng = np.random.RandomState(23)
        self.words = rng.randint(0, vocab_size,
                                 (n, seq_len)).astype(np.int64)
        self.predicates = rng.randint(0, vocab_size, (n,)).astype(np.int64)
        self.labels = rng.randint(0, self.NUM_LABELS,
                                  (n, seq_len)).astype(np.int64)

    def __getitem__(self, idx):
        return self.words[idx], self.predicates[idx], self.labels[idx]

    def __len__(self):
        return len(self.words)


class Movielens(Dataset):
    """Rating prediction: (user_id, age, job, movie_id, category, rating)
    (reference text/datasets/movielens.py)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 synthetic_size: Optional[int] = None,
                 num_users: int = 943, num_movies: int = 1682):
        enforce(data_file is None,
                "Movielens corpus parsing is not supported in this "
                "environment; omit data_file for the synthetic schema")
        n = synthetic_size or (8192 if mode == "train" else 1024)
        rng = np.random.RandomState(29 if mode == "train" else 31)
        self.users = rng.randint(0, num_users, n).astype(np.int64)
        self.movies = rng.randint(0, num_movies, n).astype(np.int64)
        self.ages = rng.randint(18, 70, n).astype(np.int64)
        self.jobs = rng.randint(0, 21, n).astype(np.int64)
        self.categories = rng.randint(0, 18, n).astype(np.int64)
        # rating = user-bias + movie-bias + noise, clipped to 1..5
        ub = rng.randn(num_users)
        mb = rng.randn(num_movies)
        r = 3 + ub[self.users] + mb[self.movies] + 0.3 * rng.randn(n)
        self.ratings = np.clip(np.round(r), 1, 5).astype(np.float32)

    def __getitem__(self, idx):
        return (self.users[idx], self.ages[idx], self.jobs[idx],
                self.movies[idx], self.categories[idx], self.ratings[idx])

    def __len__(self):
        return len(self.users)


# Movielens record types (reference text/datasets/movielens.py:37,62):
# feature-extraction helpers kept for API parity with scripts that
# introspect the raw corpus records.
_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    """Movie id, title and categories (reference movielens.py:37)."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, movie_title_dict):
        return [[self.index],
                [categories_dict[c] for c in self.categories],
                [movie_title_dict[w.lower()] for w in self.title.split()]]

    def __str__(self):
        return (f"<MovieInfo id({self.index}), title({self.title}), "
                f"categories({self.categories})>")

    __repr__ = __str__


class UserInfo:
    """User id, gender, age bucket and job (reference movielens.py:62)."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = _AGE_TABLE.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [[self.index], [0 if self.is_male else 1], [self.age],
                [self.job_id]]

    def __str__(self):
        return (f"<UserInfo id({self.index}), gender({self.is_male}), "
                f"age({self.age}), job({self.job_id})>")

    __repr__ = __str__


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
