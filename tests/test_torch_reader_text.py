"""The legacy readers, ``paddle.dataset``, the text datasets and the
WordPiece tokenizer of the port against the JAX package's, on the CPU.

Everything here is host data, so everything is exact: every reader
decorator gives the JAX samples in the JAX order (``shuffle`` under one
Python ``random`` seed), every dataset item equals the JAX item (values,
dtype and shape), including ``data_file`` archives built in ``tmp_path``,
and the tokenizer's ids from JAX, from the port's native C core and from
the port's Python path are one list.
"""
from __future__ import annotations

import io
import random
import tarfile

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.dataset as jdataset
import paddle_tpu.reader as jreader
import paddle_tpu.text as jtext

import paddle_tpu_torch as tpt
import paddle_tpu_torch.dataset as tdataset
import paddle_tpu_torch.reader as treader
import paddle_tpu_torch.text as ttext
from paddle_tpu_torch.utils.retry import RetriesExhausted


def _same(a, b):
    """Nested samples equal exactly: values, dtype and shape."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        return
    assert a == b and type(a) is type(b)


def _rd(n, base=0):
    def reader():
        for i in range(n):
            yield base + i
    return reader


def _both(fn):
    """fn(module) -> reader, for both packages' reader modules."""
    return list(fn(jreader)()), list(fn(treader)())


DECORATORS = {
    "batch": lambda m: m.batch(_rd(10), 3),
    "batch_drop_last": lambda m: m.batch(_rd(10), 3, drop_last=True),
    "cache": lambda m: m.cache(_rd(5)),
    "map_readers": lambda m: m.map_readers(lambda a, b: a * b, _rd(4),
                                           _rd(4, 10)),
    "chain": lambda m: m.chain(_rd(3), _rd(2, 100)),
    "compose": lambda m: m.compose(_rd(3), m.map_readers(
        lambda a: (a, -a), _rd(3))),
    "compose_unaligned": lambda m: m.compose(_rd(3), _rd(2),
                                             check_alignment=False),
    "buffered": lambda m: m.buffered(_rd(7), 3),
    "firstn": lambda m: m.firstn(_rd(10), 4),
    "xmap_readers": lambda m: m.xmap_readers(lambda x: x + 1, _rd(5), 2, 4),
    "multiprocess_reader": lambda m: m.multiprocess_reader([_rd(2),
                                                            _rd(3, 50)]),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_reader_decorators_match_jax(name):
    j, t = _both(DECORATORS[name])
    assert t == j


def test_shuffle_gives_the_jax_order_under_one_seed():
    random.seed(5)
    j = list(jreader.shuffle(_rd(20), 6)())
    random.seed(5)
    t = list(treader.shuffle(_rd(20), 6)())
    assert t == j and sorted(t) == list(range(20))


def test_compose_unaligned_raises_as_jax():
    for m in (jreader, treader):
        with pytest.raises(ValueError):
            list(m.compose(_rd(3), _rd(2))())


def test_retry_reader_and_batch_retries():
    def flaky(fail_at):
        state = {"failed": set()}

        def reader():
            for i in range(6):
                if i in fail_at and i not in state["failed"]:
                    state["failed"].add(i)
                    raise OSError(f"transient {i}")
                yield i
        return reader
    for m in (jreader, treader):
        assert list(m.retry_reader(flaky({2, 4}), sleep=lambda s: None)()) \
            == list(range(6))
        assert list(m.batch(flaky({3}), 4, retries=1)()) == [[0, 1, 2, 3],
                                                             [4, 5]]
    with pytest.raises(RetriesExhausted):
        def bad():
            raise OSError("down")
            yield 0
        list(treader.retry_reader(bad, max_attempts=2,
                                  sleep=lambda s: None)())


def test_top_level_batch_is_the_reader_batch():
    assert tpt.batch is treader.batch
    assert list(tpt.batch(_rd(5), 2)()) == list(jpt.batch(_rd(5), 2)())


LEGACY = [("mnist", "train"), ("cifar", "train10"), ("flowers", "test"),
          ("uci_housing", "train"), ("imdb", "test"), ("imikolov", "test")]


@pytest.mark.parametrize("mod,fn", LEGACY)
def test_legacy_dataset_readers_match_jax(mod, fn):
    j = getattr(getattr(jdataset, mod), fn)()()
    t = getattr(getattr(tdataset, mod), fn)()()
    for _ in range(5):
        _same(next(t), next(j))


TEXT = [("Imdb", {"mode": "test", "synthetic_size": 40}),
        ("Imikolov", {"mode": "test", "synthetic_size": 40}),
        ("UCIHousing", {"mode": "train", "synthetic_size": 40}),
        ("Conll05st", {"synthetic_size": 40}),
        ("Movielens", {"mode": "test", "synthetic_size": 40})]


@pytest.mark.parametrize("name,kw", TEXT, ids=[n for n, _ in TEXT])
def test_text_datasets_match_jax_item_for_item(name, kw):
    j = getattr(jtext, name)(**kw)
    t = getattr(ttext, name)(**kw)
    assert len(t) == len(j) == 40
    for i in range(len(j)):
        _same(t[i], j[i])


def test_text_datasets_refuse_unparsed_corpora_as_jax():
    for name in ("Imikolov", "Conll05st", "Movielens"):
        with pytest.raises(Exception):
            getattr(ttext, name)(data_file="corpus.tgz")


def _imdb_tar(path):
    docs = {"train/pos/1.txt": "a great great film",
            "train/neg/2.txt": "dull, so dull",
            "test/pos/3.txt": "loved it",
            "test/neg/4.txt": "meh",
            "train/unsup/5.txt": "ignored"}
    with tarfile.open(path, "w:gz") as tf:
        for name, text in docs.items():
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_data_file_archives_match_jax(tmp_path):
    tar = tmp_path / "aclImdb.tar.gz"
    _imdb_tar(tar)
    for mode in ("train", "test"):
        j = jtext.Imdb(data_file=str(tar), mode=mode)
        t = ttext.Imdb(data_file=str(tar), mode=mode)
        assert len(t) == len(j) == 2
        for i in range(2):
            _same(t[i], j[i])
    table = tmp_path / "housing.data"
    rows = np.random.RandomState(0).rand(10, 14).astype(np.float32)
    np.savetxt(table, rows)
    for mode in ("train", "test"):
        j = jtext.UCIHousing(data_file=str(table), mode=mode)
        t = ttext.UCIHousing(data_file=str(table), mode=mode)
        assert len(t) == len(j)
        for i in range(len(j)):
            _same(t[i], j[i])


def test_movielens_record_types_match_jax():
    for m in (jtext, ttext):
        mi = m.MovieInfo(7, ["Comedy", "Drama"], "Toy Story")
        ui = m.UserInfo(3, "F", 25, 4)
        assert mi.value({"Comedy": 0, "Drama": 1},
                        {"toy": 5, "story": 6}) == [[7], [0, 1], [5, 6]]
        assert ui.value() == [[3], [1], [2], [4]]
    assert str(ttext.UserInfo(3, "F", 25, 4)) == \
        str(jtext.UserInfo(3, "F", 25, 4))


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown",
         "fox", "jump", "##ed", "##s", "##ing", "over", "lazy", "dog",
         "un", "##aff", "##able", "runn", "hello", "world", ",", ".",
         "!", "?", "'", "a", "##b", "##c", "ab", "日本", "##語"]


def _corpus(n):
    r = np.random.RandomState(0)
    pieces = ["the", "Quick", "unaffable", "zzz", "ab", "abc", "jumping",
              "runns", ",", "!", "hello", "world'", "dog.", "a", "+++",
              "日本語", "x" * 600, "\t", "\n"]
    return [" ".join(r.choice(pieces, size=r.randint(1, 12)))
            for _ in range(n)]


def test_tokenizer_ids_equal_across_jax_native_and_python():
    j = jtext.WordPieceTokenizer(VOCAB)
    native = ttext.WordPieceTokenizer(VOCAB, use_native=True)
    python = ttext.WordPieceTokenizer(VOCAB, use_native=False)
    assert native.uses_native and not python.uses_native
    texts = _corpus(150)
    want = [j._encode_py(s.lower()) for s in texts]
    assert j.encode_batch(texts) == want
    assert native.encode_batch(texts) == want
    assert python.encode_batch(texts) == want
    ids = native.encode("The quick brown fox jumped over the lazy dog")
    assert native.decode(ids) == j.decode(ids) == \
        "the quick brown fox jumped over the lazy dog"


def test_tokenizer_native_core_is_built_from_the_port(monkeypatch):
    # use_native=True raises when the core cannot be built; None falls back
    import paddle_tpu_torch.text.tokenizer as tok_mod
    monkeypatch.setattr(tok_mod, "_lib", False)
    with pytest.raises(RuntimeError):
        ttext.WordPieceTokenizer(VOCAB, use_native=True)
    assert not ttext.WordPieceTokenizer(VOCAB).uses_native
    monkeypatch.undo()
    assert tok_mod._SRC.startswith(str(
        __import__("pathlib").Path(tpt.__file__).parent))
    tok = ttext.WordPieceTokenizer({"[UNK]": 3, "hi": 9})
    assert tok.uses_native and tok.encode("hi HI ho") == [9, 9, 3]
