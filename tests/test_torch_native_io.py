"""The native shared-memory transport of the port's ``io.DataLoader``
(``io/native.py`` over the port's own ``io/_native/shm_ring.cc``) and the
generator-fed loaders, against the JAX package's, on the CPU.

Exact throughout: the codec gives back every array byte for byte with
its dtype and shape; a loader with workers gives the same batches over
the ring as over the worker queue and as the JAX loader, and counts the
ring's batches; ``from_generator`` / ``from_dataset`` yield the JAX
batches.
"""
from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest

import paddle_tpu.io as jio
from paddle_tpu.framework import flags as jflags

import paddle_tpu_torch as tpt
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.io import native


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    # a hybrid mesh left set by an earlier JAX test file on this xdist
    # worker would shard the JAX side (and refuse its ServingEngine in
    # later files); these tests compare single-device runs
    from paddle_tpu.distributed import topology
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(None)



@pytest.fixture(autouse=True)
def _flag_reset():
    set_before = dict(tflags._set)
    jset_before = dict(jflags._set) if hasattr(jflags, "_set") else None
    yield
    tflags._set.clear()
    tflags._set.update(set_before)
    if jset_before is not None:
        jflags._set.clear()
        jflags._set.update(jset_before)


class Tokens(tio.Dataset):
    """Seeded (ids, labels, mask, weight) rows, as a token dataset."""

    def __init__(self, n=24, s=64):
        self.n, self.s = n, s

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.RandomState(1000 + i)
        ids = r.randint(0, 50257, self.s).astype(np.int64)
        return (ids, np.roll(ids, -1), (r.rand(self.s) > 0.1),
                np.float32(r.rand()))


class JTokens(jio.Dataset):
    def __init__(self, n=24, s=64):
        self._t = Tokens(n, s)

    def __len__(self):
        return len(self._t)

    def __getitem__(self, i):
        return self._t[i]


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


def test_codec_round_trip_is_byte_exact():
    batch = {"ids": np.arange(12, dtype=np.int64).reshape(3, 4),
             "x": (np.float32([1.5, -2.0]), [np.bool_([True, False]),
                                            np.zeros((0, 3), np.float16)]),
             "s": np.float64(3.25)}
    parts = native.encode_batch_parts(7, batch)
    msg = bytearray(b"".join(bytes(memoryview(p).cast("B"))
                             if not isinstance(p, np.ndarray)
                             else p.tobytes() for p in parts))
    bid, err, out = native.decode_batch(msg)
    assert bid == 7 and err is None
    assert type(out) is dict and type(out["x"]) is tuple \
        and type(out["x"][1]) is list
    for a, b in [(batch["ids"], out["ids"]), (batch["x"][0], out["x"][0]),
                 (batch["x"][1][0], out["x"][1][0]),
                 (batch["x"][1][1], out["x"][1][1]),
                 (np.asarray(batch["s"]), out["s"])]:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert out["ids"].flags.writeable   # as the queue's arrays


def test_ring_put_get_close_semantics():
    ring = native.ShmRing(slots=2, slot_bytes=1024)
    ring.put_parts([b"abc", np.arange(3, dtype=np.int32)])
    assert ring.count() == 1
    got = ring.get(timeout=1.0)
    assert bytes(got) == b"abc" + np.arange(3, dtype=np.int32).tobytes()
    with pytest.raises(TimeoutError):
        ring.get(timeout=0.01)
    with pytest.raises(ValueError):
        ring.put_parts([b"x" * 2048])
    ring.put_parts([b"last"])
    ring.close()
    with pytest.raises(BrokenPipeError):
        ring.put_parts([b"y"])
    assert bytes(ring.get(timeout=1.0)) == b"last"   # drained after close
    assert ring.get(timeout=1.0) is None


def test_the_library_is_built_from_the_port_into_build():
    root = pathlib.Path(tpt.__file__).resolve().parent
    assert pathlib.Path(native._SRC).resolve().parent == root / "io" / \
        "_native"
    native.load_library()
    from paddle_tpu_torch.utils.cpp_extension import get_build_directory
    assert any(f.startswith("shm_ring-") and f.endswith(".so")
               for f in os.listdir(get_build_directory()))


def _port(flag, **kw):
    tflags.set_flags({"dataloader_use_native": flag})
    dl = tio.DataLoader(Tokens(), batch_size=4, num_workers=2,
                        to_device=False, **kw)
    return list(dl), dl


def test_ring_batches_equal_the_queue_and_the_jax_loaders():
    ring, dl = _port(True)
    assert dl.ring_batches == len(ring) == 6
    queued, dlq = _port(False)
    assert dlq.ring_batches == 0
    _same_batches(ring, queued)
    jflags.set_flags({"dataloader_use_native": True})
    jax_batches = list(jio.DataLoader(JTokens(), batch_size=4, num_workers=2,
                                      to_device=False))
    _same_batches(ring, jax_batches)
    # a second epoch of the same loader crosses the ring again
    tflags.set_flags({"dataloader_use_native": True})
    assert len(list(dl)) == 6 and dl.ring_batches == 12


def test_oversized_batches_and_errors_take_the_queue():
    tflags.set_flags({"dataloader_use_native": True})
    dl = tio.DataLoader(Tokens(), batch_size=4, num_workers=2,
                        to_device=False)
    dl.native_slot_bytes = 1024          # a batch is ~4.7 KB
    big = list(dl)
    assert dl.ring_batches == 0
    _same_batches(big, _port(False)[0])

    class Bad(Tokens):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return super().__getitem__(i)
    bad = tio.DataLoader(Bad(), batch_size=4, num_workers=2, to_device=False)
    with pytest.raises(RuntimeError, match="sample 5"):
        list(bad)


def test_ring_feeds_the_device_prefetcher():
    tflags.set_flags({"dataloader_use_native": True})
    dl = tio.DataLoader(Tokens(8), batch_size=4, num_workers=2,
                        places="cpu")
    batches = list(dl)
    assert dl.ring_batches == 2
    assert batches[0][0].dtype.is_floating_point is False
    np.testing.assert_array_equal(batches[1][0].numpy(),
                                  np.stack([Tokens(8)[i][0]
                                            for i in range(4, 8)]))


def _gen():
    for i in range(7):
        yield (np.full(3, i, np.float32), np.int64(i))


def test_from_generator_matches_jax():
    for setup in ("sample", "sample_list", "batch"):
        out = []
        for mod in (jio, tio):
            loader = mod.DataLoader.from_generator(capacity=4)
            if setup == "sample":
                loader.set_sample_generator(_gen, batch_size=3,
                                            drop_last=False)
            elif setup == "sample_list":
                loader.set_sample_list_generator(
                    lambda: (list(g) for g in [list(_gen())[:4],
                                               list(_gen())[4:]]))
            else:
                loader.set_batch_generator(
                    lambda: ([np.arange(i + 2)] for i in range(3)))
            out.append([list(b) for b in loader])
            out.append([list(b) for b in loader])    # re-iterable
        _same_batches(out[2], out[0])
        _same_batches(out[3], out[1])
    with pytest.raises(Exception):
        iter(tio.DataLoader.from_generator())


def test_from_dataset_matches_jax():
    class InMem:
        def __init__(self, records, batch_size):
            self._records, self._batch_size = records, batch_size
    recs = [np.full(2, i, np.int64) for i in range(7)]
    for drop_last in (True, False):
        j = list(jio.DataLoader.from_dataset(InMem(recs, 3),
                                             drop_last=drop_last))
        t = list(tio.DataLoader.from_dataset(InMem(recs, 3),
                                             drop_last=drop_last))
        assert len(t) == len(j) == (2 if drop_last else 3)
        for a, b in zip(t, j):
            _same_batches([a], [b])
    with pytest.raises(Exception):
        tio.DataLoader.from_dataset(object())
