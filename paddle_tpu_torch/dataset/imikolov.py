"""``paddle.dataset.imikolov``: n-gram tuples over ``text.Imikolov``."""
import numpy as np

from ._common import make_readers


def _mk(mode):
    from ..text.datasets import Imikolov
    return Imikolov(mode=mode)


train, test = make_readers(
    lambda: _mk("train"), lambda: _mk("test"),
    lambda s: tuple(np.asarray(x) for x in s))
