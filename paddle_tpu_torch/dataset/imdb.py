"""``paddle.dataset.imdb``: (word ids, 0 / 1) over ``text.Imdb``."""
import numpy as np

from ._common import make_readers


def _mk(mode):
    from ..text.datasets import Imdb
    return Imdb(mode=mode)


train, test = make_readers(
    lambda: _mk("train"), lambda: _mk("test"),
    lambda s: (np.asarray(s[0]), int(np.asarray(s[1]))))
