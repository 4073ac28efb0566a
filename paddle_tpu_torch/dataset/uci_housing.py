"""``paddle.dataset.uci_housing``: (features float32[13], target
float32[1]) over ``text.UCIHousing``."""
import numpy as np

from ._common import make_readers


def _mk(mode):
    from ..text.datasets import UCIHousing
    return UCIHousing(mode=mode)


train, test = make_readers(
    lambda: _mk("train"), lambda: _mk("test"),
    lambda s: (np.asarray(s[0], np.float32),
               np.asarray(s[1], np.float32)))
