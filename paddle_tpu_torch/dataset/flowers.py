"""``paddle.dataset.flowers`` over ``vision.datasets.Flowers``."""
from ._common import img_label, make_readers


def _mk(mode):
    from ..vision.datasets import Flowers
    return Flowers(mode=mode)


train, test = make_readers(lambda: _mk("train"), lambda: _mk("test"),
                           img_label)
