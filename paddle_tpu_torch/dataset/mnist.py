"""``paddle.dataset.mnist``: ``train()`` / ``test()`` yielding (image
(28, 28) float32 in [0, 1], int label) over ``vision.datasets.MNIST``."""
from ._common import img_label, make_readers


def _mk(mode):
    from ..vision.datasets import MNIST
    return MNIST(mode=mode)


train, test = make_readers(lambda: _mk("train"), lambda: _mk("test"),
                           img_label)
