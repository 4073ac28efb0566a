"""``paddle.dataset.cifar``: ``train10()`` / ``test10()`` (and the
``train`` / ``test`` aliases) over ``vision.datasets.Cifar10``."""
from ._common import img_label, make_readers


def _mk(mode):
    from ..vision.datasets import Cifar10
    return Cifar10(mode=mode)


train10, test10 = make_readers(lambda: _mk("train"), lambda: _mk("test"),
                               img_label)
train, test = train10, test10
