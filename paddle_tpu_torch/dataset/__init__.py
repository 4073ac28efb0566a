"""Legacy ``paddle.dataset``: the port of ``paddle_tpu/dataset/``
(reference python/paddle/dataset/*).  Each submodule exposes the
reference's ``train()`` / ``test()`` reader factories over the same
corpora as ``vision.datasets`` / ``text.datasets`` (synthetic, nothing
downloaded), item for item the JAX package's."""
from . import (cifar, flowers, imdb, imikolov,  # noqa: F401
               mnist, uci_housing)

__all__ = ["mnist", "cifar", "flowers", "uci_housing", "imdb",
           "imikolov"]
