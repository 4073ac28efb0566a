"""``paddle.version``: the port of ``paddle_tpu/version.py`` (reference
python/paddle/version.py, generated at build time).

By design the build fields report PyTorch's build, not the JAX package's
TPU one: ``with_gpu`` is ``"ON"`` when torch was built for CUDA,
``cuda()`` its CUDA version and ``cudnn()`` its cuDNN version (``False``
without them), ``with_tpu`` is ``"OFF"``."""
import torch

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
istaged = False
commit = "cuda-port"
with_gpu = "ON" if torch.version.cuda else "OFF"
with_tpu = "OFF"


def show():
    print(f"full_version: {full_version}")  # noqa: print
    print(f"commit: {commit}")  # noqa: print
    print(f"cuda: {cuda()}")  # noqa: print
    print(f"cudnn: {cudnn()}")  # noqa: print


def cuda():
    return torch.version.cuda or False


def cudnn():
    if not torch.version.cuda:
        return False
    return torch.backends.cudnn.version() or False
