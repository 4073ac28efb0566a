"""Vision for the port: ``datasets``, ``transforms``, the ``models`` zoo,
the detection ``ops``, and the image backend of
``paddle_tpu/vision/__init__.py``."""
from . import datasets, models, ops, transforms  # noqa: F401
from ..framework.errors import enforce

_image_backend = "pil"


def set_image_backend(backend: str):
    """``'pil'`` | ``'cv2'`` | ``'tensor'``."""
    enforce(backend in ("pil", "cv2", "tensor"),
            f"unknown image backend {backend!r}")
    global _image_backend
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path: str, backend=None):
    """Load an image per the active backend: ``'tensor'`` / ``'cv2'`` give
    HWC numpy (``'cv2'`` in BGR order), ``'pil'`` a PIL Image."""
    b = backend or _image_backend
    from PIL import Image
    img = Image.open(path)
    if b == "pil":
        return img
    import numpy as np
    arr = np.asarray(img)
    if b == "cv2" and arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[..., ::-1]
    return arr


__all__ = ["set_image_backend", "get_image_backend", "image_load",
           "transforms", "datasets", "models", "ops"]
