"""``paddle.incubate`` of the port: the fused Transformer layers of
``incubate.nn``.  The rest of ``paddle_tpu/incubate/`` (LookAhead and
ModelAverage, ASP sparsity, the graph and segment ops, the softmax-mask
fusions) is not ported yet (``ROADMAP.md`` Queue 1 item 12)."""
from . import nn  # noqa: F401

__all__ = ["nn"]
