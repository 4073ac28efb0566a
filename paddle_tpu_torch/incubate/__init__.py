"""``paddle.incubate`` of the port: the fused Transformer layers of
``incubate.nn``, the graph and segment ops (``graph_ops.py``), the
optimizers ``LookAhead`` / ``ModelAverage`` / ``DistributedFusedLamb``
(``optimizer.py``), ASP n:m sparsity (``sparsity.py``) and the
softmax-mask fusions, exported as the JAX ``paddle_tpu/incubate`` exports
them."""
import torch

from . import graph_ops, nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import sparsity  # noqa: F401
from .graph_ops import (graph_send_recv, graph_khop_sampler,  # noqa: F401
                        graph_sample_neighbors, graph_reindex,
                        segment_sum, segment_mean, segment_max,
                        segment_min)
from .optimizer import LookAhead, ModelAverage  # noqa: F401
from ..nn.functional import (  # noqa: F401
    softmax_mask_fuse_upper_triangle)


def softmax_mask_fuse(x, mask):
    """softmax(x + mask) over the last axis, in float32, returned in x's
    dtype (reference incubate.softmax_mask_fuse)."""
    xf = x.float() + torch.as_tensor(mask, device=x.device).float()
    return torch.softmax(xf, dim=-1).to(x.dtype)


__all__ = ["nn", "optimizer", "sparsity", "graph_send_recv",
           "softmax_mask_fuse_upper_triangle", "softmax_mask_fuse",
           "LookAhead", "ModelAverage", "graph_khop_sampler",
           "graph_sample_neighbors", "graph_reindex", "segment_sum",
           "segment_mean", "segment_max", "segment_min"]
