"""``paddle.incubate`` of the port: the fused Transformer layers of
``incubate.nn``, the graph and segment ops (``graph_ops.py``) and the
softmax-mask fusions, exported as the JAX ``paddle_tpu/incubate`` exports
them.  LookAhead / ModelAverage (``incubate/optimizer.py``) and ASP
sparsity (``sparsity.py``) are not ported yet (``ROADMAP.md`` Queue 1
item 12)."""
import torch

from . import graph_ops, nn  # noqa: F401
from .graph_ops import (graph_send_recv, graph_khop_sampler,  # noqa: F401
                        graph_sample_neighbors, graph_reindex,
                        segment_sum, segment_mean, segment_max,
                        segment_min)
from ..nn.functional import (  # noqa: F401
    softmax_mask_fuse_upper_triangle)


def softmax_mask_fuse(x, mask):
    """softmax(x + mask) over the last axis, in float32, returned in x's
    dtype (reference incubate.softmax_mask_fuse)."""
    xf = x.float() + torch.as_tensor(mask, device=x.device).float()
    return torch.softmax(xf, dim=-1).to(x.dtype)


__all__ = ["nn", "graph_send_recv", "softmax_mask_fuse_upper_triangle",
           "softmax_mask_fuse", "graph_khop_sampler",
           "graph_sample_neighbors", "graph_reindex", "segment_sum",
           "segment_mean", "segment_max", "segment_min"]
