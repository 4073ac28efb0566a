"""GPT under pipeline parallelism, one process a stage: the port of
``paddle_tpu/models/gpt_pipeline.py`` (``GPTPipeline``) and of the 1F1B
schedule of ``paddle_tpu/distributed/pipeline.py`` (``one_f_one_b_spmd``;
reference pipeline_parallel.py:80-152, p2p_communication.py:216).

The JAX package runs every stage in one SPMD program (stages stacked on a
pp-sharded axis, rolled between ticks).  Here each stage is a process that
holds its own layers (a :class:`~.gpt.GPTForCausalLM` built under the
hybrid group: stage 0 the embeddings, the last stage the final LN and the
tied head), and activations and their gradients move by ``send`` /
``recv`` on the pp group (``collective.p2p_exchange``) in the
non-interleaved 1F1B order: ``pp - stage - 1`` warm-up forwards, then one
forward and one backward at a time, then the drain of the remaining
backwards.  A stage keeps at most ``pp - stage`` micro-batches' inputs
alive, independent of the micro-batch count.

As in JAX, the labels are shifted before the batch is split into
micro-batches (``split_microbatches``), each micro-batch's loss is its
mean cross-entropy over ``num_microbatches``, and the step's loss is their
sum; only the last stage knows it, so it is broadcast over pp.  The tied
``wte`` has two gradients, the embedding's on stage 0 and the head's on
the last stage; they are summed over the embedding group
(:meth:`allreduce_shared_weight_gradients`, the reference's
``allreduce_shared_weight_gradients``, pipeline_parallel.py:147), so both
copies take the same update.  Data parallelism averages every gradient
over the dp group after the schedule.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from .. import amp
from ..distributed import collective
from ..distributed import topology as topo
from ..distributed.parallel import allreduce_gradients, sync_params_buffers
from ..framework.errors import enforce

__all__ = ["GPTPipeline", "split_microbatches", "merge_microbatches"]


def split_microbatches(batch: torch.Tensor, num_microbatches: int
                       ) -> List[torch.Tensor]:
    """(B, ...) -> ``num_microbatches`` tensors of (B / M, ...)."""
    b = batch.shape[0]
    enforce(b % num_microbatches == 0,
            f"batch {b} not divisible by {num_microbatches} microbatches")
    return list(batch.chunk(num_microbatches, dim=0))


def merge_microbatches(mbs: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(mbs), dim=0)


class GPTPipeline:
    """This rank's stage of a GPT pipeline.  ``train_batch`` runs one
    training step (reference ``PipelineParallel.train_batch``);
    ``forward_backward`` the schedule alone, leaving the gradients in the
    parameters."""

    def __init__(self, model, num_stages: int, num_microbatches: int,
                 comm_buffer_size: float = 25):
        hcg = topo.get_hybrid_communicate_group()
        enforce(hcg is not None, "GPTPipeline needs fleet.init with a "
                "pp_degree (a hybrid group)")
        enforce(hcg.get_pipe_parallel_world_size() == num_stages,
                f"{num_stages} stages but the hybrid group has pp = "
                f"{hcg.get_pipe_parallel_world_size()}")
        enforce(num_microbatches >= 1, "need at least one microbatch")
        self.model = model
        self.config = model.config
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.comm_buffer_size = comm_buffer_size
        self.stage = hcg.get_stage_id()
        self.first, self.last = hcg.is_first_stage(), hcg.is_last_stage()
        ranks = hcg.axis_ranks("pp")
        self.prev_rank = None if self.first else ranks[self.stage - 1]
        self.next_rank = None if self.last else ranks[self.stage + 1]
        self.layers = [model.gpt.h[i] for i in model.gpt.stage_layers]
        self._params = [p for p in model.parameters() if p.requires_grad]
        sync_params_buffers(model, "dp")

    # -- the torch.nn.Module surface the trainer touches ------------------
    def parameters(self):
        return self.model.parameters()

    def named_parameters(self, *a, **k):
        return self.model.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self.model.state_dict(*a, **k)

    def train(self, mode: bool = True):
        self.model.train(mode)
        return self

    def eval(self):
        return self.train(False)

    # -- pieces of a stage ---------------------------------------------------
    def _act_dtype(self) -> torch.dtype:
        """The residual stream's dtype (what crosses stage boundaries): the
        config's activation dtype, or the parameters' under O2."""
        c = self.config
        if c.dtype != "float32":
            return c.torch_dtype
        return next(iter(self._params)).dtype

    def _stage_forward(self, x, ids, labels):
        """This stage on one micro-batch: from ids (stage 0) or the
        received activation through its layers, and on the last stage the
        final LN and the tied head's loss over ``num_microbatches``."""
        gpt = self.model.gpt
        if self.first:
            x = gpt.embed(ids)
        for layer in self.layers:
            x = layer(x)
        if not self.last:
            return x
        loss, _ = self.model.lm_loss(gpt.ln_f(x), labels)
        return loss / self.num_microbatches

    # -- the schedule ----------------------------------------------------------
    def forward_backward(self, input_ids: torch.Tensor,
                         labels: torch.Tensor, *, level: str = "O1",
                         scaler: Optional[amp.GradScaler] = None
                         ) -> torch.Tensor:
        """The 1F1B schedule over ``num_microbatches`` micro-batches of
        this data-parallel replica's batch; gradients accumulate in the
        parameters.  Returns the replica's loss (the sum of the
        micro-batches' losses), the same on every stage.  ``level`` is the
        autocast level, ``"O0"`` for none; ``scaler`` scales each
        micro-batch's loss before its backward."""
        from .gpt import shift_labels
        M = self.num_microbatches
        ids_mb = split_microbatches(input_ids, M)
        lab_mb = split_microbatches(shift_labels(labels), M)
        mb, s = ids_mb[0].shape
        act = (mb, s, self.config.hidden_size)
        dev, dtype = input_ids.device, self._act_dtype()

        def cast():
            return (contextlib.nullcontext() if level == "O0"
                    else amp.auto_cast(level=level, dtype="bfloat16"))
        total = torch.zeros((), dtype=torch.float32, device=dev)
        warmup = min(self.num_stages - self.stage - 1, M)
        stash = []
        fwd_i = [0]

        def recv_forward():
            if self.first:
                return None
            return collective.p2p_exchange(
                [], [(act, dtype, dev, self.prev_rank)], "pp")[0]

        def forward(x):
            nonlocal total
            i = fwd_i[0]
            fwd_i[0] += 1
            if x is not None:
                x.requires_grad_(True)
            with cast():
                y = self._stage_forward(x, ids_mb[i], lab_mb[i])
            if self.last:
                total = total + y.detach().float()
                if scaler is not None:
                    y = scaler.scale(y)
            else:
                enforce(y.dtype == dtype, f"stage {self.stage} made a "
                        f"{y.dtype} activation, the pipeline carries {dtype}")
            stash.append((x, y))
            return y

        def backward(dy):
            x, y = stash.pop(0)
            torch.autograd.backward(y, None if self.last else dy)
            return None if x is None else x.grad

        def exchange(send=None, to=None, recv_from=None):
            sends = [] if send is None else [(send, to)]
            recvs = [] if recv_from is None else [(act, dtype, dev,
                                                   recv_from)]
            got = collective.p2p_exchange(sends, recvs, "pp")
            return got[0] if got else None

        for _ in range(warmup):
            y = forward(recv_forward())
            exchange(y.detach(), self.next_rank)
        x = recv_forward() if M - warmup > 0 else None
        for i in range(M - warmup):
            y = forward(x)
            dy = (None if self.last
                  else exchange(y.detach(), self.next_rank, self.next_rank))
            dx = backward(dy)
            if i == M - warmup - 1:
                x = None
                if not self.first:
                    exchange(dx, self.prev_rank)
            elif self.first:
                x = None
            else:
                x = exchange(dx, self.prev_rank, self.prev_rank)
        for _ in range(warmup):
            dy = exchange(recv_from=self.next_rank)
            dx = backward(dy)
            if not self.first:
                exchange(dx, self.prev_rank)
        return collective.broadcast(total, src=self.num_stages - 1,
                                    group="pp")

    def allreduce_shared_weight_gradients(self) -> None:
        """Sum the tied ``wte``'s gradients of the first and last stage
        over the embedding group."""
        hcg = topo.get_hybrid_communicate_group()
        group = hcg.get_embedding_group()
        if group is None or not (self.first or self.last):
            return
        w = self.model.gpt.wte.weight
        g = w.grad if w.grad is not None else torch.zeros_like(w)
        w.grad = collective.all_reduce(g, group=group)

    def train_batch(self, input_ids: torch.Tensor, labels: torch.Tensor,
                    optimizer=None, *, level: str = "O1",
                    scaler: Optional[amp.GradScaler] = None,
                    scheduler=None) -> torch.Tensor:
        """One training step of this rank (every rank of the world calls
        it together): zero the gradients, the 1F1B schedule, the tied
        embedding's sum, the dp average of every gradient, the optimizer
        step (through ``scaler`` when given), the scheduler's step.
        Returns the step's loss averaged over dp, detached, the same on
        every rank."""
        self.model.train()
        for p in self._params:
            p.grad = None
        loss = self.forward_backward(input_ids, labels, level=level,
                                     scaler=scaler)
        self.allreduce_shared_weight_gradients()
        allreduce_gradients(self._params, "dp", self.comm_buffer_size)
        if optimizer is not None:
            if scaler is not None:
                scaler.step(optimizer)
            else:
                optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return collective.all_reduce(loss, op=collective.ReduceOp.AVG,
                                     group="dp")
