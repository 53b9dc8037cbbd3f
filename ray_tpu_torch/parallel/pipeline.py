"""Pipeline parallelism over the ``pipeline`` mesh axis (GPipe).

Port of ``ray_tpu/parallel/pipeline.py``. Each rank of the pipeline group
holds one stage's parameters; microbatches go stage to stage, GPipe's
schedule over M microbatches in M + P - 1 ticks. The reference runs every
stage on every tick inside one jitted program and ``ppermute``s the
activations around the ring; here stage s computes only on the ticks that
hold one of its microbatches (t - s in [0, M)), and sends its activation
one hop to stage s + 1 by point-to-point send and receive. The backward is
not ported (the reference's pipeline is differentiated by JAX; no caller
in either package trains through it).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import AXIS_PIPELINE, Mesh
from ray_tpu_torch.parallel.sharding import tree_map


@torch.no_grad()
def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    *,
    group,
) -> torch.Tensor:
    """This rank applies its stage to the stream of microbatches.

    ``stage_params``: this stage's parameters. ``microbatches``: (M, mb,
    ...), the same full input on every stage (stage 0 consumes it).
    ``stage_fn(params, x)`` must keep x's shape and dtype. Returns (M, mb,
    ...): the outputs on the last stage, zeros elsewhere (the reference's
    contract)."""
    n_stages = collectives.group_size(group)
    stage = collectives.group_rank(group)
    m = microbatches.shape[0]
    outputs = torch.zeros_like(microbatches)
    incoming = torch.empty_like(microbatches[0])
    for t in range(m + n_stages - 1):
        mb = t - stage
        pending = []
        if 0 <= mb < m:
            x = microbatches[mb] if stage == 0 else incoming
            y = stage_fn(stage_params, x)
            if stage == n_stages - 1:
                outputs[mb] = y
            else:
                nxt = dist.get_global_rank(group, stage + 1)
                pending.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if stage > 0 and 0 <= mb + 1 < m:  # the activation of next tick's microbatch
            incoming = torch.empty_like(microbatches[0])
            prv = dist.get_global_rank(group, stage - 1)
            pending.append(dist.P2POp(dist.irecv, incoming, prv, group))
        for work in dist.batch_isend_irecv(pending) if pending else ():
            work.wait()
    return outputs


def make_pipeline_fn(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    *,
    axis_name: str = AXIS_PIPELINE,
):
    """``pipeline(stacked_params, microbatches)`` on every rank.

    ``stacked_params``: this rank's shard of the parameters stacked over
    stages, leading dimension 1 (``shard_params`` with that dimension on
    ``axis_name``, the reference's in_spec ``P(axis_name)``).
    ``microbatches`` (M, mb, ...) is the same on every rank. Returns the
    last stage's outputs (M, mb, ...) on every rank, as the reference's
    global result reads."""
    group = mesh.group(axis_name)

    def pipeline(stacked_params, microbatches):
        mine = tree_map(lambda p: p[0], stacked_params)
        out = pipeline_apply(stage_fn, mine, microbatches, group=group)
        return collectives.broadcast_(out, collectives.group_size(group) - 1, group)

    return pipeline
