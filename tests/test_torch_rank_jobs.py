"""Rank-side jobs of the port's multi-process tests, and their pool.

No tests here. The jobs run in the gloo rank processes of
``ray_tpu_torch.parallel.launch.RankPool``, which import this module by
name: it imports torch, numpy and the port, never jax, and every job
checks that jax stayed out of its process. Inputs arrive as numpy arrays
made by the test with a seed; results go back as numpy arrays.
"""

import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import RankPool

WORLD = 4
JOB_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo rank processes for the module's tests; a job that fails,
    hangs past ``JOB_TIMEOUT_S`` or loses a rank kills them, and the next
    job starts new ones."""
    pool = RankPool(WORLD, device="cpu", store_dir=str(tmp_path_factory.mktemp("rendezvous")),
                    timeout_s=JOB_TIMEOUT_S)
    yield pool
    pool.close()


def _no_jax() -> None:
    if "jax" in sys.modules:
        raise AssertionError("jax was imported in a rank process")


def _mesh(**sizes):
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(**sizes))


def _block(a: np.ndarray, dim: int, index: int, n: int) -> torch.Tensor:
    size = a.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(np.take(a, range(index * size, (index + 1) * size), axis=dim)))


def train_steps(mesh_sizes, cfg, params, tokens, targets, lr, steps, context_parallel):
    """``steps`` AdamW steps of the port's sharded ``build_lm_train_step``
    from the full ``params``; per step (loss, grad_norm), this rank's shard
    shapes, and (rank 0) the gathered parameters."""
    from ray_tpu_torch.models.transformer import param_logical_axes
    from ray_tpu_torch.parallel.sharding import DEFAULT_LM_RULES, gather_params, shard_params
    from ray_tpu_torch.parallel.spmd import build_lm_train_step
    from ray_tpu_torch.weights import params_from_jax

    mesh = _mesh(**mesh_sizes)
    logical = param_logical_axes(cfg)
    bundle = build_lm_train_step(cfg, mesh, learning_rate=lr, context_parallel=context_parallel)
    local = shard_params(params_from_jax(params, device="cpu"), logical, DEFAULT_LM_RULES, mesh)
    state = bundle.state_from_params(local)
    shapes = {k: tuple(v.shape) for k, v in state["params"].items()}
    tok, tgt = bundle.shard_batch(tokens, targets)
    metrics = []
    for _ in range(steps):
        state, m = bundle.step_fn(state, tok, tgt)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = gather_params(state["params"], logical, DEFAULT_LM_RULES, mesh)
    _no_jax()
    return {"metrics": metrics, "shapes": shapes, "batch": tuple(tok.shape),
            "params": {k: v.numpy() for k, v in full.items()} if mesh.rank == 0 else None}


def ring(q, k, v, d_out, causal):
    """Ring attention over a context axis of every rank: this rank's
    shards of out and of the gradients of sum(out * d_out)."""
    from ray_tpu_torch.ops.attention import make_context_parallel_attention

    mesh = _mesh(context=WORLD)
    r = mesh.axis_index("context")
    ql, kl, vl = (_block(a, 1, r, WORLD).requires_grad_() for a in (q, k, v))
    out = make_context_parallel_attention(mesh, causal=causal)(ql, kl, vl)
    out.backward(_block(d_out, 1, r, WORLD))
    _no_jax()
    return [t.detach().numpy() for t in (out, ql.grad, kl.grad, vl.grad)]


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def gpipe(w, b, microbatches):
    """GPipe over a pipeline axis of every rank: the outputs each rank
    returns."""
    from ray_tpu_torch.parallel.pipeline import make_pipeline_fn
    from ray_tpu_torch.parallel.sharding import shard_params

    mesh = _mesh(pipeline=WORLD)
    full = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    mine = shard_params(full, {"w": ("stage", None, None), "b": ("stage", None)},
                        {"stage": "pipeline"}, mesh)
    out = make_pipeline_fn(_stage, mesh)(mine, torch.from_numpy(microbatches))
    _no_jax()
    return out.numpy()


def moe(cfg, params, x):
    """Expert-parallel ``moe_mlp`` over an expert axis of every rank:
    this rank's rows of y, the aux loss, and its experts' count."""
    from ray_tpu_torch.models.moe import moe_mlp, moe_param_logical_axes
    from ray_tpu_torch.parallel.sharding import DEFAULT_LM_RULES, shard_params
    from ray_tpu_torch.weights import params_from_jax

    mesh = _mesh(expert=WORLD)
    local = shard_params(params_from_jax(params, device="cpu"), moe_param_logical_axes(),
                         DEFAULT_LM_RULES, mesh)
    y, aux = moe_mlp(local, _block(x, 0, mesh.axis_index("expert"), WORLD), cfg, mesh=mesh)
    _no_jax()
    return y.numpy(), float(aux), local["w_in"].shape[0]



def forward_and_grads(mesh_sizes, cfg, params, tokens, targets, mask):
    """The sharded ``forward`` and masked ``loss_fn`` of one rank, with the
    gradients summed over the axes they are partial on and gathered: this
    rank's logits block (its batch, sequence and vocabulary slices, and
    where they start), the loss, and (rank 0) the full gradients."""
    from ray_tpu_torch.models.transformer import ShardedModel, forward, loss_fn, param_logical_axes
    from ray_tpu_torch.parallel.collectives import all_reduce_
    from ray_tpu_torch.parallel.sharding import (
        DEFAULT_LM_RULES,
        batch_sharding,
        gather_params,
        shard_params,
    )
    from ray_tpu_torch.parallel.spmd import put_global
    from ray_tpu_torch.weights import params_from_jax

    mesh = _mesh(**mesh_sizes)
    ctx = "context" if mesh.shape["context"] > 1 else None
    logical = param_logical_axes(cfg)
    local = shard_params(params_from_jax(params, device="cpu"), logical, DEFAULT_LM_RULES, mesh)
    spec = batch_sharding(mesh)
    tok, tgt, msk = (put_global(a, spec, mesh) for a in (tokens, targets, mask))
    with torch.no_grad():
        logits = forward(local, tok, cfg, mesh=mesh, context_axis=ctx)
    leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
    loss = loss_fn(leaves, tok, tgt, cfg, mesh=mesh, context_axis=ctx, loss_mask=msk)
    loss.backward()
    model = ShardedModel(cfg, mesh, DEFAULT_LM_RULES, ctx)
    grads = {k: all_reduce_(v.grad, mesh.group(model.grad_axes(k))) for k, v in leaves.items()}
    full = gather_params(grads, logical, DEFAULT_LM_RULES, mesh)
    _no_jax()
    starts = (mesh.axis_index(("data", "fsdp")) * tok.shape[0], model.seq_index * tok.shape[1],
              model.vocab_start)
    return {"logits": logits.numpy(), "starts": starts, "loss": float(loss),
            "grads": {k: v.numpy() for k, v in full.items()} if mesh.rank == 0 else None}


def mesh_layout(sizes, drop_trivial_axes):
    """This rank's mesh: axis names, shape and coordinates."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(**sizes), drop_trivial_axes=drop_trivial_axes)
    _no_jax()
    return mesh.axis_names, mesh.shape, mesh.coords


def wrong_size_mesh():
    """A mesh whose size is not the world size: the error's text."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    try:
        create_mesh(MeshConfig(data=3, tensor=2))
    except ValueError as e:
        return str(e)
    return None


def context_without_ring():
    """``build_lm_train_step`` on a context=4 mesh without
    ``context_parallel``: the error's text."""
    from ray_tpu_torch.models.transformer import TINY
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    try:
        build_lm_train_step(TINY, _mesh(context=WORLD))
    except ValueError as e:
        return str(e)
    return None


def fail_on(rank_to_fail):
    """Raise on one rank while the others wait in a collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    dist.barrier()


def sleep_for(seconds):
    import time

    time.sleep(seconds)
