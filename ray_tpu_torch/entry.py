"""Entry points of the port: the counterparts of ``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)``: a forward step on the flagship
model, a GPT-J-architecture decoder (parallel attention + MLP block, gelu
MLP) with the reference's flagship configuration, its parameters and
example tokens on the card unless ``device`` says otherwise.

``dryrun_multichip(n)`` builds an n-rank mesh with the reference's
factoring into pipeline, tensor, context, fsdp and data axes, runs one
sharded training step of the tiny flagship configuration on it, and, when
the mesh has a pipeline axis, a GPipe segment against a sequential
evaluation: one process per rank, on the GPUs (NCCL) or the CPU (gloo).
"""

from __future__ import annotations

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, forward, init_params


def flagship_config(tiny: bool = False) -> TransformerConfig:
    """The reference's flagship configuration (``__graft_entry__``), or
    its tiny variant for the dry run."""
    if tiny:
        return TransformerConfig(
            vocab_size=512,
            d_model=128,
            n_layers=2,
            n_heads=4,
            d_ff=512,
            max_seq_len=256,
            parallel_block=True,
            use_swiglu=False,
            remat=False,
        )
    return TransformerConfig(
        vocab_size=50432,
        d_model=1024,
        n_layers=8,
        n_heads=16,
        d_ff=4096,
        max_seq_len=1024,
        parallel_block=True,
        use_swiglu=False,
    )


def entry(device: DeviceLike = "cuda"):
    """Returns (fn, (params, tokens)): ``fn(params, tokens)`` is the
    flagship forward, tokens (2, 256) -> logits (2, 256, vocab)."""
    dev = resolve_device(device)
    cfg = flagship_config()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tokens = torch.zeros((2, 256), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def mesh_factors(n_devices: int) -> dict:
    """The reference's factoring of ``n_devices`` (one rank per process):
    pipeline outermost when there are at least 4 ranks, then tensor,
    context and fsdp of 2 where they divide, the rest on data."""
    pipeline = 2 if (n_devices > 1 and n_devices % 2 == 0 and n_devices >= 4) else 1
    tensor = 2 if n_devices % (pipeline * 2) == 0 else 1
    context = 2 if n_devices % (pipeline * tensor * 2) == 0 else 1
    fsdp = 2 if n_devices % (pipeline * tensor * context * 2) == 0 else 1
    data = n_devices // (pipeline * tensor * context * fsdp)
    return dict(data=data, fsdp=fsdp, context=context, tensor=tensor, pipeline=pipeline)


def _gpipe_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _dryrun_rank(factors: dict) -> dict:
    import numpy as np

    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.pipeline import make_pipeline_fn
    from ray_tpu_torch.parallel.sharding import shard_params
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    mesh = create_mesh(MeshConfig(**factors))
    cfg = flagship_config(tiny=True)
    bundle = build_lm_train_step(cfg, mesh, learning_rate=1e-3, context_parallel=True)
    state = bundle.init_state(seed=0)
    batch = max(2, 2 * factors["data"] * factors["fsdp"])
    seq = 128  # divisible by the context axis
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size - 1, (batch, seq), dtype=np.int32)
    tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
    state, metrics = bundle.step_fn(state, tok, tgt)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    gpipe = "skipped"
    stages = factors["pipeline"]
    if stages > 1:
        # a GPipe ring whose stage-to-stage hops cross the pipeline group's
        # processes, against a sequential host evaluation of the stages
        d = 8
        prng = np.random.default_rng(7)
        stacked = {"w": prng.normal(0, 0.5, (stages, d, d)), "b": prng.normal(0, 0.1, (stages, d))}
        micro = prng.normal(0, 1, (3, 2, d))
        tensors = {k: torch.tensor(v, dtype=torch.float32, device=mesh.device) for k, v in stacked.items()}
        mine = shard_params(tensors, {"w": ("stage", None, None), "b": ("stage", None)},
                            {"stage": "pipeline"}, mesh)
        out = make_pipeline_fn(_gpipe_stage, mesh)(
            mine, torch.tensor(micro, dtype=torch.float32, device=mesh.device))
        ref = micro.astype(np.float32)
        for s in range(stages):
            ref = np.tanh(ref @ stacked["w"][s].astype(np.float32) + stacked["b"][s].astype(np.float32))
        np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-5, atol=1e-6)
        gpipe = "verified"
    return {"mesh": dict(mesh.shape), "processes": mesh.size, "loss": loss,
            "step": state["step"], "gpipe": gpipe}


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> dict:
    """One sharded training step over an ``n_devices``-rank mesh, in one
    process per rank: on ``device="cuda"`` rank r drives ``cuda:r``
    (NCCL) and needs that many visible GPUs; on ``"cpu"`` the ranks are
    gloo processes. Prints and returns rank 0's summary."""
    from ray_tpu_torch.parallel.launch import RankPool

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"{n_devices} ranks need as many GPUs; {torch.cuda.device_count()} visible")
    factors = mesh_factors(n_devices)
    with RankPool(n_devices, device=dev.type, timeout_s=300.0) as pool:
        summary = pool.run(_dryrun_rank, factors)[0]
    print(
        f"dryrun_multichip ok: mesh={summary['mesh']} processes={summary['processes']} "
        f"loss={summary['loss']:.4f} step={summary['step']} gpipe={summary['gpipe']}"
    )
    return summary
