#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
It builds the port's CUDA kernels from ``ray_tpu_torch/csrc``, shows with
``cuobjdump -sass`` that the flash libraries hold wgmma (HGMMA) and TMA
(UTMALDG) instructions and the paged library asynchronous copies, holds each
kernel against its plain PyTorch version on the card at the serving path's
shapes, runs the full-width Llama-2-7B forward through the flash kernel,
and then drives the port's serving path: an ``LLMServer`` replica serving
Llama-2-7B (random weights from a seed) through flash-attention prefill and
paged-attention decode, and ``generate`` over a dense KV cache (a static
batch: flash prefill, paged decode over one whole-sequence block per row).
Then ViT-L/16 (forward, gradients and SGD steps through both flash kernels
at head_dim 64), the MNIST nets, the MoE MLP and a checkpoint round trip;
then the RL library (``ray_tpu_torch.rl``, no kernel): every learner update
on the card against the CPU, PPO learning CartPole at the reference's
configuration, and two training steps of each other algorithm;
then the training path: the flash-attention backward kernel against its
plain version; phase ``ring_schedule``: ring attention's whole per-hop
schedule in one process (4 sequence shards of 8192 tokens, causal, at
Llama-2-7B's and GPT-J's attention) through both flash kernels, held
against the same kernels over the whole sequence and against the plain
versions; gradients of a 4-layer GPT-J through flash against plain and
fp32; ``build_lm_train_step`` training GPT-J-6B at full width and depth
for 5 AdamW steps on one fixed batch; and phase ``spmd_mesh1``: the same
model through the mesh entry points (``distributed.initialize``,
``create_mesh()``, ``build_lm_train_step(cfg, mesh)``, ``shard_batch``)
on a one-rank NCCL group, 3 steps from the same seed and batch, held to
the single-device steps. At one rank every axis is trivial, so no
collective runs there: the phase shows the mesh path's set-up and its
step at full size, not NCCL or the gathers. Before it, the Train library
on the port's runtime (``phase_train_lib``): phase ``train_gpu`` runs
phase_train's GPT-J-6B step through ``DataParallelTrainer`` in a
``use_gpu`` worker's own process for 3 steps (``train.report`` each
step), held to phase_train's losses, with the flash launches counted in
that process; phase ``train_restart`` trains the scaled-down GPT-J of
``examples/gptj_finetune.py`` (head_dim 64) through a checkpoint, an
injected failure and a restart from the checkpoint, against an
uninterrupted run, each attempt's worker in a one-rank NCCL group that the
trainer joins and destroys; phase ``rl_learner_group`` runs an IMPALA
update through an ``SPMDLearnerGroup`` of one GPU learner actor (a one-rank
NCCL group, its all-reduces included) against the in-process learner on
the card. Phase ``spmd_tensor2``: two
rank processes sharing the card through gloo on CUDA tensors (NCCL
refuses two ranks on one device) train GPT-J's width at 4 layers on a
tensor=2 mesh, held to the single-device step; this is the phase where
collectives (gloo's all-reduces, staged through the host) run on the
card. (The other collectives of the mesh path, and gloo's send and
receive, which take no CUDA tensors, are held against the JAX package on
CPU gloo ranks in the tests, and run over NCCL only on a machine with
four cards: ``tests/test_torch_kernels_gpu.py -k four_cards``.)
Phase ``runtime_gpu``: the port's own core runtime. Before the driver drops
its serving model, its ``LLMServer`` serves three prompts and then one of
them alone; after phase ``rl``, ``ray_tpu_torch.init()`` must detect the
one GPU, a ``num_gpus=1`` actor builds the same Llama-2-7B replica in its
own process (``CUDA_VISIBLE_DEVICES=0``) and serves the same requests
through both kernels, counted there by the wrappers and by torch.profiler;
the solo prompt's tokens must equal the driver's (or, where they part,
the step's logits meet ``_logit_rule``); a ``num_gpus=1`` task waits
while the actor holds the card and runs after the kill; PPO samples from
two remote CPU runner actors and heals after losing one; two CPU actors
meet through the runtime's KV and all-reduce over gloo.
Phase ``serve_gpu``: the serve library. ``serve.run(llm_deployment(...))``
puts the same Llama-2-7B in a ``num_gpus=1`` replica; the three prompts go
through a streaming handle and the 700-token prompt alone over HTTP
through the proxy (on an ephemeral port); the replica's own process counts
32 flash launches per prefill and 32 paged launches per decode step; the
solo tokens are held to the driver's as in runtime_gpu; after
``serve.delete`` a pending ``num_gpus=1`` task gets the card.
Phase ``dag_pipeline`` (while this process holds Llama-2-7B):
``dag.compile_torch_pipeline`` over ``forward_stages`` (embed, 32 blocks,
norm and unembed) captures one CUDA graph per prompt length (2,048 and 128
tokens); its logits must equal eager ``forward``'s bit for bit, the capture
must hold 32 flash launches and replays none. The data library
(``ray_tpu_torch.data``): phase ``data_train_gpu``, the slice's main path,
trains GPT-J-6B at full size through ``DataParallelTrainer(datasets=...)``
in a ``use_gpu`` worker fed by ``train.get_dataset_shard("train")
.iter_torch_batches(batch_size=1)`` (pinned staging, the iterator's copy
stream), held to phase_train's losses, 56 / 28 flash launches per step
counted in the worker, batches on the card equal to the dataset's rows and
the step plane's host_to_device stage non-zero every step; phase
``data_feed_vit`` feeds 4,096 images made by ``map_batches`` tasks through
``iter_torch_batches(batch_size=256)`` into ViT-L/16's forward, every batch
and its logits equal to the same images put on the card in one piece.
Every phase prints one JSON object; any failure or missed tolerance raises
(non-zero exit). The last two lines are the per-kernel summary and the
result line read by automation:

    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
# A kernel's bf16 output against its plain version's, elementwise:
# |kernel - plain| <= ATOL + RTOL * |plain|. Both round the output to bf16
# (relative step 2**-8, so one step at |out| in [2, 4) is 0.0156) and the
# plain version also rounds the normalised probabilities to bf16 before the
# PV product, while the kernels keep them in fp32: about one bf16 step of
# the output.
ATOL, RTOL = 1e-2, 1e-2
TOL_RULE = f"|kernel - plain| <= {ATOL} + {RTOL} * |plain| elementwise"
# Full-width forward, flash vs plain attention, both bf16 on the card: the
# two attentions differ by bf16 roundings that 32 layers then carry along.
# Logits are O(1) (unit-RMS final activations against 1/sqrt(d) weights).
# Beside the absolute bounds, the flash logits may stray from an fp32 run of
# the same model no further than FWD_NOISE times the plain bf16 logits do:
# the kernel adds no more error than bf16 rounding already does. Argmax
# agreement is reported, not held: random weights leave near-ties among
# 32000 logits that any bf16 rounding flips.
FWD_MAX_ABS, FWD_MEAN_ABS, FWD_NOISE = 0.25, 0.03, 1.2
# First token of a request against forward's argmax at length-1: the two
# run the same bf16 model at different padded lengths, so GEMM tiling may
# differ; a mismatch is accepted only where the top two logits of forward
# lie within this of each other.
TOP2_GAP = 0.05
# Prompt lengths of phase_decode_check's batch (slot 6 inactive); the
# paged kernel is also timed alone at these contexts.
DECODE_LENGTHS = [1500, 16, 700, 33, 1100, 250, 0, 999]
# Kernel rows at this slice's shapes: ViT-L/16's attention (phase_vit), and
# the paged kernel over phase_dense_generate's cache (8 x 544 slots,
# contexts of its decode steps, 513-543).
VIT_FLASH_CASE = "vit_l16_full_s197"
DENSE_PAGED_CASE = "dense_b8_bs544"
DENSE_CONTEXTS = [512, 520, 527, 531, 536, 539, 541, 543]


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_category(name: str) -> str:
    """The layer a device kernel belongs to, by its name."""
    if "flash_bwd" in name or "bwd_delta" in name:
        return "flash_bwd"
    for key, cat in (("flash_fwd", "flash_fwd"), ("paged_", "paged"), ("nvjet", "gemm"),
                     ("gemm", "gemm"), ("multi_tensor_apply", "foreach (optimizer, norms)"),
                     ("Memcpy", "memcpy/memset"), ("Memset", "memcpy/memset")):
        if key in name:
            return cat
    return "other (elementwise, reductions, copies)"


def device_profile(fn, steps: int, count_ops=()) -> dict:
    """Wall time, device (kernel) time and the device's idle share per call
    of ``fn`` under torch.profiler, device time by layer
    (``kernel_category``), the kernels that took the most device time, the
    device-side spans of user annotations (the optimizer's step), and how
    often each host op named in ``count_ops`` ran. The profiler's own cost
    inflates the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict = {}
    spans: dict = {}
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        # a user annotation spans the kernels it launched: kept apart, or
        # their time would count twice
        into = spans if e.is_user_annotation else by_name
        into[e.name] = into.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
        launches += not e.is_user_annotation and not e.name.startswith(("Memcpy", "Memset"))
    busy = sum(by_name.values())
    by_cat: dict = {}
    for name, ms in by_name.items():
        by_cat[kernel_category(name)] = by_cat.get(kernel_category(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": busy if busy else "not measured",
           "idle_share": 1 - busy / wall_ms if busy else "not measured",
           "device_ms_by_layer": by_cat,
           "top_kernels_ms": [[name[:80], ms] for name, ms in top]}
    if spans:
        out["annotation_spans_ms"] = spans
    out["kernels_per_call"] = launches / steps
    out["copies_per_call"] = {
        way: sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and e.name.startswith("Memcpy") and way in e.name) / steps
        for way in ("HtoD", "DtoH")}
    if count_ops:
        out["op_counts"] = {op: sum(1 for e in prof.events() if e.name == op) for op in count_ops}
    return out


def kernel_split(fn, keys: dict, steps: int = 5) -> dict:
    """Device ms per call of ``fn`` for each kernel whose name holds one of
    ``keys``' values (``device_profile``'s top kernels)."""
    top = device_profile(fn, steps)["top_kernels_ms"]
    return {name: sum(ms for kernel, ms in top if key in kernel) for name, key in keys.items()}


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (out - ref).abs()
    excess = (diff - (ATOL + RTOL * ref.abs())).max().item()
    err = diff.max().item()
    if excess > 0:
        raise AssertionError(f"{what}: max abs err {err} beyond atol {ATOL} + rtol {RTOL}")
    return err


# -- phases --------------------------------------------------------------


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("card", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build() -> None:
    from ray_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"# nvcc {name}: {line.strip()}")
    log("build", seconds=secs, sources=sorted(logs))


def _cuobjdump() -> str:
    """cuobjdump beside nvcc, else the copy in Triton's package."""
    from pathlib import Path

    from ray_tpu_torch import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if tool.exists():
        return str(tool)
    try:
        import triton
    except ImportError as e:
        raise RuntimeError("sass: no cuobjdump beside nvcc and no triton package") from e
    tool = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"sass: no cuobjdump beside nvcc nor at {tool}")
    return str(tool)


# SASS opcodes: warpgroup matrix multiply, and the asynchronous copies
# (TMA tile, bulk copy, cp.async)
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "LDGSTS")
ASYNC_COPIES = ("UTMALDG", "UBLKCP", "LDGSTS")


def phase_sass() -> dict:
    """What the redesigned libraries were compiled to: each must hold an
    asynchronous copy (UTMALDG, UBLKCP or LDGSTS), and the flash
    libraries HGMMA (wgmma) too."""
    from ray_tpu_torch import _build

    tool = _cuobjdump()
    counts = {}
    for name in ("flash_attention", "flash_attention_bwd", "paged_attention"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        counts[name] = {op: sum(1 for line in sass.splitlines() if op in line) for op in SASS_OPS}
    log("sass", cuobjdump=tool, counts=counts)
    for name, c in counts.items():
        if name.startswith("flash") and not c["HGMMA"]:
            raise AssertionError(f"sass: no HGMMA in {name}: {c}")
        if not any(c[op] for op in ASYNC_COPIES):
            raise AssertionError(f"sass: no asynchronous copy in {name}: {c}")
    return counts


def check_flash(name, b, s, h, kv, d, causal, gen):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from ray_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    dev = "cuda"
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = max_err(out, ref, f"flash {name}")
    lse_err = (lse - ref_lse).abs().max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"flash {name}: lse err {lse_err} > 1e-3 (fp32 statistics)")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, causal=causal), iters=5)
    # the library call takes BHSD with repeated kv heads, made outside the timing
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(h // kv, dim=2).transpose(1, 2) for x in (k, v))
    lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 4.0 * d * pairs
    nbytes = 2.0 * (2 * b * s * h * d + 2 * b * s * kv * d) + 4.0 * b * h * s
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(case=name, shape=[b, s, h, kv, d], causal=causal, max_abs_err=err,
               lse_err=lse_err, tol=TOL_RULE, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
               vs_library=ms / lib_ms)
    log("kernel_flash", **row)
    return row


# Backward kernel against an fp32 oracle (the plain backward run in fp32
# from the same bf16 values, with an fp32 forward). The kernel rounds P and
# dS to bf16 before its tensor-core products, the plain backward keeps them
# in fp32, so the kernel's error is held to BWD_NOISE times the plain
# backward's own (both against the oracle; FlashAttention-2's convention),
# per gradient, in relative Frobenius norm. A CPU emulation of those two
# roundings measured 1.3-1.4x. BWD_CAP bounds ||kernel - plain|| / ||plain||
# per gradient: the roundings give ~0.003 (bf16's relative step is 2**-8),
# and a wrong index or mask gives O(1).
BWD_NOISE, BWD_CAP = 2.0, 1e-2


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return ((x - ref).norm() / ref.norm()).item()


def check_flash_bwd(name, b, s, h, kv, d, causal, gen):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from ray_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_reference,
    )

    dev = "cuda"
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    d_out = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal=causal)
    args = (q, k, v, out, lse, d_out)
    grads = flash_attention_backward(*args, causal=causal)
    again = flash_attention_backward(*args, causal=causal)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(x, y) for x, y in zip(grads, again))
    plain = flash_attention_backward_reference(*args, causal=causal)
    f32 = [x.float() for x in (q, k, v)]
    out32, lse32 = flash_attention_reference(*f32, causal=causal)
    exact = flash_attention_backward_reference(*f32, out32, lse32, d_out.float(), causal=causal)
    del out32, lse32
    errs = {}
    for gname, g, p, e in zip(("dq", "dk", "dv"), grads, plain, exact):
        if not torch.isfinite(g).all():
            raise AssertionError(f"flash bwd {name}: non-finite {gname}")
        errs[gname] = dict(kernel_vs_fp32=rel_err(g, e), plain_vs_fp32=rel_err(p, e),
                           kernel_vs_plain=rel_err(g, p),
                           max_abs_err=(g.float() - p.float()).abs().max().item())
    del exact, f32
    ms = cuda_ms(lambda: flash_attention_backward(*args, causal=causal))
    split = kernel_split(lambda: flash_attention_backward(*args, causal=causal),
                         {"delta": "bwd_delta", "dkv": "flash_bwd_dkv", "dq": "flash_bwd_dq"})
    plain_ms = cuda_ms(lambda: flash_attention_backward_reference(*args, causal=causal), iters=3)
    torch.cuda.empty_cache()
    # the library's backward alone: autograd.grad over a retained graph, in
    # BHSD with repeated kv heads made outside the timing
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // kv, dim=2).transpose(1, 2).detach().requires_grad_()
              for x in (k, v))
    ot = sdpa(qt, kt, vt, is_causal=causal)
    dot = d_out.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    del ot, qt, kt, vt
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 10.0 * d * pairs  # five products of 2 * d operations per (query, key) pair
    # read q, k, v, out, d_out and lse once; write dq, dk, dv once
    nbytes = 2.0 * (3 * b * s * h * d + 2 * b * s * kv * d) + 4.0 * b * h * s \
        + 2.0 * (b * s * h * d + 2 * b * s * kv * d)
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(case=name, shape=[b, s, h, kv, d], causal=causal, errors=errs,
               deterministic=deterministic, tol=dict(noise=BWD_NOISE, cap=BWD_CAP),
               max_abs_err=max(e["max_abs_err"] for e in errs.values()),
               ms=ms, kernel_ms=split, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
               vs_library=ms / lib_ms)
    log("kernel_flash_bwd", **row)
    if not deterministic:
        raise AssertionError(f"flash bwd {name}: two calls gave different gradients")
    for gname, e in errs.items():
        if e["kernel_vs_fp32"] > BWD_NOISE * e["plain_vs_fp32"] or e["kernel_vs_plain"] > BWD_CAP:
            raise AssertionError(f"flash bwd {name}: {gname} beyond tolerance: {e}")
    return row


def phase_kernels_bwd():
    gen = torch.Generator(device="cuda").manual_seed(2)
    return [
        check_flash_bwd("gptj_causal_s2048", 1, 2048, 16, 16, 256, True, gen),
        check_flash_bwd("llama_causal_s2048", 1, 2048, 32, 32, 128, True, gen),
        check_flash_bwd("gqa_kv8_s1000", 1, 1000, 32, 8, 128, True, gen),
        check_flash_bwd("d64_s300", 2, 300, 4, 4, 64, True, gen),
        check_flash_bwd("full_s2048", 1, 2048, 32, 32, 128, False, gen),
        check_flash_bwd(VIT_FLASH_CASE, 64, 197, 16, 16, 64, False, gen),
    ]


def check_paged(name, contexts, h, kv, d, block_size, max_blocks, gen, dense=False):
    """``dense``: the dense cache's layout, one block of ``block_size``
    slots per sequence and table ``arange(B)``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from ray_tpu_torch.kernels.paged_attention import (
        gather_rows,
        paged_attention,
        paged_attention_reference,
    )

    dev = "cuda"
    b = len(contexts)
    if dense:
        num_blocks = b
        tables = torch.arange(b, dtype=torch.int32)[:, None]
    else:
        need = [-(-c // block_size) for c in contexts]
        num_blocks = 1 + sum(need)
        # shuffled, non-contiguous block ids; an inactive slot (context 0)
        # keeps an all-null table at position 0, as the engine pads it
        perm = torch.randperm(num_blocks - 1, generator=torch.Generator().manual_seed(7)) + 1
        tables = torch.zeros((b, max_blocks), dtype=torch.int32)
        off = 0
        for i, n in enumerate(need):
            tables[i, :n] = perm[off:off + n].to(torch.int32)
            off += n
    positions = torch.tensor([max(c - 1, 0) for c in contexts], dtype=torch.int32)
    tables, positions = tables.to(dev), positions.to(dev)
    pool_shape = (num_blocks * block_size, kv, d)
    kp = torch.randn(pool_shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(pool_shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    out = paged_attention(q, kp, vp, tables, positions, block_size)
    ref = paged_attention_reference(q, kp, vp, tables, positions, block_size)
    torch.cuda.synchronize()
    err = max_err(out, ref, f"paged {name}")
    ms = cuda_ms(lambda: paged_attention(q, kp, vp, tables, positions, block_size))
    # the kernel's own device time: a small case's ms measures the host
    kernel_ms = kernel_split(lambda: paged_attention(q, kp, vp, tables, positions, block_size),
                             {"paged": "paged_"})["paged"]
    plain_ms = cuda_ms(
        lambda: paged_attention_reference(q, kp, vp, tables, positions, block_size), iters=5)
    gk, gv = gather_rows(kp, tables, block_size), gather_rows(vp, tables, block_size)
    rows = torch.arange(gk.shape[1], device=dev)
    visible = (rows[None, :] <= positions[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    ks, vs = (x.repeat_interleave(h // kv, dim=2).transpose(1, 2) for x in (gk, gv))
    lib_ms = cuda_ms(lambda: sdpa(qs, ks, vs, attn_mask=visible))
    ctx = [max(c, 1) for c in contexts]
    flops = 4.0 * h * d * sum(ctx)
    nbytes = (2.0 * 2 * kv * d * sum(ctx) + 4.0 * sum(-(-c // block_size) for c in ctx)
              + 4.0 * b + 2.0 * 2 * b * h * d)
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(case=name, contexts=contexts, heads=[h, kv, d], block_size=block_size,
               max_abs_err=err, tol=TOL_RULE, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               gbps=nbytes / ms / 1e6, vs_library=ms / lib_ms)
    log("kernel_paged", **row)
    return row


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_main = check_flash("causal_s2048", 1, 2048, 32, 32, 128, True, gen)
    flash_rows = [
        flash_main,
        check_flash("full_s2048", 1, 2048, 32, 32, 128, False, gen),
        check_flash("causal_s1000", 1, 1000, 32, 32, 128, True, gen),
        check_flash("full_s1000", 1, 1000, 32, 32, 128, False, gen),
        check_flash("gqa_kv8_s1000", 1, 1000, 32, 8, 128, True, gen),
        check_flash("d64_s300", 2, 300, 4, 4, 64, True, gen),
        check_flash("d64_full_s300", 2, 300, 4, 2, 64, False, gen),
        check_flash("d256_s257", 1, 257, 4, 4, 256, True, gen),
        check_flash("d256_full_s130", 2, 130, 4, 2, 256, False, gen),
        check_flash("gptj_causal_s2048", 1, 2048, 16, 16, 256, True, gen),
        # phase_vit's attention: ViT-L/16 at B=64, 197 tokens, bidirectional
        check_flash(VIT_FLASH_CASE, 64, 197, 16, 16, 64, False, gen),
    ]
    # ragged contexts up to 4096 and one inactive slot (context 0)
    contexts = [4096, 1, 17, 1000, 2500, 0, 513, 3333]
    paged_main = check_paged("b8_ctx4096", contexts, 32, 32, 128, 16, 256, gen)
    paged_rows = [
        paged_main,
        # phase_decode_check's step: its prompts plus the decoded token
        check_paged("decode_b8", [n + 1 if n else 0 for n in DECODE_LENGTHS], 32, 32, 128, 16,
                    256, gen),
        check_paged("gqa_kv8", [300, 1, 777, 0], 32, 8, 128, 16, 64, gen),
        check_paged("d64", [100, 600, 0], 4, 2, 64, 16, 64, gen),
        check_paged("d256", [100, 600, 0], 4, 4, 256, 8, 128, gen),
        # phase_dense_generate's decode: a dense cache of 544 slots per sequence
        check_paged(DENSE_PAGED_CASE, DENSE_CONTEXTS, 32, 32, 128, 544, 1, gen, dense=True),
    ]
    return flash_rows, paged_rows


def phase_forward(params, cfg):
    import dataclasses

    from ray_tpu_torch.kernels.flash_attention import flash_attention
    from ray_tpu_torch.models.transformer import forward

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    before = flash_attention.launches
    flash_logits = forward(params, tokens, cfg).float()
    launches = flash_attention.launches - before
    plain_logits = forward(params, tokens, cfg, use_flash=False).float()
    params32 = {k: v.float() for k, v in params.items()}
    ref32 = forward(params32, tokens, dataclasses.replace(cfg, dtype=torch.float32))
    del params32
    torch.cuda.empty_cache()
    if launches != cfg.n_layers:
        raise AssertionError(f"forward launched flash {launches} times, want {cfg.n_layers}")
    if not torch.isfinite(flash_logits).all():
        raise AssertionError("forward: non-finite logits")
    diff = (flash_logits - plain_logits).abs()
    flash_dev = (flash_logits - ref32).abs().mean().item()
    plain_dev = (plain_logits - ref32).abs().mean().item()
    agree = (flash_logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
    row = dict(shape=list(flash_logits.shape), flash_launches=launches,
               max_abs_diff=diff.max().item(), mean_abs_diff=diff.mean().item(),
               flash_vs_fp32_mean=flash_dev, plain_vs_fp32_mean=plain_dev,
               argmax_agree=agree, logit_abs_max=plain_logits.abs().max().item(),
               tol=[FWD_MAX_ABS, FWD_MEAN_ABS, FWD_NOISE])
    log("forward_llama2_7b", **row)
    if row["max_abs_diff"] > FWD_MAX_ABS or row["mean_abs_diff"] > FWD_MEAN_ABS \
            or flash_dev > FWD_NOISE * plain_dev:
        raise AssertionError(f"forward: flash vs plain logits beyond tolerance: {row}")


def phase_decode_check(params, cfg, ecfg):
    """One teacher-forced decode step at the engine's shapes through the
    paged kernel against the plain path, and its time."""
    from ray_tpu_torch.models import generation as G

    gen = torch.Generator().manual_seed(3)
    b, mb, bs = ecfg.max_batch, ecfg.max_blocks_per_seq, ecfg.block_size
    lengths = DECODE_LENGTHS
    pool = G.init_paged_pool(cfg, 1 + sum(-(-n // bs) for n in lengths) + b, bs)
    prefill, decode, greedy = G.make_paged_fns(cfg, block_size=bs)
    _, plain_decode, _ = G.make_paged_fns(cfg, block_size=bs, use_kernels=False)
    tables = torch.zeros((b, mb), dtype=torch.int32)
    nxt = 1
    last = torch.zeros(b, dtype=torch.int32)
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        nblk = -(-(n + 1) // bs)  # room for the decoded token
        tables[i, :nblk] = torch.arange(nxt, nxt + nblk, dtype=torch.int32)
        nxt += nblk
        prompt = torch.randint(1, cfg.vocab_size, (1, n), generator=gen, dtype=torch.int32)
        logits, pool = prefill(params, prompt.cuda(), tables[i:i + 1].cuda(), pool, n)
        last[i] = int(torch.argmax(logits[0]))
    active = torch.tensor([n > 0 for n in lengths]).cuda()
    positions = torch.tensor(lengths, dtype=torch.int32).cuda()
    args = (last.cuda(), positions, tables.cuda())
    kernel_logits, pool = decode(params, *args, pool, active)
    plain_logits, pool = plain_decode(params, *args, pool, active)
    torch.cuda.synchronize()
    rows = [i for i, n in enumerate(lengths) if n > 0]
    if not torch.isfinite(kernel_logits).all():
        raise AssertionError("decode: non-finite logits (an inactive slot leaked?)")
    diff = (kernel_logits[rows] - plain_logits[rows]).abs()
    agree = bool((kernel_logits[rows].argmax(-1) == plain_logits[rows].argmax(-1)).all())
    step_ms = cuda_ms(lambda: greedy(params, *args, pool, active), iters=10)
    step_profile = device_profile(lambda: greedy(params, *args, pool, active), steps=3)
    prompt = torch.randint(1, cfg.vocab_size, (1, 2048), dtype=torch.int32, device="cuda")
    prefill_profile = device_profile(lambda: prefill(params, prompt, tables[:1].cuda(), pool, 1500),
                                     steps=2)
    row = dict(batch=b, lengths=lengths, max_abs_diff=diff.max().item(),
               mean_abs_diff=diff.mean().item(), argmax_agree=agree,
               tol=[FWD_MAX_ABS, FWD_MEAN_ABS], decode_step_ms=step_ms,
               decode_step_profile=step_profile, prefill_2048_profile=prefill_profile)
    log("decode_step_check", **row)
    if row["max_abs_diff"] > FWD_MAX_ABS or row["mean_abs_diff"] > FWD_MEAN_ABS:
        raise AssertionError(f"decode: kernel vs plain logits beyond tolerance: {row}")
    return step_ms


def phase_serve(params, cfg, ecfg):
    """The main path: an ``LLMServer`` replica (the deployment class, its
    engine given the weights by ``params_loader``) serving 12 greedy
    requests and one sampled, staggered; then one request in the proxy's
    dict convention, which must repeat a greedy stream's first tokens."""
    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.kernels.paged_attention import paged_attention
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    gen = torch.Generator().manual_seed(5)
    lengths = torch.linspace(16, 1500, 12).round().int().tolist()
    lengths = [lengths[i] for i in torch.randperm(12, generator=gen).tolist()]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist() for n in lengths]
    sampled_prompt = torch.randint(1, cfg.vocab_size, (200,), generator=gen).tolist()
    max_new, unary_new = 32, 8
    server = LLMServer(cfg, ecfg, deployment="llama2-7b", params_loader=lambda _cfg: params,
                       device="cuda")
    engine = server.engine
    try:
        server.check_health()
        for kern in (flash_attention, paged_attention, flash_attention_backward):
            kern.launches = 0
        t0 = time.perf_counter()
        streams = []
        for i, p in enumerate(prompts):
            streams.append(engine.submit(p, max_new_tokens=max_new))
            if i == 5:
                sampled = engine.submit(sampled_prompt, max_new_tokens=max_new,
                                        temperature=0.8, top_k=40, seed=11)
                streams.append(sampled)
            time.sleep(0.02 * (i % 3))
        outs = [s.tokens() for s in streams]
        greedy_outs = [o for s, o in zip(streams, outs) if s is not sampled]
        wall = time.perf_counter() - t0
        unary = server({"prompt": prompts[0], "max_new_tokens": unary_new})
        counts = {kern.__name__: kern.launches
                  for kern in (flash_attention, paged_attention, flash_attention_backward)}
        stats = server.kv_stats()
    finally:
        engine.shutdown()
    if any(len(o) != max_new for o in outs):
        raise AssertionError(f"streams ended short: {[len(o) for o in outs]}")
    if unary != greedy_outs[0][:unary_new]:
        raise AssertionError(f"dict-convention call {unary} is not the stream's "
                             f"{greedy_outs[0][:unary_new]}")
    if stats["blocks_free"] != stats["blocks_total"] or stats["blocks_committed"] != 0:
        raise AssertionError(f"blocks not freed after serving: {stats}")
    n_req = len(streams) + 1
    if counts["flash_attention"] != n_req * cfg.n_layers:
        raise AssertionError(f"flash launches {counts['flash_attention']} != one per layer "
                             f"of each of {n_req} prefills")
    if counts["flash_attention_backward"]:
        raise AssertionError(f"serving launched the backward kernel: {counts}")
    steps = counts["paged_attention"] / cfg.n_layers
    if steps != int(steps) or steps < max_new - 1:
        raise AssertionError(f"paged launches {counts['paged_attention']} are not one per "
                             f"layer of at least {max_new - 1} decode steps")
    ttft = sorted(s.ttft_s * 1e3 for s in streams)
    n_tok = sum(len(o) for o in outs)
    row = dict(requests=n_req, prompt_lengths=lengths + [len(sampled_prompt)],
               tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
               ttft_p50_ms=ttft[len(ttft) // 2],
               ttft_p99_ms=ttft[min(len(ttft) - 1, math.ceil(0.99 * len(ttft)) - 1)],
               decode_steps=int(steps), launches=counts, unary_tokens=unary)
    log("serve", **row)
    return prompts, greedy_outs, counts, row


def phase_first_tokens(params, cfg, prompts, outs):
    """Each greedy request's first token against forward's argmax."""
    from ray_tpu_torch.models.transformer import forward

    worst_gap = 0.0
    mismatches = 0
    for p, out in zip(prompts, outs):
        logits = forward(params, torch.tensor([p], device="cuda"), cfg)[0, -1].float()
        top2 = torch.topk(logits, 2).values
        if int(torch.argmax(logits)) != out[0]:
            mismatches += 1
            gap = (top2[0] - logits[out[0]]).item()
            worst_gap = max(worst_gap, gap)
            if gap > TOP2_GAP:
                raise AssertionError(f"first token {out[0]} is not forward's argmax "
                                     f"and trails it by {gap} > {TOP2_GAP}")
    log("first_tokens", checked=len(prompts), mismatches_within_tol=mismatches,
        worst_gap=worst_gap, tol=TOP2_GAP)


def _logit_rule(what, got, want) -> dict:
    """phase_decode_check's rule for logits through the kernels against the
    plain path's: max and mean absolute difference, and argmax agreement
    wherever the plain path's top two logits lie further apart than
    TOP2_GAP (a closer pair is a near-tie that any bf16 rounding flips)."""
    diff = (got - want).abs()
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TOP2_GAP
    agree = got.argmax(-1) == want.argmax(-1)
    row = dict(max_abs_diff=diff.max().item(), mean_abs_diff=diff.mean().item(),
               argmax_agree=agree.float().mean().item(),
               argmax_disagree_decided=int((~agree & decided).sum().item()))
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    if row["max_abs_diff"] > FWD_MAX_ABS or row["mean_abs_diff"] > FWD_MEAN_ABS \
            or row["argmax_disagree_decided"]:
        raise AssertionError(f"{what}: kernel vs plain logits beyond tolerance: {row}")
    return row


def phase_dense_generate(params, cfg, serve_row):
    """The dense-cache path at full width and depth: ``generate`` on 8
    seeded 512-token prompts, 32 new tokens, greedy. Prefill runs the flash
    forward once per layer, each of the 31 decode steps the paged kernel
    once per layer over the dense cache (one block of 544 slots per
    sequence)."""
    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.kernels.paged_attention import paged_attention
    from ray_tpu_torch.models import generation as G

    kernels = (flash_attention, paged_attention, flash_attention_backward)
    b, s, new = 8, 512, 32
    max_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(6)
    prompts = torch.randint(1, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    try:
        G.generate(params, torch.ones((1, cfg.max_seq_len), dtype=torch.int64), cfg,
                   max_new_tokens=1)
    except ValueError as e:
        past_max = str(e)
    else:
        raise AssertionError("generate did not raise past max_seq_len")

    fns = G.make_decode_fns(cfg, max_len)
    walls = []
    for run in range(2):
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = G.generate(params, prompts, cfg, max_new_tokens=new, fns=fns)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            counts = {kern.__name__: kern.launches for kern in kernels}
            first = toks
    want = {"flash_attention": cfg.n_layers, "paged_attention": cfg.n_layers * (new - 1),
            "flash_attention_backward": 0}
    if counts != want:
        raise AssertionError(f"dense generate launches {counts}, want {want}")
    if toks.shape != (b, new) or not torch.equal(toks, first):
        raise AssertionError("dense generate: wrong shape, or two runs gave other tokens")

    # the first decode step through the kernels and through the plain path,
    # from the same cache (the step writes its own row before it attends)
    prefill, decode = fns
    plain_prefill, plain_decode = G.make_decode_fns(cfg, max_len, use_kernels=False)
    cache = G.init_kv_cache(cfg, b, max_len, device="cuda")
    logits, after = prefill(params, prompts, cache)
    plain_logits, _ = plain_prefill(params, prompts,
                                    G.init_kv_cache(cfg, b, max_len, device="cuda"))
    tok = logits.argmax(-1)[:, None]
    step_logits, _ = decode(params, tok, after)
    plain_step, _ = plain_decode(params, tok, after)
    torch.cuda.synchronize()
    prefill_rule = _logit_rule("dense prefill", logits, plain_logits)
    decode_rule = _logit_rule("dense decode", step_logits, plain_step)
    del plain_logits, plain_step
    torch.cuda.empty_cache()
    prefill_ms = cuda_ms(lambda: prefill(params, prompts, cache), iters=3, warmup=1)
    step_ms = cuda_ms(lambda: decode(params, tok, after), iters=10)
    step_profile = device_profile(lambda: decode(params, tok, after), steps=3)
    prefill_profile = device_profile(lambda: prefill(params, prompts, cache), steps=1)
    tokens_per_s = b * new / walls[1]
    row = dict(batch=b, prompt=s, new_tokens=new, cache_gib=2 * cache["k"].numel() * 2 / 2**30,
               launches=counts, prefill_vs_plain=prefill_rule, decode_vs_plain=decode_rule,
               tol=[FWD_MAX_ABS, FWD_MEAN_ABS, TOP2_GAP], past_max_seq_len=past_max,
               generate_wall_s=walls, static_tokens_per_s=tokens_per_s,
               engine_tokens_per_s=serve_row["tokens_per_s"], prefill_ms=prefill_ms,
               decode_step_ms=step_ms, decode_step_profile=step_profile,
               prefill_profile=prefill_profile)
    log("dense_generate", **row)
    return counts


# Gradients through the whole model, flash against plain: both bf16 paths
# differ from an fp32 run of the same weights by bf16 roundings that the
# layers carry along; the flash path's only extra roundings are the
# kernels' P and dS, which the plain path makes too in its bf16 products
# (a CPU emulation measured the two equally far from fp32). Per parameter,
# the flash gradient may stray from fp32 no further than TRAIN_NOISE times
# the plain one does (relative Frobenius norm).
TRAIN_NOISE = 1.5


def _value_and_grads(params, tokens, targets, cfg, use_flash):
    from ray_tpu_torch.models.transformer import loss_fn

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, tokens, targets, cfg, use_flash=use_flash)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in leaves.items() if v.grad is not None}


# ViT-L/16 logits through the flash kernel against the plain path, both
# bf16: the flash logits may stray from an fp32 run of the same weights no
# further than VIT_NOISE times the plain logits do (mean absolute
# deviation, PR 2's rule for the LM forward). Gradients: per parameter,
# the flash path's relative Frobenius distance from the fp32 gradient at
# most VIT_GRAD_NOISE times the plain path's (PR 3's rule for the kernel).
VIT_NOISE, VIT_GRAD_NOISE = 1.2, 2.0


def phase_vit(smi):
    """ViT-L/16 (304 M parameters) at full width and depth, bf16, 224x224x3
    images from a seeded generator: the forward at B=256 (24 flash
    launches) against the plain path and fp32; ``loss_fn``'s gradient at
    B=64 (24 flash-backward launches) against the plain path and fp32; then
    3 SGD steps at lr 1e-2 on one batch."""
    import dataclasses

    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.kernels.paged_attention import paged_attention
    from ray_tpu_torch.models import vit

    kernels = (flash_attention, flash_attention_backward, paged_attention)
    cfg = vit.VIT_L_16
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = vit.init_params(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
    n_params = sum(p.numel() for p in params.values())
    gen = torch.Generator(device="cuda").manual_seed(8)
    images = torch.randn((256, cfg.image_size, cfg.image_size, cfg.num_channels), generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (256,), generator=gen, device="cuda")

    with torch.inference_mode():
        for kern in kernels:
            kern.launches = 0
        flash_logits = vit.forward(cfg, params, images)
        fwd_launches = {kern.__name__: kern.launches for kern in kernels}
        plain_logits = vit.forward(cfg, params, images, use_flash=False)
        ref32 = vit.forward(cfg32, {k: v.float() for k, v in params.items()}, images)
        torch.cuda.empty_cache()
        fwd_ms = cuda_ms(lambda: vit.forward(cfg, params, images), iters=5, warmup=1)
        fwd_profile = device_profile(lambda: vit.forward(cfg, params, images), steps=1)
    if fwd_launches != {"flash_attention": cfg.n_layers, "flash_attention_backward": 0,
                        "paged_attention": 0}:
        raise AssertionError(f"vit forward launches {fwd_launches}")
    if flash_logits.shape != (256, cfg.num_classes) or not torch.isfinite(flash_logits).all():
        raise AssertionError("vit forward: wrong shape or non-finite logits")
    flash_dev = (flash_logits - ref32).abs().mean().item()
    plain_dev = (plain_logits - ref32).abs().mean().item()
    diff = (flash_logits - plain_logits).abs()
    fwd = dict(batch=256, launches=fwd_launches, max_abs_diff=diff.max().item(),
               mean_abs_diff=diff.mean().item(), flash_vs_fp32_mean=flash_dev,
               plain_vs_fp32_mean=plain_dev,
               argmax_agree=(flash_logits.argmax(-1) == plain_logits.argmax(-1)).float()
               .mean().item(), logit_abs_max=plain_logits.abs().max().item(), tol=VIT_NOISE,
               ms=fwd_ms, images_per_s=256 / (fwd_ms / 1e3), profile=fwd_profile)
    log("vit_forward", **fwd)
    if flash_dev > VIT_NOISE * plain_dev:
        raise AssertionError(f"vit forward: flash logits beyond {VIT_NOISE}x plain from fp32")
    del flash_logits, plain_logits, ref32

    imgs, lbls = images[:64], labels[:64]

    def value_and_grads(p, c, use_flash):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss, _ = vit.loss_fn(c, leaves, imgs, lbls, use_flash=use_flash)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in leaves.items()}

    for kern in kernels:
        kern.launches = 0
    loss_flash, g_flash = value_and_grads(params, cfg, True)
    bwd_launches = {kern.__name__: kern.launches for kern in kernels}
    loss_plain, g_plain = value_and_grads(params, cfg, False)
    loss_32, g_32 = value_and_grads({k: v.float() for k, v in params.items()}, cfg32, True)
    errs = {k: {"flash_vs_fp32": rel_err(g_flash[k], g_32[k]),
                "plain_vs_fp32": rel_err(g_plain[k], g_32[k]),
                "flash_vs_plain": rel_err(g_flash[k], g_plain[k])} for k in sorted(g_32)}
    finite = all(torch.isfinite(g).all().item() for g in g_flash.values())
    del g_flash, g_plain, g_32
    torch.cuda.empty_cache()
    grads = dict(batch=64, launches=bwd_launches, loss_flash=loss_flash, loss_plain=loss_plain,
                 loss_fp32=loss_32, grad_errors=errs, tol=VIT_GRAD_NOISE)
    log("vit_grads", **grads)
    if bwd_launches != {"flash_attention": cfg.n_layers, "flash_attention_backward": cfg.n_layers,
                        "paged_attention": 0}:
        raise AssertionError(f"vit gradient launches {bwd_launches}")
    if not finite or not all(math.isfinite(x) for x in (loss_flash, loss_plain, loss_32)):
        raise AssertionError("vit gradients: non-finite loss or gradient")
    bad = {k: e for k, e in errs.items()
           if e["flash_vs_fp32"] > VIT_GRAD_NOISE * e["plain_vs_fp32"]}
    if bad:
        raise AssertionError(f"vit gradients beyond {VIT_GRAD_NOISE}x plain from fp32: {bad}")

    lr = 1e-2
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}

    def sgd_step():
        for v in leaves.values():
            v.grad = None
        loss, _ = vit.loss_fn(cfg, leaves, imgs, lbls)
        loss.backward()
        with torch.no_grad():
            for v in leaves.values():
                v.sub_(v.grad, alpha=lr)
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    losses, step_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        start.record()
        loss = sgd_step()
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    step_launches = {kern.__name__: kern.launches for kern in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    profile = device_profile(sgd_step, steps=1)
    row = dict(config="VIT_L_16", params=n_params, batch=64, lr=lr, losses=losses,
               step_ms=step_ms, images_per_s=64 / (step_ms[-1] / 1e3), peak_gib=peak_gib,
               card=smi, launches=step_launches, profiled_step=profile)
    log("vit_train", **row)
    if step_launches != {"flash_attention": 3 * cfg.n_layers,
                         "flash_attention_backward": 3 * cfg.n_layers, "paged_attention": 0}:
        raise AssertionError(f"vit steps launched {step_launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"vit: loss did not fall on one fixed batch: {losses}")
    return {"forward": fwd_launches, "gradient": bwd_launches, "sgd_steps": step_launches,
            "forward_images_per_s": fwd["images_per_s"]}


def synthetic_mnist():
    """``test_mnist_mlp_learns_synthetic``'s data: class = argmax of 10
    fixed projections."""
    import numpy as np

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(784, 10))
    xs = rng.normal(size=(512, 784)).astype(np.float32)
    ys = np.argmax(xs @ w_true, axis=1)
    return torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()


def phase_small_models():
    """MNIST MLP training (30 Adam steps) and a checkpoint round trip of its
    state; the CNN's logits; the MoE MLP on the card against the CPU."""
    import tempfile

    from ray_tpu_torch.models import mnist, moe
    from ray_tpu_torch.train import load_pytree, save_pytree

    xs, ys = synthetic_mnist()

    def mlp_state(seed):
        params = mnist.init_mlp(torch.Generator(device="cuda").manual_seed(seed), hidden=(64,),
                                device="cuda")
        leaves = [t.requires_grad_() for layer in params["layers"] for t in layer.values()]
        return {"params": params, "opt": torch.optim.Adam(leaves, lr=1e-3)}

    def step(state):
        state["opt"].zero_grad()
        loss = mnist.cross_entropy_loss(mnist.apply_mlp(state["params"], xs), ys)
        loss.backward()
        state["opt"].step()
        return loss.detach()

    state = mlp_state(0)
    losses = [step(state).item() for _ in range(30)]
    with torch.no_grad():
        acc = mnist.accuracy(mnist.apply_mlp(state["params"], xs), ys).item()
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(state, tmp)
        restored = load_pytree(tmp, target=mlp_state(1))
    want, got = step(state), step(restored)
    round_trip = bool(torch.equal(want, got))

    cnn = mnist.init_cnn(torch.Generator(device="cuda").manual_seed(2), device="cuda")
    x = torch.randn((2, 28, 28, 1), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    with torch.no_grad():
        cnn_logits = mnist.apply_cnn(cnn, x)
        cnn_cpu = mnist.apply_cnn(
            {k: v.cpu() if torch.is_tensor(v) else {kk: vv.cpu() for kk, vv in v.items()}
             for k, v in cnn.items()}, x.cpu())
    cnn_err = (cnn_logits.cpu() - cnn_cpu).abs().max().item()

    moe_rows = {}
    for name, cfg, shape in (
        ("default", moe.MoEConfig(), (4, 64, 128)),
        ("capacity_0.25", moe.MoEConfig(d_model=16, d_ff=32, num_experts=2, top_k=1,
                                        capacity_factor=0.25), (1, 32, 16)),
    ):
        p = moe.init_moe_params(torch.Generator(device="cuda").manual_seed(4), cfg, device="cuda")
        xm = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(5),
                         device="cuda")
        with torch.no_grad():
            y, aux = moe.moe_mlp(p, xm, cfg)
            y_cpu, aux_cpu = moe.moe_mlp({k: v.cpu() for k, v in p.items()}, xm.cpu(), cfg)
        moe_rows[name] = dict(shape=list(shape), y_err=(y.cpu() - y_cpu).abs().max().item(),
                              aux_err=abs(aux.item() - aux_cpu.item()),
                              dropped_rows=int((y.abs().sum(-1) == 0).sum().item()))
    row = dict(mlp_losses=[losses[0], losses[-1]], mlp_accuracy=acc,
               checkpoint_next_loss=[want.item(), got.item()], checkpoint_bitwise=round_trip,
               cnn_logits_shape=list(cnn_logits.shape), cnn_vs_cpu_max_abs=cnn_err, moe=moe_rows,
               tol=dict(mlp_loss_ratio=0.6, mlp_accuracy=0.5, vs_cpu_atol=1e-4))
    log("small_models", **row)
    if not losses[-1] < 0.6 * losses[0] or not acc > 0.5:
        raise AssertionError(f"mnist mlp did not learn: {losses[0]} -> {losses[-1]}, acc {acc}")
    if not round_trip:
        raise AssertionError(f"checkpoint round trip: next loss {got.item()} != {want.item()}")
    if tuple(cnn_logits.shape) != (2, 10) or not cnn_err <= 1e-4:
        raise AssertionError(f"cnn logits {tuple(cnn_logits.shape)}, {cnn_err} from the CPU")
    bad = {k: r for k, r in moe_rows.items() if not (r["y_err"] <= 1e-4 and r["aux_err"] <= 1e-4)}
    if bad:
        raise AssertionError(f"moe on the card vs the CPU beyond 1e-4: {bad}")


# -- RL (ray_tpu_torch.rl): no kernel of the port; fp32 learners ---------

# Every learner update on the card against the same update on the CPU,
# from the same parameters and batch: losses, metrics, every gradient and
# every parameter (targets and log-alpha included) after the update.
RL_ATOL, RL_RTOL = 1e-5, 1e-5
# PPO on CartPole at the reference's configuration (tests/test_rl.py's bar)
RL_PPO_TARGET, RL_PPO_ITERS, RL_PPO_STEPS = 150.0, 49, 101_000


class _ArrayDataset:
    """The offline dataset contract: ``materialize()`` and
    ``iter_batches(batch_size=, drop_last=)`` over columns of rows."""

    def __init__(self, columns):
        self.columns = columns

    def materialize(self):
        return self

    def iter_batches(self, batch_size, drop_last=False):
        n = len(self.columns["obs"])
        for s in range(0, n - n % batch_size if drop_last else n, batch_size):
            yield {k: v[s:s + batch_size] for k, v in self.columns.items()}


def _rl_batches():
    """Fixed batches at the main paths' shapes, from numpy seeds."""
    import numpy as np

    rng = np.random.default_rng(0)

    def rows(n):
        return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n).astype(np.int32)}

    ppo = {**rows(512), "logp_old": np.full(512, np.log(0.5), np.float32),
           "advantages": rng.normal(size=512).astype(np.float32),
           "returns": rng.normal(scale=5.0, size=512).astype(np.float32)}
    T, N = 128, 16  # a rollout of 16 envs x 128 steps, the last lane a masked pad
    vtrace = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
              "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
              "logp": (np.log(0.5) + rng.normal(scale=0.3, size=(T, N))).astype(np.float32),
              "rewards": np.ones((T, N), np.float32),
              "dones": (rng.random((T, N)) < 0.05).astype(np.float32),
              "last_values": rng.normal(size=N).astype(np.float32),
              "mask": np.r_[np.ones(N - 1), 0.0].astype(np.float32)}
    for k, v in vtrace.items():
        if k in ("mask", "last_values"):
            v[-1] = 0.0
        else:
            v[:, -1] = 0

    def replay(n):
        return {**rows(n), "rewards": np.ones(n, np.float32),
                "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
                "dones": (rng.random(n) < 0.1).astype(np.float32)}

    offline = {**replay(4096), "returns": rng.uniform(0, 60, 4096).astype(np.float32)}
    ma = {**rows(256), "logp_old": np.full(256, np.log(0.5), np.float32),
          "advantages": rng.normal(size=256).astype(np.float32),
          "returns": rng.normal(scale=5.0, size=256).astype(np.float32)}
    return {"ppo": ppo, "vtrace": vtrace, "dqn": replay(64), "sac": replay(128),
            "offline": offline, "ma": ma}


def _rl_configs(dataset):
    from ray_tpu_torch import rl

    ma = (rl.MultiAgentPPOConfig()
          .environment(lambda seed=None: rl.MultiAgentCartPole(num_agents=2, seed=seed))
          .multi_agent(policies=["p0", "p1"],
                       policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1"))
    return {"ppo": rl.PPOConfig(), "impala": rl.IMPALAConfig(), "appo": rl.APPOConfig(),
            "dqn_double_q": rl.DQNConfig(), "dqn_max_q": rl.DQNConfig().training(double_q=False),
            "sac": rl.SACConfig(), "bc": rl.BCConfig().offline_data(dataset),
            "marwil": rl.MARWILConfig().offline_data(dataset),
            "cql": rl.CQLConfig().offline_data(dataset), "multi_agent_ppo": ma}


def _rl_update(name, algo, batches):
    """One learner update of ``algo`` -> its metrics."""
    if name in ("ppo", "bc", "marwil"):
        b = batches["ppo"] if name == "ppo" else algo._next_batch()
        return algo._update(algo.params, algo.opt_state, algo._to_device(b))[2]
    if name in ("impala", "appo"):
        return algo._update(algo.params, algo.opt_state, algo._to_device(batches["vtrace"]))[2]
    if name.startswith("dqn"):
        return algo._update(algo.params, algo.target_params, algo.opt_state,
                            algo._to_device(batches["dqn"]))[2]
    if name == "cql":
        return algo._update(algo.params, algo.target_params, algo.opt_state,
                            algo._to_device(algo._next_batch()))[3]
    if name == "sac":
        return algo._update(algo._to_device(batches["sac"]))
    loss = algo._update(algo.params["p0"], algo.opt_states["p0"],
                        algo._to_device(batches["ma"]))[2]
    return {"loss": loss}


def _rl_trees(name, algo):
    """Every tree an update changes, as numpy: parameters, targets,
    log-alpha, Adam moments."""
    from ray_tpu_torch.rl.optim import to_numpy

    state = algo.get_state()
    trees = {k: v for k, v in state.items() if k in ("params", "target_params", "actor", "q1",
                                                       "q2", "log_alpha")}
    if name == "sac":
        trees["q1_target"] = to_numpy(algo.q1_target)
        trees["q2_target"] = to_numpy(algo.q2_target)
    if "opt_state" in state:
        trees["adam_mu"], trees["adam_nu"] = state["opt_state"]["mu"], state["opt_state"]["nu"]
    return trees


def _record_grads(algo):
    """Keep a CPU copy of the gradients each optimizer of ``algo`` steps
    with."""
    seen = []
    for attr in ("optimizer", "q_opt", "actor_opt", "alpha_opt"):
        opt = getattr(algo, attr, None)
        if opt is None:
            continue

        def step(params, grads, state, _step=opt.step):
            grads = list(grads)
            seen.append([g.detach().cpu().clone() for g in grads])
            return _step(params, grads, state)

        opt.step = step
    return seen


def _rl_max_diff(got, want) -> float:
    import numpy as np

    from ray_tpu_torch.rl.models import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"rl: shapes {a.shape} / {b.shape} or non-finite values")
        excess = np.abs(a - b) - (RL_ATOL + RL_RTOL * np.abs(b))
        if excess.max(initial=0.0) > 0:
            raise AssertionError(f"rl: card vs CPU {np.abs(a - b).max()} beyond "
                                 f"{RL_ATOL} + {RL_RTOL} * |cpu|")
        worst = max(worst, float(np.abs(a - b).max(initial=0.0)))
    return worst


def _rl_update_checks(dataset, batches) -> dict:
    from ray_tpu_torch.rl.models import tree_leaves

    rows = {}
    for name, cfg in _rl_configs(dataset).items():
        cpu_algo = cfg.build(device="cpu")
        card_algo = cfg.build(device="cuda")
        card_algo.set_state(cpu_algo.get_state())
        # target networks apart from the online ones (halved, Q head
        # negated), so the target terms, double-Q's argmax and the Polyak
        # steps show
        for a in (cpu_algo, card_algo):
            for attr in ("target_params", "q1_target", "q2_target"):
                if hasattr(a, attr):
                    for t in tree_leaves(getattr(a, attr)):
                        t.mul_(0.5)
                    getattr(a, attr)["pi"]["w"].neg_()
        grads = [_record_grads(a) for a in (cpu_algo, card_algo)]
        metrics = [_rl_update(name, a, batches) for a in (cpu_algo, card_algo)]
        torch.cuda.synchronize()
        m_cpu = {k: float(v) for k, v in metrics[0].items()}
        m_card = {k: float(v) for k, v in metrics[1].items()}
        trees = [_rl_trees(name, a) for a in (cpu_algo, card_algo)]
        if sorted(m_cpu) != sorted(m_card) or len(grads[0]) != len(grads[1]) or not grads[0]:
            raise AssertionError(f"rl {name}: metrics {sorted(m_card)} / grads "
                                 f"{len(grads[1])} against the CPU's")
        rows[name] = {
            "metrics_card": m_card,
            "metrics_max_abs_err": _rl_max_diff(m_card, m_cpu),
            "grads_max_abs_err": _rl_max_diff(grads[1], grads[0]),
            "trees_after_max_abs_err": {k: _rl_max_diff(trees[1][k], trees[0][k])
                                        for k in sorted(trees[0])},
        }
    return rows


def _rl_ppo_learns(smi) -> None:
    from ray_tpu_torch import rl

    cfg = (rl.PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                        rollout_fragment_length=128)
           .debugging(seed=0))
    algo = cfg.build(device="cuda")
    sample = algo.runners.sample
    sample_s = []

    def timed_sample(params):
        t0 = time.perf_counter()
        out = sample(params)
        sample_s.append(time.perf_counter() - t0)
        return out

    update = algo._update
    update_s = []

    def timed_update(*args):
        t0 = time.perf_counter()
        out = update(*args)
        update_s.append(time.perf_counter() - t0)
        return out

    algo.runners.sample, algo._update = timed_sample, timed_update
    best, step_s, iters = 0.0, [], 0
    for iters in range(1, RL_PPO_ITERS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = algo.train()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        best = max(best, result["episode_return_mean"])
        if best >= RL_PPO_TARGET:
            break
    steps = result["num_env_steps_sampled_lifetime"]
    algo.runners.sample, algo._update = sample, update
    profile = device_profile(algo.train, steps=1)
    per_step = 16 * 128
    mean_ms = 1e3 * sum(step_s) / len(step_s)
    row = dict(config="PPOConfig(), 16 envs x 128 steps, hidden (64, 64), 8 epochs, "
                      "minibatch 512, seed 0", card=smi, iterations=iters, best_return=best,
               env_steps=steps, target=[RL_PPO_TARGET, RL_PPO_ITERS, RL_PPO_STEPS],
               training_step_ms=mean_ms, training_step_ms_first=1e3 * step_s[0],
               training_step_ms_median=1e3 * sorted(step_s)[len(step_s) // 2],
               sample_ms=1e3 * sum(sample_s) / len(sample_s),
               learn_ms=mean_ms - 1e3 * sum(sample_s) / len(sample_s),
               updates_ms=1e3 * sum(update_s) / len(step_s),
               update_calls_per_step=len(update_s) / len(step_s),
               env_steps_per_s=per_step / (mean_ms / 1e3),
               profiled_step=profile,
               final={k: result[k] for k in ("total_loss", "policy_loss", "vf_loss", "entropy")})
    log("rl_ppo_cartpole", **row)
    if best < RL_PPO_TARGET or steps > RL_PPO_STEPS:
        raise AssertionError(f"rl: PPO reached {best} (target {RL_PPO_TARGET}) in {iters} "
                             f"iterations, {steps} env steps")
    return row


def _rl_two_steps(dataset) -> dict:
    out = {}
    for name, cfg in _rl_configs(dataset).items():
        if name in ("ppo", "dqn_max_q"):
            continue
        algo = cfg.build(device="cuda")
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        last = results[-1]
        numbers = {k: v for k, v in last.items() if isinstance(v, float)}
        out[name] = {"seconds": wall, "last": numbers}
        if not all(math.isfinite(v) for v in numbers.values()):
            raise AssertionError(f"rl {name}: non-finite metrics {numbers}")
        if name in ("dqn_double_q", "sac") and not any(
                k in last for k in ("td_loss", "q1_loss")):
            raise AssertionError(f"rl {name}: no update in two steps (learning_starts)")
    return out


def phase_rl(smi) -> dict:
    """The RL library: every learner update on the card against the CPU,
    PPO learning CartPole at the reference's configuration, and two
    training steps of each other algorithm."""
    batches = _rl_batches()
    dataset = _ArrayDataset(batches["offline"])
    t0 = time.perf_counter()
    updates = _rl_update_checks(dataset, batches)
    log("rl_updates", card=smi, tol=f"|card - cpu| <= {RL_ATOL} + {RL_RTOL} * |cpu|",
        seconds=time.perf_counter() - t0, cases=updates)
    ppo_row = _rl_ppo_learns(smi)
    t0 = time.perf_counter()
    two = _rl_two_steps(dataset)
    log("rl_two_steps", seconds=time.perf_counter() - t0, algorithms=two)
    return ppo_row


def phase_train_check():
    """Full-width GPT-J at 4 layers (bench.py's cut), B=1, S=2048."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.models.transformer import GPTJ_6B, init_params

    cfg = dataclasses.replace(GPTJ_6B, n_layers=4)
    params = init_params(torch.Generator(device="cuda").manual_seed(3), cfg, device="cuda")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size - 1, (1, 2048), dtype=np.int64)
    tok = torch.from_numpy(tokens).cuda()
    tgt = torch.roll(tok, -1, 1)
    before = (flash_attention.launches, flash_attention_backward.launches)
    loss_flash, g_flash = _value_and_grads(params, tok, tgt, cfg, True)
    launches = [flash_attention.launches - before[0], flash_attention_backward.launches - before[1]]
    loss_plain, g_plain = _value_and_grads(params, tok, tgt, cfg, False)
    params32 = {k: v.float() for k, v in params.items()}
    del params
    loss_32, g_32 = _value_and_grads(params32, tok, tgt,
                                     dataclasses.replace(cfg, dtype=torch.float32), True)
    del params32
    errs = {k: {"flash_vs_fp32": rel_err(g_flash[k], g_32[k]),
                "plain_vs_fp32": rel_err(g_plain[k], g_32[k]),
                "flash_vs_plain": rel_err(g_flash[k], g_plain[k])} for k in sorted(g_32)}
    finite = all(torch.isfinite(g).all().item() for g in g_flash.values())
    del g_flash, g_plain, g_32
    torch.cuda.empty_cache()
    row = dict(config="GPTJ_6B, n_layers=4", tokens=[1, 2048], remat=cfg.remat,
               loss_flash=loss_flash, loss_plain=loss_plain, loss_fp32=loss_32,
               flash_launches=launches, grad_errors=errs, tol=TRAIN_NOISE)
    log("train_check", **row)
    if launches != [2 * cfg.n_layers, cfg.n_layers]:
        raise AssertionError(f"train_check: flash launches fwd/bwd {launches}, want "
                             f"{[2 * cfg.n_layers, cfg.n_layers]} (remat recomputes the forward)")
    if not finite or not all(math.isfinite(x) for x in (loss_flash, loss_plain, loss_32)):
        raise AssertionError("train_check: non-finite loss or gradient")
    bad = {k: e for k, e in errs.items() if e["flash_vs_fp32"] > TRAIN_NOISE * e["plain_vs_fp32"]}
    if bad:
        raise AssertionError(f"train_check: flash gradients beyond {TRAIN_NOISE}x plain: {bad}")


def phase_train(smi, steps: int = 5):
    """The training path: build_lm_train_step(GPTJ_6B) at full width and
    depth, AdamW, `steps` steps on one fixed batch, then one more under
    the profiler."""
    import numpy as np

    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.kernels.paged_attention import paged_attention
    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    cfg = GPTJ_6B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = build_lm_train_step(cfg, learning_rate=1e-4)
    state = bundle.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch, seq = 1, 2048
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size - 1, (batch, seq), dtype=np.int32)
    tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))

    kernels = (flash_attention, flash_attention_backward, paged_attention)
    for kern in kernels:
        kern.launches = 0
    losses, norms, step_ms, per_step = [], [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(steps):
        before = [kern.launches for kern in kernels]
        start.record()
        state, metrics = bundle.step_fn(state, tok, tgt)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        per_step.append([kern.launches - b for kern, b in zip(kernels, before)])
    counts = {kern.__name__: kern.launches for kern in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    capacity_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    profile = device_profile(lambda: bundle.step_fn(state, tok, tgt), steps=1,
                             count_ops=("aten::select_backward", "aten::zeros"))
    n_params = cfg.num_params()
    steady_ms = sum(step_ms[1:]) / max(len(step_ms) - 1, 1)
    tokens_per_s = batch * seq / (steady_ms / 1e3)
    mfu = 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS
    row = dict(config="GPTJ_6B", params=n_params, tokens=[batch, seq], remat=cfg.remat,
               optimizer="AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)",
               init_s=init_s, losses=losses, grad_norms=norms, step_ms=step_ms,
               steady_step_ms=steady_ms, tokens_per_s=tokens_per_s, mfu=mfu,
               mfu_rule="6 * params * tokens/s / 989e12 (bench.py)", peak_gib=peak_gib,
               capacity_gib=capacity_gib, card=smi, launches_per_step=per_step,
               launches=counts, profiled_step=profile)
    log("train", **row)
    want = [2 * cfg.n_layers, cfg.n_layers, 0]
    if any(p != want for p in per_step):
        raise AssertionError(f"train: launches per step {per_step}, want {want} each "
                             f"(flash forward twice per layer under remat, backward once)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: non-finite loss or grad_norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall on one fixed batch: {losses}")
    if peak_gib >= capacity_gib:
        raise AssertionError(f"train: peak {peak_gib} GiB not under capacity {capacity_gib} GiB")
    if profile.get("op_counts", {}).get("aten::select_backward", 0):
        raise AssertionError(f"train: select_backward ran in a step: {profile['op_counts']}")
    return counts, row


# Ring attention's per-hop schedule in one process: RING_SHARDS sequence
# shards of RING_SEQ // RING_SHARDS tokens, causal, bf16, B=1, at
# Llama-2-7B's attention (32 heads of 128) and GPT-J's (16 heads of 256).
# out, lse, dQ, dK and dV of the ring (kernels 1 and 1b per hop, merged in
# fp32) are held to the ATOL/RTOL rule against the same kernels over the
# whole sequence and against the plain versions (run a few heads at a
# time: one (S, S) fp32 score matrix per head is 256 MiB).
RING_SEQ, RING_SHARDS = 8192, 4
RING_CASES = [("llama2_7b", 32, 32, 128), ("gptj_6b", 16, 16, 256)]
RING_PLAIN_HEADS = 4


def _plain_by_heads(q, k, v, out, lse, d_out):
    """The plain forward and backward over the whole sequence, a few heads
    at a time (no GQA in RING_CASES: kv head h serves query head h)."""
    from ray_tpu_torch.kernels.flash_attention import (
        flash_attention_backward_reference,
        flash_attention_reference,
    )

    outs, lses, grads = [], [], []
    for h0 in range(0, q.shape[2], RING_PLAIN_HEADS):
        cut = slice(h0, h0 + RING_PLAIN_HEADS)
        o, l = flash_attention_reference(q[:, :, cut], k[:, :, cut], v[:, :, cut], causal=True)
        outs.append(o)
        lses.append(l)
        # the backward from the kernel's out and lse, as the ring's hops take them
        grads.append(flash_attention_backward_reference(
            q[:, :, cut], k[:, :, cut], v[:, :, cut], out[:, :, cut], lse[:, cut],
            d_out[:, :, cut], causal=True))
        del o, l
        torch.cuda.empty_cache()
    return (torch.cat(outs, 2), torch.cat(lses, 1),
            [torch.cat([g[i] for g in grads], 2) for i in range(3)])


def phase_ring_schedule():
    """The ring's whole per-hop schedule (``ring_schedule_forward`` /
    ``_backward``, the code the distributed ring runs per hop) over
    RING_SHARDS shards; counts the kernel launches of the ring run."""
    from ray_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_backward,
    )
    from ray_tpu_torch.ops.attention import ring_schedule_backward, ring_schedule_forward

    gen = torch.Generator(device="cuda").manual_seed(5)
    launches = {"flash_attention": 0, "flash_attention_backward": 0}
    rows = []
    n, s = RING_SHARDS, RING_SEQ // RING_SHARDS
    for name, h, kv, d in RING_CASES:
        q, d_out = (torch.randn((1, RING_SEQ, h, d), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
        k, v = (torch.randn((1, RING_SEQ, kv, d), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(n, dim=1)] for x in (q, k, v, d_out))
        flash_attention.launches = flash_attention_backward.launches = 0
        fwd = ring_schedule_forward(qs, ks, vs, causal=True)
        outs, lses = [o for o, _ in fwd], [l for _, l in fwd]
        grads = ring_schedule_backward(qs, ks, vs, outs, lses, dos, causal=True)
        torch.cuda.synchronize()
        ran = (flash_attention.launches, flash_attention_backward.launches)
        launches["flash_attention"] += ran[0]
        launches["flash_attention_backward"] += ran[1]
        ring = {"out": torch.cat(outs, 1), "lse": torch.cat(lses, 2),
                "dq": torch.cat([g[0] for g in grads], 1), "dk": torch.cat([g[1] for g in grads], 1),
                "dv": torch.cat([g[2] for g in grads], 1)}
        whole_out, whole_lse = flash_attention(q, k, v, causal=True)
        whole = dict(zip(("dq", "dk", "dv"), flash_attention_backward(
            q, k, v, whole_out, whole_lse, d_out, causal=True)), out=whole_out, lse=whole_lse)
        plain_out, plain_lse, plain_grads = _plain_by_heads(q, k, v, ring["out"], ring["lse"], d_out)
        plain = dict(zip(("dq", "dk", "dv"), plain_grads), out=plain_out, lse=plain_lse)
        errors = {key: {"vs_whole_kernel": max_err(ring[key], whole[key], f"ring {name} {key} vs whole"),
                        "vs_plain": max_err(ring[key], plain[key], f"ring {name} {key} vs plain"),
                        "rel_vs_whole": rel_err(ring[key], whole[key])}
                  for key in ("out", "lse", "dq", "dk", "dv")}
        del plain, plain_grads, plain_out, plain_lse
        torch.cuda.empty_cache()
        # per-hop kernel time: the diagonal hop is causal, a past hop full
        hop_fwd = {c: cuda_ms(lambda c=c: flash_attention(qs[1], ks[1], vs[1], causal=c))
                   for c in (True, False)}
        hop_bwd = {c: cuda_ms(lambda c=c: flash_attention_backward(
            qs[1], ks[1], vs[1], outs[1], lses[1], dos[1], causal=c)) for c in (True, False)}
        diagonal, past = n, n * (n - 1) // 2
        row = dict(case=name, shards=n, shard_tokens=s, heads=h, kv_heads=kv, head_dim=d,
                   causal=True, launches_fwd_bwd=list(ran), tol=TOL_RULE, errors=errors,
                   hop_ms={"fwd_causal": hop_fwd[True], "fwd_full": hop_fwd[False],
                           "bwd_causal": hop_bwd[True], "bwd_full": hop_bwd[False]},
                   summed_hop_kernel_ms={
                       "fwd": diagonal * hop_fwd[True] + past * hop_fwd[False],
                       "bwd": diagonal * hop_bwd[True] + past * hop_bwd[False]},
                   schedule_ms={"fwd": cuda_ms(lambda: ring_schedule_forward(qs, ks, vs), iters=5),
                                "bwd": cuda_ms(lambda: ring_schedule_backward(
                                    qs, ks, vs, outs, lses, dos), iters=5)},
                   whole_kernel_ms={"fwd": cuda_ms(lambda: flash_attention(q, k, v, causal=True)),
                                    "bwd": cuda_ms(lambda: flash_attention_backward(
                                        q, k, v, whole_out, whole_lse, d_out, causal=True))})
        log("ring_schedule", **row)
        if list(ran) != [diagonal + past] * 2:
            raise AssertionError(f"ring {name}: launches {ran}, want {diagonal + past} each "
                                 f"({diagonal} diagonal and {past} past hops; no future hop)")
        rows.append(row)
        del q, k, v, d_out, qs, ks, vs, dos, fwd, outs, lses, grads, ring, whole
        torch.cuda.empty_cache()
    return launches, rows


# spmd_mesh1 against phase_train's single-device steps from the same seeded
# weights and batch. At one rank every group is None: the mesh step runs
# the single-device step's operations in the same order (one block body,
# one loss, one norm), so it is expected to match it exactly. The limit
# leaves a few fp32 steps for reduction order. For scale: the same phase
# with the vocab-parallel cross-entropy at one rank (max, sum of
# exponentials, log in fp32, in place of torch.logsumexp; an fp32
# rounding-level change) read 2.5e-5 on the loss and 2.3e-4 on the norm
# on an H100, and fails it. Per step, relative to the single-device value:
SPMD_LOSS_RTOL, SPMD_NORM_RTOL = 1e-6, 1e-6


def phase_spmd_mesh1(smi, single: dict, steps: int = 3):
    """``build_lm_train_step(GPTJ_6B, mesh)`` at full width and depth over
    ``create_mesh()`` on a one-rank NCCL group, from phase_train's seed
    and batch: ``steps`` AdamW steps held to phase_train's losses and
    norms. Every axis is trivial at one rank, so no collective runs."""
    import numpy as np
    import torch.distributed as dist

    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.kernels.paged_attention import paged_attention
    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    cfg = GPTJ_6B
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cuda")
    try:
        mesh = create_mesh()
        torch.cuda.reset_peak_memory_stats()
        bundle = build_lm_train_step(cfg, mesh, learning_rate=1e-4)
        state = bundle.init_state(0)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size - 1, (1, 2048), dtype=np.int32)
        tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
        kernels = (flash_attention, flash_attention_backward, paged_attention)
        for kern in kernels:
            kern.launches = 0
        losses, norms, step_ms, per_step = [], [], [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(steps):
            before = [kern.launches for kern in kernels]
            start.record()
            state, metrics = bundle.step_fn(state, tok, tgt)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            per_step.append([kern.launches - b for kern, b in zip(kernels, before)])
        counts = {kern.__name__: kern.launches for kern in kernels}
        row = dict(config="GPTJ_6B", mesh=mesh.shape, backend=dist.get_backend(),
                   world=dist.get_world_size(), tokens=[1, 2048], remat=cfg.remat,
                   losses=losses, grad_norms=norms, single_device_losses=single["losses"][:steps],
                   single_device_grad_norms=single["grad_norms"][:steps],
                   loss_rel_diff=[abs(a - b) / abs(b) for a, b in zip(losses, single["losses"])],
                   grad_norm_rel_diff=[abs(a - b) / abs(b) for a, b in zip(norms, single["grad_norms"])],
                   tol=dict(loss_rtol=SPMD_LOSS_RTOL, grad_norm_rtol=SPMD_NORM_RTOL),
                   step_ms=step_ms, single_device_step_ms=single["step_ms"][:steps],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches_per_step=per_step, launches=counts, card=smi)
        log("spmd_mesh1", **row)
    finally:
        distributed.shutdown()
    want = [2 * cfg.n_layers, cfg.n_layers, 0]
    if any(p != want for p in per_step):
        raise AssertionError(f"spmd_mesh1: launches per step {per_step}, want {want} each")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"spmd_mesh1: non-finite loss or grad_norm: {losses} {norms}")
    if any(d > SPMD_LOSS_RTOL for d in row["loss_rel_diff"]) or \
            any(d > SPMD_NORM_RTOL for d in row["grad_norm_rel_diff"]):
        raise AssertionError(f"spmd_mesh1: beyond the single-device step: {row['loss_rel_diff']} "
                             f"{row['grad_norm_rel_diff']}")
    return counts


# spmd_tensor2: two ranks share the one card through gloo on CUDA tensors
# (NCCL refuses two ranks on one device; gloo's all-reduce, the only
# collective of a tensor=2 mesh, stages CUDA tensors through the host).
# GPT-J-6B's width at TENSOR2_LAYERS layers, B=1, S=2048, remat, AdamW,
# 3 steps, each rank holding its 8 heads, half the MLP and half the
# vocabulary, against the single-device step from the same seed and
# batch. Tensor parallelism rounds each rank's partial sums (attention's
# and the MLP's outputs, the backward's dL/dh) to bf16 before the
# all-reduce adds them, where one card's GEMM adds in fp32 and rounds
# once: about one bf16 step (2**-8 relative) more noise per block,
# averaged over 2048 tokens in the loss and over every element in the
# norm. On an H100 the three steps read at most 2.1e-5 on the loss and
# 3.1e-4 on the norm; the limits are about 10x those. Per step, relative
# to the single-device value:
TENSOR2_LAYERS = 4
TENSOR2_LOSS_RTOL, TENSOR2_NORM_RTOL = 2e-4, 3e-3


def _gptj_steps(bundle, steps: int):
    """``steps`` steps of ``bundle`` from seed 0 on phase_train's batch:
    losses, grad norms, step ms (CUDA events) and flash launches per step."""
    import numpy as np

    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward

    state = bundle.init_state(0)
    tokens = np.random.default_rng(0).integers(0, bundle.config.vocab_size - 1, (1, 2048),
                                               dtype=np.int32)
    tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
    out = {"losses": [], "grad_norms": [], "step_ms": [], "launches_per_step": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(steps):
        flash_attention.launches = flash_attention_backward.launches = 0
        start.record()
        state, metrics = bundle.step_fn(state, tok, tgt)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        out["losses"].append(metrics["loss"].item())
        out["grad_norms"].append(metrics["grad_norm"].item())
        out["launches_per_step"].append([flash_attention.launches, flash_attention_backward.launches])
    out["wq_shape"] = list(state["params"]["wq"].shape)
    return out


def _tensor2_rank(rank: int, address: str, steps: int, results) -> None:
    """One rank of phase_spmd_tensor2, in its own process."""
    import dataclasses

    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(address, 2, rank, device="cuda", local_rank=0, backend="gloo")
    try:
        mesh = create_mesh(MeshConfig(tensor=2))
        cfg = dataclasses.replace(GPTJ_6B, n_layers=TENSOR2_LAYERS)
        bundle = build_lm_train_step(cfg, mesh, learning_rate=1e-4)
        results.put((rank, _gptj_steps(bundle, steps)))
    finally:
        distributed.shutdown()


def phase_spmd_tensor2(smi, steps: int = 3):
    """A tensor=2 mesh of two rank processes on the one card (gloo on CUDA
    tensors), held to the single-device step; both ranks' flash launches."""
    import dataclasses
    import multiprocessing
    import queue

    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    cfg = dataclasses.replace(GPTJ_6B, n_layers=TENSOR2_LAYERS)
    single = _gptj_steps(build_lm_train_step(cfg, learning_rate=1e-4), steps)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{distributed.free_port()}"
    procs = [ctx.Process(target=_tensor2_rank, args=(r, address, steps, results)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=300) for _ in procs)
    except queue.Empty:
        raise AssertionError(f"spmd_tensor2: a rank gave no result (exit codes "
                             f"{[p.exitcode for p in procs]})") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    ranks = [got[0], got[1]]
    loss_diff = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], single["losses"])]
    norm_diff = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["grad_norms"], single["grad_norms"])]
    row = dict(config=f"GPTJ_6B, n_layers={TENSOR2_LAYERS}", mesh={"tensor": 2}, backend="gloo",
               processes=2, card=smi, tokens=[1, 2048], remat=cfg.remat, single_device=single,
               ranks=ranks, loss_rel_diff=loss_diff, grad_norm_rel_diff=norm_diff,
               tol=dict(loss_rtol=TENSOR2_LOSS_RTOL, grad_norm_rtol=TENSOR2_NORM_RTOL),
               seconds=seconds)
    log("spmd_tensor2", **row)
    want = [[2 * cfg.n_layers, cfg.n_layers]] * steps
    for r in ranks:
        if r["launches_per_step"] != want:
            raise AssertionError(f"spmd_tensor2: flash launches per step {r['launches_per_step']}, want {want}")
        if r["wq_shape"] != [cfg.n_layers, cfg.d_model, cfg.n_heads // 2, cfg.head_dim]:
            raise AssertionError(f"spmd_tensor2: wq shard {r['wq_shape']} is not half the heads")
    if ranks[0]["losses"] != ranks[1]["losses"] or ranks[0]["grad_norms"] != ranks[1]["grad_norms"]:
        raise AssertionError("spmd_tensor2: the two ranks disagree on loss or grad_norm")
    if not all(math.isfinite(x) for x in ranks[0]["losses"] + ranks[0]["grad_norms"]):
        raise AssertionError("spmd_tensor2: non-finite loss or grad_norm")
    if any(d > TENSOR2_LOSS_RTOL for d in loss_diff) or any(d > TENSOR2_NORM_RTOL for d in norm_diff):
        raise AssertionError(f"spmd_tensor2: beyond the single-device step: {loss_diff} {norm_diff}")
    return {"flash_attention": sum(s[0] for r in ranks for s in r["launches_per_step"]),
            "flash_attention_backward": sum(s[1] for r in ranks for s in r["launches_per_step"])}


# -- phase runtime_gpu: the port's core runtime on the card -----------------

# Phase runtime_gpu's requests: three prompts of 16-1500 tokens served
# together, then the middle one alone, 32 greedy tokens each, through the
# driver's own LLMServer (before it drops its model) and through an actor's.
# phase train_gpu: the Train library's trainer runs phase_train's step in a
# GPU worker's own process, from the same seed, batch and learning rate; it
# is the same program on the same card, so its losses are held to
# phase_train's as spmd_mesh1's are (a few fp32 steps for reduction order).
# phase train_restart: the scaled-down GPT-J of examples/gptj_finetune.py
# (d_model 512, 4 layers, 8 heads of 64, d_ff 2048, vocab 50432), B=4,
# S=256, one batch per step from the step's seed, TRAIN_RESTART_STEPS AdamW
# steps: a checkpoint at step 2, one injected failure after step 3, resumed
# by FailureConfig(max_failures=1) from the checkpoint (parameters and
# AdamW moments restored bit for bit), against an uninterrupted run. Both
# runs ask for use_torch_distributed: each attempt's worker joins a one-rank
# NCCL group through the KV, and after each fit no rendezvous key is left
# (rank 0 drops it only once its group is destroyed).
# Per step, relative to the reference value:
TRAIN_GPU_LOSS_RTOL = 1e-6
TRAIN_RESTART_STEPS, TRAIN_RESTART_CKPT, TRAIN_RESTART_FAIL = 5, 2, 3
TRAIN_RESTART_CFG = dict(vocab_size=50432, d_model=512, n_layers=4, n_heads=8, d_ff=2048,
                         max_seq_len=512, parallel_block=True, use_swiglu=False)


def _train_gpu_loop(config):
    """GPT-J-6B's training step in a train worker's own process: phase_train's
    seed, batch and learning rate; one ``train.report`` per step, carrying
    the step's loss, its CUDA-event time, the flash launches this process
    made in it, the peak memory and the time the earlier reports took."""
    import os
    import sys

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    torch.cuda.reset_peak_memory_stats()
    bundle = build_lm_train_step(GPTJ_6B, learning_rate=config["lr"])
    state = bundle.init_state(config["seed"])
    tokens = np.random.default_rng(0).integers(0, GPTJ_6B.vocab_size - 1, (1, 2048),
                                               dtype=np.int32)
    tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
    out = dict(pid=os.getpid(), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               device_count=torch.cuda.device_count(), device=str(tok.device),
               jax_loaded=sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu")),
               losses=[], step_ms=[], launches_per_step=[], report_ms=[])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(config["steps"]):
        before = (flash_attention.launches, flash_attention_backward.launches)
        start.record()
        state, metrics = bundle.step_fn(state, tok, tgt)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        out["losses"].append(metrics["loss"].item())
        out["launches_per_step"].append([flash_attention.launches - before[0],
                                         flash_attention_backward.launches - before[1]])
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        train.report(dict(out))
        out["report_ms"].append((time.perf_counter() - t0) * 1e3)


def _split_inputs_targets(batch):
    """map_batches task of phase data_train_gpu: a row of tokens -> the
    step's inputs and its targets (the row rolled by one, as phase_train)."""
    import numpy as np

    return {"inputs": batch["tokens"], "targets": np.roll(batch["tokens"], -1, axis=1)}


def _data_train_loop(config):
    """phase_train's GPT-J-6B step fed by the trainer's dataset through
    ``train.get_dataset_shard("train").iter_torch_batches(batch_size=1)``
    on the card (the default device): one ``train.report`` per batch with
    the loss, the step's CUDA-event time, its flash launches and whether
    the batch on the card equals the dataset's row bit for bit."""
    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    bundle = build_lm_train_step(GPTJ_6B, learning_rate=config["lr"])
    state = bundle.init_state(config["seed"])
    want_in = torch.tensor(config["tokens"])
    want_tgt = torch.roll(want_in, -1, 1)
    out = dict(losses=[], step_ms=[], launches_per_step=[], rows_equal=[], batch=[])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for batch in train.get_dataset_shard("train").iter_torch_batches(batch_size=1):
        tok, tgt = batch["inputs"], batch["targets"]
        before = (flash_attention.launches, flash_attention_backward.launches)
        start.record()
        state, metrics = bundle.step_fn(state, tok, tgt)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        out["losses"].append(metrics["loss"].item())
        out["launches_per_step"].append([flash_attention.launches - before[0],
                                         flash_attention_backward.launches - before[1]])
        out["rows_equal"].append(torch.equal(tok.cpu(), want_in) and torch.equal(tgt.cpu(), want_tgt))
        out["batch"].append({k: [str(v.device), str(v.dtype), list(v.shape)]
                             for k, v in batch.items()})
        train.report(dict(out))


def _train_restart_loop(config):
    """The scaled-down GPT-J through the trainer: a checkpoint (parameters,
    AdamW moments, progress) at ``checkpoint_at``, an injected failure after
    ``fail_at`` (once: a marker file), resume from the latest checkpoint.
    Each step appends this process's flash launches to ``ledger``."""
    import json
    import os
    import tempfile

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    import torch.distributed as dist

    cfg = TransformerConfig(**config["cfg"])
    group = [dist.get_backend(), dist.get_world_size()] if dist.is_initialized() else None
    bundle = build_lm_train_step(cfg, learning_rate=config["lr"])
    state = bundle.init_state(0)
    progress = {"step": 0, "losses": []}
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = train.load_pytree(ckpt.path, target=state)
        with open(os.path.join(ckpt.path, "progress.json")) as fh:
            progress = json.load(fh)
    losses = list(progress["losses"])
    for step in range(progress["step"] + 1, config["steps"] + 1):
        tokens = np.random.default_rng(step).integers(
            0, cfg.vocab_size - 1, (config["batch"], config["seq"]), dtype=np.int32)
        tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
        before = (flash_attention.launches, flash_attention_backward.launches)
        state, metrics = bundle.step_fn(state, tok, tgt)
        losses.append(metrics["loss"].item())
        with open(config["ledger"], "a") as fh:
            fh.write(f"{os.getpid()} {step} {flash_attention.launches - before[0]} "
                     f"{flash_attention_backward.launches - before[1]}\n")
        checkpoint = None
        if step == config["checkpoint_at"]:
            d = tempfile.mkdtemp(prefix="train_restart_")
            train.save_pytree(state, d)
            with open(os.path.join(d, "progress.json"), "w") as fh:
                json.dump({"step": step, "losses": losses}, fh)
            checkpoint = train.Checkpoint.from_directory(d)
        train.report({"losses": list(losses), "resumed_from": progress["step"],
                      "process_group": group}, checkpoint=checkpoint)
        if step == config.get("fail_at") and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError(f"injected failure after step {step}")


def _read_ledger(path):
    """{pid: [steps, flash forward launches, backward launches]}."""
    out = {}
    with open(path) as fh:
        for line in fh:
            pid, step, fwd, bwd = (int(x) for x in line.split())
            row = out.setdefault(pid, [[], 0, 0])
            row[0].append(step)
            row[1] += fwd
            row[2] += bwd
    return out


def _timeline_steps(run: str, steps: int, timeout_s: float = 30.0) -> list:
    """Rank 0's step records of ``run`` from the step plane, once all
    ``steps`` have landed (the last drains through the telemetry ring)."""
    import ray_tpu_torch

    deadline = time.monotonic() + timeout_s
    while True:
        tl = ray_tpu_torch.train_timeline(run).to_dict()
        recs = [st["ranks"]["0"] for st in tl.get("steps", []) if "0" in st["ranks"]]
        if len(recs) >= steps or time.monotonic() > deadline:
            return sorted(recs, key=lambda rec: rec["step"])
        time.sleep(0.2)


def phase_data_train_gpu(smi, single: dict, storage: str, train_gpu_step_ms: list) -> list:
    """The slice's main path: GPT-J-6B at full size trained by
    ``DataParallelTrainer(datasets=...)`` in a ``use_gpu`` worker, fed by
    ``ray_tpu_torch.data.from_numpy`` of phase_train's fixed batch (3 rows)
    through a ``map_batches`` task that splits inputs and targets, and
    ``iter_torch_batches`` on the card. Returns the worker's flash launches
    (forward, backward)."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    steps = 3
    tokens = np.random.default_rng(0).integers(0, GPTJ_6B.vocab_size - 1, (1, 2048),
                                               dtype=np.int32)
    ds = data.from_numpy(np.repeat(tokens, steps, axis=0), column="tokens",
                         num_blocks=steps).map_batches(_split_inputs_targets)
    t0 = time.perf_counter()
    result = DataParallelTrainer(
        _data_train_loop, train_loop_config={"lr": 1e-4, "seed": 0, "tokens": tokens},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=storage, name="data_train_gpu"),
        datasets={"train": ds},
    ).fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"data_train_gpu: the trainer failed: {result.error!r}")
    m = result.metrics
    recs = _timeline_steps("data_train_gpu", steps)
    stages = [rec["stages"] for rec in recs]
    want = single["losses"][:steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(m["losses"], want)]
    per_step = m["launches_per_step"]
    row = dict(config="GPTJ_6B", tokens=[1, 2048], steps=steps, card=smi, fit_s=fit_s,
               dataset="from_numpy(3 x 2048 int32, 3 blocks).map_batches(split)",
               batches=m["batch"], rows_equal=m["rows_equal"], losses=m["losses"],
               phase_train_losses=want, loss_rel_diff=rel,
               tol=dict(loss_rtol=TRAIN_GPU_LOSS_RTOL), step_ms=m["step_ms"],
               train_gpu_step_ms=train_gpu_step_ms,
               phase_train_step_ms=single["step_ms"][:steps], launches_per_step=per_step,
               step_records=[{k: st.get(k) for k in ("data_wait_ms", "host_to_device_ms",
                                                      "compute_ms", "other_ms")}
                             for st in stages],
               training_iteration=m["training_iteration"])
    log("data_train_gpu", **row)
    if m["training_iteration"] != steps or len(m["losses"]) != steps:
        raise AssertionError(f"data_train_gpu: {m['training_iteration']} reports for {steps} rows")
    if any(b["inputs"][0] != "cuda:0" or b["inputs"][1] != "torch.int32" for b in m["batch"]):
        raise AssertionError(f"data_train_gpu: batches {m['batch']}")
    if not all(m["rows_equal"]):
        raise AssertionError(f"data_train_gpu: a batch on the card differs from its row: "
                             f"{m['rows_equal']}")
    if any(p != [2 * GPTJ_6B.n_layers, GPTJ_6B.n_layers] for p in per_step):
        raise AssertionError(f"data_train_gpu: flash launches per step {per_step}, want "
                             f"{[2 * GPTJ_6B.n_layers, GPTJ_6B.n_layers]} each")
    if any(d > TRAIN_GPU_LOSS_RTOL for d in rel):
        raise AssertionError(f"data_train_gpu: losses {m['losses']} beyond phase_train's {want}")
    if len(stages) != steps or any(not st.get("host_to_device_ms", 0) > 0 or "data_wait_ms" not in st
                                   for st in stages):
        raise AssertionError(f"data_train_gpu: step records {stages}")
    return [sum(p[0] for p in per_step), sum(p[1] for p in per_step)]


# Phase data_feed_vit: 4,096 seeded uint8 images of 224x224x3 (616 MB) made
# in 64 blocks by map_batches tasks, fed to ViT-L/16 in batches of 256.
VIT_FEED_IMAGES, VIT_FEED_BLOCKS, VIT_FEED_BATCH = 4096, 64, 256


def _vit_feed_images(block):
    """map_batches task of phase data_feed_vit: a block of ids -> that many
    seeded uint8 images (the block's first id seeds the generator)."""
    import numpy as np

    ids = block["id"]
    rng = np.random.default_rng([11, int(ids[0])])
    return {"image": rng.integers(0, 256, (len(ids), 224, 224, 3), dtype=np.uint8)}


def _normalize_images(images):
    """uint8 NHWC -> float32 in [-1, 1], on the images' device."""
    return images.to(torch.float32) / 127.5 - 1.0


def _feed_pass(ds, cfg, params, run: str) -> dict:
    """One pass of phase data_feed_vit's dataset through the feed into the
    forward, under a step timer (one step per batch); the fed batches, their
    logits, the step records, the seconds, the copy stream's stats and the
    flash launches."""
    from ray_tpu_torch._private import stepplane
    from ray_tpu_torch.data import DataIterator
    from ray_tpu_torch.kernels.flash_attention import flash_attention
    from ray_tpu_torch.models import vit

    it = DataIterator(ds)
    timer = stepplane.StepTimer(run, 0, 1)
    stepplane.activate(timer)
    out = dict(fed=[], logits=[], recs=[])
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            for i, batch in enumerate(it.iter_torch_batches(batch_size=VIT_FEED_BATCH)):
                out["fed"].append(batch["image"])
                out["logits"].append(vit.forward(cfg, params, _normalize_images(batch["image"])))
                timer.mark_pre_report()
                out["recs"].append(stepplane.decode_record(timer.finalize_step(i + 1)))
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
    finally:
        stepplane.activate(None)
    out["launches"] = flash_attention.launches
    out["copy"] = it.copy_stats()
    return out


def _feed_row(p: dict) -> dict:
    recs, copy = p["recs"], p["copy"]
    wall = sum(r["wall_ms"] for r in recs)
    return dict(seconds=p["seconds"], images_per_s=len(p["fed"]) * VIT_FEED_BATCH / p["seconds"],
                launches=p["launches"],
                stepplane_shares={k: sum(r["stages"][k] for r in recs) / wall
                                  for k in ("data_wait_ms", "host_to_device_ms", "compute_ms")},
                step_wall_ms=[r["wall_ms"] for r in recs],
                data_wait_ms=[r["stages"]["data_wait_ms"] for r in recs],
                host_to_device_ms=[r["stages"]["host_to_device_ms"] for r in recs],
                ops=[r["ops"] for r in recs], copy=copy,
                copy_gb_per_s=copy["bytes"] / copy["copy_ms"] / 1e6 if copy["copy_ms"] else None)


def phase_data_feed_vit(smi, forward_images_per_s: float) -> int:
    """The CUDA feed at an image model's rate: ``ray_tpu_torch.data.range``
    -> ``map_batches`` image tasks -> ``iter_torch_batches(batch_size=256)``
    on the card (pinned staging, the iterator's copy stream) -> normalised
    there -> ViT-L/16's forward (kernel 1 at Hd=64), under a step timer of
    the step plane (one step per batch). Two passes: the first (``cold``)
    starts the map tasks' workers and first touches the store's arena; the
    second (``warm``) is the measured one. Every batch the warm pass fed
    must equal the same images put on the card in one piece, and its logits
    those of ``vit.forward`` on them. ``forward_images_per_s`` is phase
    vit's forward alone at the same batch, printed beside the feed's rate.
    Returns the warm pass's flash launches."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.models import vit

    cfg = vit.VIT_L_16
    params = vit.init_params(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
    per = VIT_FEED_IMAGES // VIT_FEED_BLOCKS
    ref_host = np.concatenate([_vit_feed_images({"id": np.arange(i, i + per)})["image"]
                               for i in range(0, VIT_FEED_IMAGES, per)])
    ref = torch.from_numpy(ref_host).cuda()
    del ref_host
    ds = data.range(VIT_FEED_IMAGES, num_blocks=VIT_FEED_BLOCKS).map_batches(_vit_feed_images)
    cold = _feed_row(_feed_pass(ds, cfg, params, "data_feed_vit_cold"))
    warm = _feed_pass(ds, cfg, params, "data_feed_vit")
    fed, logits, launches, copy = warm["fed"], warm["logits"], warm["launches"], warm["copy"]
    with torch.inference_mode():
        equal_images = [torch.equal(f, ref[i * VIT_FEED_BATCH:(i + 1) * VIT_FEED_BATCH])
                        for i, f in enumerate(fed)]
        want = [vit.forward(cfg, params, _normalize_images(
            ref[i * VIT_FEED_BATCH:(i + 1) * VIT_FEED_BATCH])) for i in range(len(fed))]
        equal_logits = [torch.equal(g, w) for g, w in zip(logits, want)]
        diff = max((g - w).abs().max().item() for g, w in zip(logits, want))
    # one batch's pinned host-to-device copy with the card otherwise idle
    pinned = torch.empty(fed[0].shape, dtype=torch.uint8, pin_memory=True)
    on_card = torch.empty(fed[0].shape, dtype=torch.uint8, device="cuda")
    bare_ms = cuda_ms(lambda: on_card.copy_(pinned, non_blocking=True), iters=10, warmup=2)
    log("data_feed_vit", config="VIT_L_16", images=VIT_FEED_IMAGES, blocks=VIT_FEED_BLOCKS,
        batch=VIT_FEED_BATCH, card=smi, batches=len(fed),
        phase_vit_images_per_s=forward_images_per_s, warm=_feed_row(warm), cold=cold,
        idle_pinned_copy=dict(ms=bare_ms, gb_per_s=pinned.numel() / bare_ms / 1e6),
        images_equal=equal_images, logits_equal=equal_logits, logits_max_abs_diff=diff,
        tol="bitwise: torch.equal(fed batch, same images on the card) and of their logits")
    if len(fed) != VIT_FEED_IMAGES // VIT_FEED_BATCH or launches != len(fed) * cfg.n_layers:
        raise AssertionError(f"data_feed_vit: {len(fed)} batches, {launches} flash launches")
    if not all(equal_images) or not all(equal_logits):
        raise AssertionError(f"data_feed_vit: fed images equal {equal_images}, logits equal "
                             f"{equal_logits} (max abs diff {diff})")
    if copy["batches"] != len(fed) or copy["bytes"] != VIT_FEED_IMAGES * 224 * 224 * 3:
        raise AssertionError(f"data_feed_vit: copy stream stats {copy}")
    del fed, logits, want, ref, params, warm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_lib(smi, single: dict, vit_images_per_s: float) -> dict:
    """The Train library, the data library and RL's learner group on the
    card, on the port's runtime: phases train_gpu, data_train_gpu,
    train_restart, rl_learner_group and data_feed_vit. Returns the flash
    launches each training phase made in its workers, and the feed's."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import get_runtime
    from ray_tpu_torch.models.transformer import GPTJ_6B
    from ray_tpu_torch.train import (DataParallelTrainer, FailureConfig, RunConfig,
                                     ScalingConfig)

    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    counts = {}
    t0 = time.perf_counter()
    # the store holds data_feed_vit's whole image set (616 MB) three times over
    ray_tpu_torch.init(object_store_memory=2 * 1024**3)
    init_ms = (time.perf_counter() - t0) * 1e3
    try:
        # train_gpu: this process holds no model while its worker trains
        own_gib = torch.cuda.memory_allocated() / 2**30
        steps = 3
        t0 = time.perf_counter()
        result = DataParallelTrainer(
            _train_gpu_loop, train_loop_config={"steps": steps, "lr": 1e-4, "seed": 0},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=storage, name="train_gpu"),
        ).fit()
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            raise AssertionError(f"train_gpu: the trainer failed: {result.error!r}")
        m = result.metrics
        want = single["losses"][:steps]
        rel = [abs(a - b) / abs(b) for a, b in zip(m["losses"], want)]
        per_step = m["launches_per_step"]
        counts["train_gpu_worker"] = [sum(p[0] for p in per_step), sum(p[1] for p in per_step)]
        row = dict(config="GPTJ_6B", tokens=[1, 2048], steps=steps, card=smi, init_ms=init_ms,
                   smoke_process_allocated_gib_during_fit=own_gib, fit_s=fit_s,
                   worker={k: m[k] for k in ("pid", "cuda_visible_devices", "device_count",
                                             "device", "jax_loaded")},
                   losses=m["losses"], phase_train_losses=want, loss_rel_diff=rel,
                   tol=dict(loss_rtol=TRAIN_GPU_LOSS_RTOL), step_ms=m["step_ms"],
                   phase_train_step_ms=single["step_ms"][:steps], peak_gib=m["peak_gib"],
                   report_overhead_ms=m["report_ms"], launches_per_step=per_step,
                   training_iteration=m["training_iteration"],
                   goodput=result.goodput and {k: result.goodput[k]
                                               for k in ("wall_s", "goodput", "steps_useful")})
        log("train_gpu", **row)
        if m["device_count"] != 1 or m["pid"] == os.getpid() or m["jax_loaded"]:
            raise AssertionError(f"train_gpu: the worker saw {m['device_count']} devices, pid "
                                 f"{m['pid']} (this process {os.getpid()}), jax modules {m['jax_loaded']}")
        if own_gib >= 1.0:
            raise AssertionError(f"train_gpu: this process holds {own_gib} GiB on the card")
        if m["training_iteration"] != steps or len(m["losses"]) != steps:
            raise AssertionError(f"train_gpu: {m['training_iteration']} reports for {steps} steps")
        if any(p != [2 * GPTJ_6B.n_layers, GPTJ_6B.n_layers] for p in per_step):
            raise AssertionError(f"train_gpu: flash launches per step {per_step}, want "
                                 f"{[2 * GPTJ_6B.n_layers, GPTJ_6B.n_layers]} each")
        if any(d > TRAIN_GPU_LOSS_RTOL for d in rel):
            raise AssertionError(f"train_gpu: losses {m['losses']} beyond phase_train's {want}")

        counts["data_train_gpu"] = phase_data_train_gpu(smi, single, storage, m["step_ms"])

        # train_restart: a checkpoint, one failure, a resume
        runs = {}
        for name, fail_at in (("restarted", TRAIN_RESTART_FAIL), ("uninterrupted", None)):
            ledger = os.path.join(storage, f"{name}.ledger")
            config = dict(cfg=TRAIN_RESTART_CFG, lr=1e-4, batch=4, seq=256,
                          steps=TRAIN_RESTART_STEPS, checkpoint_at=TRAIN_RESTART_CKPT,
                          fail_at=fail_at, marker=os.path.join(storage, f"{name}.failed"),
                          ledger=ledger)
            t0 = time.perf_counter()
            res = DataParallelTrainer(
                _train_restart_loop, train_loop_config=config,
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                             use_torch_distributed=True),
                run_config=RunConfig(storage_path=storage, name=f"train_restart_{name}",
                                     failure_config=FailureConfig(max_failures=1,
                                                                  retry_backoff_s=0.0)),
            ).fit()
            if res.error is not None:
                raise AssertionError(f"train_restart ({name}): {res.error!r}")
            runs[name] = dict(fit_s=time.perf_counter() - t0, losses=res.metrics["losses"],
                              resumed_from=res.metrics["resumed_from"],
                              process_group=res.metrics["process_group"],
                              keys_left=get_runtime().rpc("kv_keys", "torch_rendezvous",
                                                          b"torchdist_"),
                              training_iteration=res.metrics["training_iteration"],
                              checkpoint=res.checkpoint.path if res.checkpoint else None,
                              attempts=_read_ledger(ledger))
        restarted, calm = runs["restarted"], runs["uninterrupted"]
        attempts = list(restarted["attempts"].values())
        counts["train_restart"] = [sum(a[1] for a in attempts), sum(a[2] for a in attempts)]
        final = (restarted["losses"][-1], calm["losses"][-1])
        rel = abs(final[0] - final[1]) / abs(final[1])
        log("train_restart", config=TRAIN_RESTART_CFG, tokens=[4, 256], card=smi,
            steps=TRAIN_RESTART_STEPS, checkpoint_at=TRAIN_RESTART_CKPT,
            fail_after=TRAIN_RESTART_FAIL, runs=runs, final_loss_rel_diff=rel,
            tol=dict(loss_rtol=TRAIN_GPU_LOSS_RTOL), flash_launches=counts["train_restart"])
        if len(attempts) != 2 or any(a[1] <= 0 or a[2] <= 0 for a in attempts):
            raise AssertionError(f"train_restart: the kernels did not run in two attempts: "
                                 f"{restarted['attempts']}")
        if restarted["resumed_from"] != TRAIN_RESTART_CKPT or calm["resumed_from"] != 0 \
                or restarted["training_iteration"] != TRAIN_RESTART_STEPS:
            raise AssertionError(f"train_restart: resumed from {restarted['resumed_from']}, "
                                 f"{restarted['training_iteration']} iterations")
        if rel > TRAIN_GPU_LOSS_RTOL or not math.isfinite(final[0]):
            raise AssertionError(f"train_restart: final loss {final[0]} against the "
                                 f"uninterrupted run's {final[1]}")
        for name, run in runs.items():
            if run["process_group"] != ["nccl", 1] or run["keys_left"]:
                raise AssertionError(f"train_restart ({name}): process group "
                                     f"{run['process_group']}, rendezvous keys left "
                                     f"{run['keys_left']}")

        phase_rl_learner_group(smi)
        counts["data_feed_vit"] = phase_data_feed_vit(smi, vit_images_per_s)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return counts


def phase_rl_learner_group(smi) -> None:
    """An SPMDLearnerGroup of one rank on the card (a ``num_gpus=1`` learner
    actor): its IMPALA update on phase rl's V-trace batch against the
    in-process learner's on the card, by the RL rule."""
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl.learner_group import SPMDLearnerGroup
    from ray_tpu_torch.rl.optim import to_numpy

    batch = _rl_batches()["vtrace"]
    algo = rl.IMPALAConfig().build(device="cuda")
    cfg = algo.config
    group_cfg = {"cfg_vals": dict(algo._cfg_vals), "update_builder": "impala", "obs_dim": 4,
               "num_actions": 2, "hidden": cfg.hidden, "lr": cfg.lr, "grad_clip": cfg.grad_clip,
               "seed": cfg.seed, "init_params": to_numpy(algo.params), "device": "cuda"}
    from ray_tpu_torch._private.worker import get_runtime

    t0 = time.perf_counter()
    group = SPMDLearnerGroup(1, group_cfg, init_timeout_s=300, update_timeout_s=300)
    start_s = time.perf_counter() - t0
    # the learner joined its one-rank NCCL group, and rank 0 dropped the key
    keys_left = get_runtime().rpc("kv_keys", "torch_rendezvous", b"torch_rl_learners_")
    try:
        update_ms = []
        t0 = time.perf_counter()
        metrics = group.update(batch)
        update_ms.append((time.perf_counter() - t0) * 1e3)
        params = group.cached_params()
        # two more rounds, timed (the state moves on; the check is the first)
        for _ in range(2):
            t0 = time.perf_counter()
            group.update(batch)
            update_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        group.stop()
    device_batch = algo._to_device(batch)
    local_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = algo._update(algo.params, algo.opt_state, device_batch)[2]
        torch.cuda.synchronize()
        local_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            local = {k: float(v) for k, v in out.items()}
            local_params = to_numpy(algo.params)
    row = dict(config="IMPALAConfig(), T=128 x N=16 V-trace batch, last lane masked", card=smi,
               ranks=group.total_devices, rendezvous_keys_left=keys_left,
               group_start_s=start_s, group_update_ms=update_ms,
               local_update_ms=local_ms, metrics=metrics, local_metrics=local,
               tol=f"|group - in-process| <= {RL_ATOL} + {RL_RTOL} * |in-process|")
    if sorted(metrics) != sorted(local) or keys_left:
        raise AssertionError(f"rl_learner_group: metrics {sorted(metrics)} vs {sorted(local)}, "
                             f"rendezvous keys left {keys_left}")
    row["metrics_max_abs_err"] = _rl_max_diff(metrics, local)
    row["params_max_abs_err"] = _rl_max_diff(params, local_params)
    log("rl_learner_group", **row)
    algo.stop()


RUNTIME_PROMPT_LENGTHS = [16, 700, 1500]
RUNTIME_NEW_TOKENS = 32


def _runtime_prompts(cfg):
    gen = torch.Generator().manual_seed(17)
    return [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in RUNTIME_PROMPT_LENGTHS]


def _serve_workload(server, prompts, solo, max_new) -> dict:
    """The requests phase runtime_gpu sends an engine, run where ``server``
    lives (the driver, or the GPU actor's process): the prompts together
    once to warm up, then again with the kernels' launch counters set to 0
    just before and read just after, then ``solo`` alone under
    torch.profiler, whose device kernels are counted by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.kernels.flash_attention import flash_attention
    from ray_tpu_torch.kernels.paged_attention import paged_attention

    engine = server.engine
    kernels = (flash_attention, paged_attention)
    # warm-up: the same requests once, untimed (a fresh process pays for
    # cuBLAS handles and heuristics on its first calls)
    for warm in [engine.submit(p, max_new_tokens=max_new) for p in prompts]:
        warm.tokens()
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    streams = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = [s.tokens() for s in streams]
    wall = time.perf_counter() - t0
    counts = {kern.__name__: kern.launches for kern in kernels}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream = engine.submit(solo, max_new_tokens=max_new)
        solo_out = stream.tokens()
        solo_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    ttft = sorted(s.ttft_s * 1e3 for s in streams)
    n_tok = sum(len(o) for o in outs)
    return dict(tokens=outs, batch_wall_s=wall, tokens_per_s=n_tok / wall,
                ttft_ms=ttft, launches=counts, solo_tokens=solo_out,
                solo_ttft_ms=stream.ttft_s * 1e3, solo_wall_s=solo_wall,
                solo_tokens_per_s=len(solo_out) / solo_wall,
                solo_profiler_kernels={
                    "flash_fwd_kernel": sum("flash_fwd_kernel" in n for n in device),
                    "paged_decode_kernel": sum("paged_decode_kernel" in n for n in device),
                    "all": len(device)})


def _params_checksum(params) -> str:
    """A digest of every parameter: the float64 sum and sum of squares of
    each leaf in at most 64 slices along its first axis (one per layer of a
    stacked leaf), a slice at a time, so no full-size copy is made."""
    import hashlib

    stats = []
    for name in sorted(params):
        t = params[name]
        rows = t.reshape(t.shape[0], -1) if t.dim() >= 2 else t.reshape(1, -1)
        for part in torch.tensor_split(rows, min(rows.shape[0], 64)):
            x = part.float()
            stats += [torch.sum(x, dtype=torch.float64), torch.sum(x * x, dtype=torch.float64)]
    return hashlib.sha256(torch.stack(stats).cpu().numpy().tobytes()).hexdigest()


def phase_runtime_driver_serve(params, cfg, ecfg) -> dict:
    """Phase runtime_gpu's requests through the driver's own LLMServer, while
    the driver still holds the serving model."""
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    prompts = _runtime_prompts(cfg)
    server = LLMServer(cfg, ecfg, deployment="llama2-7b-driver",
                       params_loader=lambda _cfg: params, device="cuda")
    try:
        out = _serve_workload(server, prompts, prompts[1], RUNTIME_NEW_TOKENS)
    finally:
        server.engine.shutdown()
    out["checksum"] = _params_checksum(params)
    # the logits of every step of the solo request, through the kernels, for
    # holding the actor's to the driver's where their tokens part: one causal
    # forward over the prompt and the driver's tokens gives each step's
    out["solo_step_logits"] = _step_logits(params, cfg, prompts[1], out["solo_tokens"])
    return out


# Prompt lengths of phase dag_pipeline (Llama-2-7B through one CUDA graph).
DAG_LENGTHS = [2048, 128]


def phase_dag_pipeline(params, cfg, smi) -> dict:
    """``compile_torch_pipeline`` over ``forward_stages`` (embed -> 32
    blocks -> final norm and unembed) while this process holds Llama-2-7B:
    one CUDA graph per prompt length. Its logits must equal eager
    ``forward``'s bit for bit, also for a second prompt of the same length
    (the graph's static input refilled); the capture must hold one flash
    launch per layer, and replays must tick no wrapper counter. Returns the
    flash launches of the compiled calls (warm-up and capture)."""
    import numpy as np

    from ray_tpu_torch.dag import compile_torch_pipeline
    from ray_tpu_torch.kernels.flash_attention import flash_attention
    from ray_tpu_torch.models.transformer import forward, forward_stages

    # a marker at each end of the chain reads the wrapper's counter each
    # time the chain's Python runs: at the warm-up and at the capture
    marks = []

    def mark(x):
        marks.append(flash_attention.launches)
        return x

    fused = compile_torch_pipeline([mark] + forward_stages(params, cfg) + [mark])
    rows, launches = {}, 0
    with torch.inference_mode():
        for n in DAG_LENGTHS:
            rng = np.random.default_rng(n)
            toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
                    for _ in range(2)]
            eager = [forward(params, t, cfg) for t in toks]
            del marks[:]
            before = flash_attention.launches
            got = [fused(t) for t in toks]
            first_calls = flash_attention.launches - before
            launches += first_calls
            captured = marks[3] - marks[2] if len(marks) == 4 else None
            replays = fused.replays
            before = flash_attention.launches
            replay_ms = cuda_ms(lambda: fused(toks[0]), iters=10, warmup=2)
            replay_ticks = flash_attention.launches - before
            replays = fused.replays - replays
            eager_ms = cuda_ms(lambda: forward(params, toks[0], cfg), iters=10, warmup=2)
            diffs = [(g.float() - e.float()).abs().max().item() for g, e in zip(got, eager)]
            rows[n] = dict(tokens=[1, n], bitwise_equal=[torch.equal(g, e) for g, e in zip(got, eager)],
                           max_abs_diff=diffs, first_calls_launches=first_calls,
                           captured_launches=captured, marks=list(marks),
                           capture_s=fused.capture_s[-1], replays_timed=replays,
                           replay_launch_ticks=replay_ticks, replay_ms=replay_ms,
                           eager_ms=eager_ms, replay_over_eager=replay_ms / eager_ms,
                           finite=bool(torch.isfinite(got[0]).all()))
            del eager, got
    log("dag_pipeline", config="LLAMA2_7B", stages=cfg.n_layers + 4, card=smi, lengths=rows,
        graphs=len(fused.capture_s), replays=fused.replays,
        tol="bitwise: torch.equal(graph logits, eager forward logits)")
    for n, row in rows.items():
        if not all(row["bitwise_equal"]) or not row["finite"]:
            raise AssertionError(f"dag_pipeline: S={n}: the graph's logits differ from eager "
                                 f"forward's by {row['max_abs_diff']}")
        if row["captured_launches"] != cfg.n_layers or row["first_calls_launches"] != 2 * cfg.n_layers:
            raise AssertionError(f"dag_pipeline: S={n}: {row['captured_launches']} flash launches "
                                 f"in the capture, {row['first_calls_launches']} in the first "
                                 f"calls; want {cfg.n_layers} and {2 * cfg.n_layers}")
        if row["replay_launch_ticks"] or row["replays_timed"] != 12:
            raise AssertionError(f"dag_pipeline: S={n}: replays ticked the wrapper "
                                 f"{row['replay_launch_ticks']} times in "
                                 f"{row['replays_timed']} replays")
    if len(fused.capture_s) != len(DAG_LENGTHS):
        raise AssertionError(f"dag_pipeline: {len(fused.capture_s)} captures for "
                             f"{len(DAG_LENGTHS)} signatures")
    del fused
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": launches}


def _step_logits(params, cfg, prompt, tokens):
    """Logits (float32, on the host) that chose ``tokens[i]`` after ``prompt``
    and ``tokens[:i]``, for every i, through the kernels."""
    from ray_tpu_torch.models.transformer import forward

    x = torch.tensor([prompt + tokens[:-1]], device="cuda")
    with torch.inference_mode():
        logits = forward(params, x, cfg)[0, len(prompt) - 1:]
    return logits.float().cpu()


class _LlamaActor:
    """An LLMServer replica serving Llama-2-7B at full width in a GPU actor's
    own process: the weights from the seed phase serve's came from."""

    def __init__(self, ecfg_fields: dict):
        t0 = time.perf_counter()
        from ray_tpu_torch.models.transformer import LLAMA2_7B
        from ray_tpu_torch.serve.llm.deployment import LLMServer
        from ray_tpu_torch.serve.llm.engine import EngineConfig

        self.cfg = LLAMA2_7B
        if not torch.cuda.is_available():
            raise RuntimeError("GPU actor: no CUDA device visible")
        self.server = LLMServer(self.cfg, EngineConfig(**ecfg_fields), deployment="llama2-7b-actor",
                                weight_seed=0, device="cuda")
        self.server.check_health()
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0

    def info(self) -> dict:
        import os

        import ray_tpu_torch

        return dict(pid=os.getpid(), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    device_count=torch.cuda.device_count(),
                    accelerator_ids=ray_tpu_torch.get_runtime_context().get_accelerator_ids(),
                    checksum=_params_checksum(self.server.engine.params),
                    build_s=self.build_s)

    def serve(self, prompts, solo, max_new) -> dict:
        return _serve_workload(self.server, prompts, solo, max_new)

    def first_token(self, prompt) -> tuple:
        stream = self.server.engine.submit(prompt, max_new_tokens=1)
        return stream.tokens(), stream.ttft_s * 1e3

    def step_logits(self, prompt, tokens):
        """The logits of each of the actor's steps (the divergence check)."""
        return _step_logits(self.server.engine.params, self.cfg, prompt, tokens)

    def stop(self) -> None:
        self.server.engine.shutdown()


class _Rank:
    """A CPU actor that joins a gloo group through the runtime's KV."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def join(self, key: str) -> tuple:
        import torch.distributed as dist

        from ray_tpu_torch._private.worker import get_runtime
        from ray_tpu_torch.parallel import distributed as D

        rt = get_runtime()
        addr = D.rendezvous_via_kv(rt, key, self.rank, self.world, timeout_s=120)
        D.initialize(addr, self.world, self.rank, device="cpu", timeout_s=120)
        t = torch.full((1024,), float(self.rank + 1))
        dist.all_reduce(t)
        if self.rank == 0:
            D.release_rendezvous(rt, key)
        D.shutdown()
        return addr, float(t.min()), float(t.max())


def _ppo_remote(device, runners: int, envs: int, steps: int):
    from ray_tpu_torch import rl

    return (rl.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=runners, num_envs_per_env_runner=envs,
                         rollout_fragment_length=steps)
            .debugging(seed=0).build(device=device))


def _timed_train(algo, iters: int) -> tuple:
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = algo.train()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return result, out


def phase_runtime_gpu(smi, ecfg, driver_serve: dict, rl_row: dict) -> dict:
    """The port's own core runtime on the card: ``init`` detects the GPU, a
    ``num_gpus=1`` actor serves Llama-2-7B through the kernels in its own
    process, a GPU task waits for the actor to give the card back, PPO samples
    from remote CPU runner actors (and heals after losing one), and two CPU
    actors form a gloo group through the runtime's KV."""
    import dataclasses
    import os

    import ray_tpu_torch
    from ray_tpu_torch._private.accelerators import nvidia_gpu
    from ray_tpu_torch.models.transformer import LLAMA2_7B

    if os.environ.get(nvidia_gpu.FAKE_GPUS_ENV):
        raise AssertionError(f"runtime_gpu: {nvidia_gpu.FAKE_GPUS_ENV} is set; the GPU count "
                             "must come from detection")
    row: dict = dict(card=smi)
    # what init waits for: the fork server imports the package (and torch)
    # in a fresh interpreter before it forks the first worker
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import ray_tpu_torch._private.worker_process"],
                   check=True, timeout=300)
    row["fresh_interpreter_import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ray_tpu_torch.init()
    try:
        row["init_ms"] = (time.perf_counter() - t0) * 1e3
        res = ray_tpu_torch.cluster_resources()
        row["cluster_resources"] = {k: v for k, v in res.items() if k in ("CPU", "GPU")}
        row["detection"] = dict(cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                                nvml=nvidia_gpu._nvml_count(),
                                detected=nvidia_gpu.detect_gpu_count(),
                                torch_device_count=torch.cuda.device_count())
        if res.get("GPU") != 1.0:
            raise AssertionError(f"runtime_gpu: cluster_resources()['GPU'] is {res.get('GPU')}, "
                                 f"want 1 ({row['detection']})")

        @ray_tpu_torch.remote
        def echo(x):
            return x

        @ray_tpu_torch.remote
        class Echo:
            def echo(self, x):
                return x

        ray_tpu_torch.get(echo.remote(0), timeout=120)
        a = Echo.remote()
        ray_tpu_torch.get(a.echo.remote(0), timeout=120)
        n = 50
        t0 = time.perf_counter()
        for i in range(n):
            ray_tpu_torch.get(echo.remote(i), timeout=60)
        row["task_round_trip_ms"] = (time.perf_counter() - t0) * 1e3 / n
        t0 = time.perf_counter()
        for i in range(n):
            ray_tpu_torch.get(a.echo.remote(i), timeout=60)
        row["actor_call_round_trip_ms"] = (time.perf_counter() - t0) * 1e3 / n
        ray_tpu_torch.kill(a)

        # the GPU actor: LLMServer at full width in its own process
        ecfg_fields = dataclasses.asdict(ecfg)
        t0 = time.perf_counter()
        actor = ray_tpu_torch.remote(num_gpus=1)(_LlamaActor).remote(ecfg_fields)
        info = ray_tpu_torch.get(actor.info.remote(), timeout=600)
        row["gpu_actor_start_s"] = time.perf_counter() - t0
        row["gpu_actor"] = info
        if info["cuda_visible_devices"] != "0" or info["device_count"] != 1:
            raise AssertionError(f"runtime_gpu: the actor sees CUDA_VISIBLE_DEVICES="
                                 f"{info['cuda_visible_devices']!r} and {info['device_count']} devices")
        if info["pid"] == os.getpid():
            raise AssertionError("runtime_gpu: the actor runs in the driver's process")
        if info["checksum"] != driver_serve["checksum"]:
            raise AssertionError(f"runtime_gpu: the actor's weights differ from phase serve's "
                                 f"({info['checksum']} vs {driver_serve['checksum']})")
        prompts = _runtime_prompts(LLAMA2_7B)
        served = ray_tpu_torch.get(actor.serve.remote(prompts, prompts[1], RUNTIME_NEW_TOKENS),
                                   timeout=600)
        # the actor hop: a one-token request timed at the driver against the
        # TTFT the actor's engine measured for it
        hops = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, ttft_in_actor = ray_tpu_torch.get(actor.first_token.remote(prompts[1]), timeout=120)
            hops.append(((time.perf_counter() - t0) * 1e3, ttft_in_actor))
        hop_ms = min(h[0] - h[1] for h in hops)
        row["actor_hop"] = dict(round_trip_ms=[h[0] for h in hops],
                                ttft_in_actor_ms=[h[1] for h in hops], hop_ms=hop_ms,
                                share_of_ttft=hop_ms / min(h[0] for h in hops))
        n_layers = LLAMA2_7B.n_layers
        counts = served["launches"]
        steps = counts["paged_attention"] / n_layers
        prof = served["solo_profiler_kernels"]
        prof_steps = prof["paged_decode_kernel"] / n_layers
        row["serving"] = dict(
            prompt_lengths=RUNTIME_PROMPT_LENGTHS, new_tokens=RUNTIME_NEW_TOKENS,
            actor={k: v for k, v in served.items() if k not in ("tokens", "solo_tokens")},
            driver={k: v for k, v in driver_serve.items()
                    if k not in ("tokens", "solo_tokens", "solo_step_logits")},
            actor_decode_steps=steps, actor_solo_profiled_decode_steps=prof_steps)
        if counts["flash_attention"] != len(prompts) * n_layers or steps != int(steps) \
                or steps < RUNTIME_NEW_TOKENS - 1:
            raise AssertionError(f"runtime_gpu: the actor's launch counts {counts} are not "
                                 f"{n_layers} per prefill and {n_layers} per decode step")
        if prof["flash_fwd_kernel"] != n_layers or prof_steps != int(prof_steps) \
                or prof_steps < RUNTIME_NEW_TOKENS - 1:
            raise AssertionError(f"runtime_gpu: the actor's profiler saw {prof}: not {n_layers} "
                                 f"flash kernels for the prefill and {n_layers} paged kernels "
                                 f"per decode step")
        if any(len(o) != RUNTIME_NEW_TOKENS for o in served["tokens"] + [served["solo_tokens"]]):
            raise AssertionError("runtime_gpu: the actor's streams ended short")
        got, want = served["solo_tokens"], driver_serve["solo_tokens"]
        diverge = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y), None)
        row["solo"] = dict(equal=diverge is None, first_divergent_token=diverge,
                           actor_tokens=got, driver_tokens=want)
        if diverge is not None:
            # a near-tie flipped: the actor's logits at that step must meet
            # phase_decode_check's rule against the driver's, which the driver
            # recorded before it dropped its model (both ran the same prefix)
            a_logits = ray_tpu_torch.get(actor.step_logits.remote(prompts[1], got), timeout=300)
            row["solo"]["divergent_step_rule"] = _logit_rule(
                "runtime_gpu divergent step", a_logits[diverge][None],
                driver_serve["solo_step_logits"][diverge][None])

        # a GPU task waits while the actor holds the card, and runs after the kill
        @ray_tpu_torch.remote(num_gpus=1)
        def visible():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        pending = visible.remote()
        ready, _ = ray_tpu_torch.wait([pending], num_returns=1, timeout=3.0)
        if ready:
            raise AssertionError("runtime_gpu: a num_gpus=1 task ran while the actor held the GPU")
        ray_tpu_torch.get(actor.stop.remote(), timeout=120)
        ray_tpu_torch.kill(actor)
        t0 = time.perf_counter()
        after = ray_tpu_torch.get(pending, timeout=300)
        row["pending_gpu_task"] = dict(ready_while_held=False, after_kill=after,
                                       ran_after_kill_s=time.perf_counter() - t0)
        if after != "0":
            raise AssertionError(f"runtime_gpu: the GPU task saw CUDA_VISIBLE_DEVICES={after!r}")

        # PPO: the learner on the card, two remote CPU runner actors
        algo = _ppo_remote("cuda", 2, 4, 32)
        result, secs = _timed_train(algo, 1)
        if result["num_env_steps_sampled_lifetime"] != 256:
            raise AssertionError(f"runtime_gpu: PPO sampled {result['num_env_steps_sampled_lifetime']}")
        _, more = _timed_train(algo, 3)
        secs += more
        ray_tpu_torch.kill(algo.runners.remote[0])
        result, after_kill = _timed_train(algo, 1)
        healthy_after_kill = algo.runners.num_healthy()
        restored = algo.runners.restore()
        healthy = algo.runners.num_healthy()
        lifetime = result["num_env_steps_sampled_lifetime"]
        algo.stop()
        local = _ppo_remote("cuda", 0, 8, 32)
        _, local_secs = _timed_train(local, 4)
        row["ppo_remote_runners"] = dict(
            config="PPOConfig(), 2 remote runners x 4 envs x 32 steps, seed 0; learner on the card",
            train_s=secs, env_steps_per_s=256 / (sum(secs[1:]) / len(secs[1:])),
            after_kill=dict(train_s=after_kill[0], lifetime_env_steps=lifetime,
                            healthy=healthy_after_kill, restored=restored, healthy_after_restore=healthy),
            local_runner_same_batch=dict(config="8 envs x 32 steps, num_env_runners=0",
                                         train_s=local_secs,
                                         env_steps_per_s=256 / (sum(local_secs[1:]) / 3)),
            phase_rl_local_env_steps_per_s=rl_row["env_steps_per_s"])
        if lifetime != 4 * 256 + 128 or healthy_after_kill != 1 or restored != 1 or healthy != 2:
            raise AssertionError(f"runtime_gpu: PPO's runner group did not heal: "
                                 f"{row['ppo_remote_runners']['after_kill']}")

        # two CPU actors meet through the KV and all-reduce over gloo
        rank_cls = ray_tpu_torch.remote(_Rank)
        t0 = time.perf_counter()
        members = [rank_cls.remote(r, 2) for r in range(2)]
        ranks = ray_tpu_torch.get([m.join.remote("runtime-gpu") for m in members], timeout=300)
        from ray_tpu_torch.parallel import distributed as D

        left = ray_tpu_torch._private.worker.get_runtime().rpc("kv_get", D._NAMESPACE,
                                                              b"runtime-gpu")
        row["rendezvous"] = dict(ranks=ranks, seconds=time.perf_counter() - t0,
                                 key_after_release=left)
        if ranks[0][0] != ranks[1][0] or any(tuple(r[1:]) != (3.0, 3.0) for r in ranks) \
                or left is not None:
            raise AssertionError(f"runtime_gpu: rendezvous/all-reduce failed: {row['rendezvous']}")
    finally:
        ray_tpu_torch.shutdown()
        log("runtime_gpu", **row)
    return counts


class _LlamaServer:
    """Phase serve_gpu's deployment class: ``LLMServer`` itself (the class
    ``llm_deployment`` binds, built from the same arguments), plus what the
    phase reads in the replica's own process: the kernels' launch counts,
    the weights' digest, the TTFT of the last request the engine took, and
    each step's logits for the divergence check. Made a subclass of
    ``LLMServer`` when the phase runs (``_server_class``)."""

    def __init__(self, *args, **kwargs):
        t0 = time.perf_counter()
        super().__init__(*args, **kwargs)
        submit = self.engine.submit

        def recording_submit(*a, **k):
            self._last_stream = submit(*a, **k)
            return self._last_stream

        self.engine.submit = recording_submit
        self._last_stream = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0

    def info(self) -> dict:
        import os

        import ray_tpu_torch

        return dict(pid=os.getpid(), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    device_count=torch.cuda.device_count(),
                    accelerator_ids=ray_tpu_torch.get_runtime_context().get_accelerator_ids(),
                    checksum=_params_checksum(self.engine.params), build_s=self.build_s,
                    jax_modules=sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")))

    def reset_launches(self) -> None:
        from ray_tpu_torch.kernels.flash_attention import flash_attention
        from ray_tpu_torch.kernels.paged_attention import paged_attention

        flash_attention.launches = paged_attention.launches = 0

    def launches(self) -> dict:
        from ray_tpu_torch.kernels.flash_attention import flash_attention
        from ray_tpu_torch.kernels.paged_attention import paged_attention

        return {k.__name__: k.launches for k in (flash_attention, paged_attention)}

    def last_ttft_ms(self) -> float:
        return self._last_stream.ttft_s * 1e3

    def step_logits(self, prompt, tokens):
        return _step_logits(self.engine.params, self.engine.model_cfg, prompt, tokens)


def _server_class():
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    return type("LlamaServer", (_LlamaServer, LLMServer), {"__module__": __name__})


def _stream_requests(handle, prompts, max_new) -> dict:
    """The prompts through a streaming handle at once, one thread each:
    tokens, the wall time of the whole batch and each request's first-item
    time at the driver."""
    import threading

    outs, firsts, errors = [None] * len(prompts), [None] * len(prompts), []
    t0 = time.perf_counter()

    def run(i):
        try:
            toks = []
            for tok in handle.options(stream=True).generate.remote(prompts[i], max_new_tokens=max_new):
                if not toks:
                    firsts[i] = (time.perf_counter() - t0) * 1e3
                toks.append(tok)
            outs[i] = toks
        except Exception as e:  # noqa: BLE001 — raised below with the others
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(o is None for o in outs):
        raise AssertionError(f"serve_gpu: streams failed: {errors or 'a stream hung'}")
    return dict(tokens=outs, wall_s=wall, tokens_per_s=sum(len(o) for o in outs) / wall,
                first_item_ms=firsts)


def _http_post(address, path, payload) -> tuple:
    import urllib.request

    host, port = address
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body["result"], (time.perf_counter() - t0) * 1e3


def phase_serve_gpu(smi, ecfg, driver_serve: dict, model_cfg=None, device: str = "cuda") -> dict:
    """The serve library on the card: ``serve.run(llm_deployment(...))`` puts
    Llama-2-7B (phase serve's weight seed) in a ``num_gpus=1`` replica; phase
    runtime_gpu's three prompts go through a streaming handle and the
    700-token prompt alone over HTTP through the proxy; in the replica's own
    process the wrappers count 32 flash launches per prefill and 32 paged
    launches per decode step; the solo tokens equal the driver's (or the
    divergent step meets ``_logit_rule``); after ``serve.delete`` a pending
    ``num_gpus=1`` task gets the card. Checks are gathered and raised at the
    end, after the row is printed."""
    import dataclasses
    import os

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models.transformer import LLAMA2_7B
    from ray_tpu_torch.serve._proxy import _PROXY_NAME, HTTPProxy
    from ray_tpu_torch.serve.api import Deployment
    from ray_tpu_torch.serve.llm import llm_deployment
    from ray_tpu_torch.util.metrics import prometheus_text

    cfg = model_cfg or LLAMA2_7B
    row: dict = dict(card=smi)
    failed: list = []
    t_phase = t0 = time.perf_counter()
    ray_tpu_torch.init()
    row["init_ms"] = (time.perf_counter() - t0) * 1e3
    try:
        # the proxy on an ephemeral port, made before serve.run adds the route
        proxy = HTTPProxy.options(name=_PROXY_NAME, num_cpus=0).remote(0)
        address = tuple(ray_tpu_torch.get(proxy.address.remote(), timeout=120))
        # llm_deployment's application, its class swapped for the probe with
        # every option and argument kept
        # (weights from seed 0, phase serve's)
        app = llm_deployment(cfg, dataclasses.asdict(ecfg), deployment_name="llama2-7b",
                             device=device, ray_actor_options={"num_gpus": 1})
        dep = app.deployment
        app = Deployment(_server_class(), **{k: getattr(dep, k) for k in Deployment._OPTION_KEYS}
                         ).bind(*app.args, **app.kwargs)
        t0 = time.perf_counter()
        handle = serve.run(app, name="llm", route_prefix="/llm")
        row["replica_start_s"] = time.perf_counter() - t0
        info = handle.info.remote().result(timeout_s=120)
        row["replica"] = info
        if info["cuda_visible_devices"] != "0" or info["device_count"] != 1:
            failed.append(f"the replica sees CUDA_VISIBLE_DEVICES={info['cuda_visible_devices']!r} "
                          f"and {info['device_count']} devices")
        if info["pid"] == os.getpid() or info["jax_modules"]:
            failed.append(f"the replica runs in the driver or imported {info['jax_modules']}")
        if info["checksum"] != driver_serve["checksum"]:
            failed.append("the replica's weights differ from phase serve's")

        prompts = _runtime_prompts(cfg)
        _stream_requests(handle, prompts, RUNTIME_NEW_TOKENS)  # warm-up, untimed
        handle.reset_launches.remote().result(timeout_s=60)
        together = _stream_requests(handle, prompts, RUNTIME_NEW_TOKENS)
        counts = handle.launches.remote().result(timeout_s=60)
        handle.reset_launches.remote().result(timeout_s=60)
        solo = _stream_requests(handle, [prompts[1]], RUNTIME_NEW_TOKENS)
        solo_counts = handle.launches.remote().result(timeout_s=60)
        http_tokens, http_ms = _http_post(address, "/llm", {"prompt": prompts[1],
                                                            "max_new_tokens": RUNTIME_NEW_TOKENS})
        # the HTTP hop: a one-token request's round trip at the driver against
        # the TTFT the replica's engine measured for it
        hops = []
        for _ in range(3):
            _, rt_ms = _http_post(address, "/llm", {"prompt": prompts[1], "max_new_tokens": 1})
            hops.append((rt_ms, handle.last_ttft_ms.remote().result(timeout_s=60)))
        hop_ms = min(h[0] - h[1] for h in hops)
        row["http_hop"] = dict(round_trip_ms=[h[0] for h in hops],
                               ttft_in_replica_ms=[h[1] for h in hops], hop_ms=hop_ms,
                               share_of_ttft=hop_ms / min(h[0] for h in hops))
        n_layers = cfg.n_layers
        steps = counts["paged_attention"] / n_layers
        solo_steps = solo_counts["paged_attention"] / n_layers
        row["serving"] = dict(
            prompt_lengths=RUNTIME_PROMPT_LENGTHS, new_tokens=RUNTIME_NEW_TOKENS,
            handle={k: v for k, v in together.items() if k != "tokens"},
            handle_solo={k: v for k, v in solo.items() if k != "tokens"},
            http_solo_ms=http_ms, launches=counts, solo_launches=solo_counts,
            decode_steps=steps, solo_decode_steps=solo_steps,
            driver_engine=dict(tokens_per_s=driver_serve["tokens_per_s"],
                               ttft_ms=driver_serve["ttft_ms"],
                               solo_wall_s=driver_serve["solo_wall_s"]))
        if counts["flash_attention"] != len(prompts) * n_layers or steps != int(steps) \
                or steps < RUNTIME_NEW_TOKENS - 1 or solo_counts["flash_attention"] != n_layers \
                or solo_steps != RUNTIME_NEW_TOKENS - 1:
            failed.append(f"launch counts {counts} / solo {solo_counts} are not {n_layers} per "
                          f"prefill and {n_layers} per decode step")
        if any(len(o) != RUNTIME_NEW_TOKENS for o in together["tokens"] + solo["tokens"]):
            failed.append("a stream ended short")
        got, want = solo["tokens"][0], driver_serve["solo_tokens"]
        diverge = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y), None)
        row["solo"] = dict(equal=diverge is None, first_divergent_token=diverge,
                           replica_tokens=got, driver_tokens=want,
                           http_equal_stream=http_tokens == got,
                           together_equal_solo=together["tokens"][1] == got)
        if http_tokens != got:
            failed.append("the HTTP request's tokens differ from the streamed solo request's")
        if diverge is not None:
            logits = handle.step_logits.remote(prompts[1], got).result(timeout_s=300)
            try:
                row["solo"]["divergent_step_rule"] = _logit_rule(
                    "serve_gpu divergent step", logits[diverge][None],
                    driver_serve["solo_step_logits"][diverge][None])
            except AssertionError as e:
                failed.append(str(e))
        text = prometheus_text()
        row["series"] = {
            line.split(" ")[0]: float(line.split(" ")[1]) for line in text.splitlines()
            if line.startswith(("ray_tpu_torch_llm_", "ray_tpu_torch_serve_ttft_ms"))
            and "_bucket{" not in line and float(line.split(" ")[1]) != 0.0}
        row["status_ttft"] = serve.status()["llm"]["llama2-7b"]["ttft"]
        for prefix in ("ray_tpu_torch_llm_tokens_total", "ray_tpu_torch_llm_decode_step_ms",
                       "ray_tpu_torch_serve_ttft_ms"):
            if not any(k.startswith(prefix) for k in row["series"]):
                failed.append(f"no non-zero {prefix} series")

        # the handover: a GPU task waits while the replica holds the card and
        # runs once serve.delete has drained and killed it
        @ray_tpu_torch.remote(num_gpus=1)
        def visible():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        pending = visible.remote()
        ready, _ = ray_tpu_torch.wait([pending], num_returns=1, timeout=3.0)
        t0 = time.perf_counter()
        serve.delete("llm")
        after = ray_tpu_torch.get(pending, timeout=300)
        row["pending_gpu_task"] = dict(ready_while_held=bool(ready), after_delete=after,
                                       ran_after_delete_s=time.perf_counter() - t0)
        if ready or after != "0":
            failed.append(f"the GPU task ran while the replica held the card ({bool(ready)}) or "
                          f"saw CUDA_VISIBLE_DEVICES={after!r}")
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        row["seconds"] = time.perf_counter() - t_phase
        log("serve_gpu", **row)
    if failed:
        raise AssertionError("serve_gpu: " + "; ".join(failed))
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)
    from ray_tpu_torch.models.transformer import LLAMA2_7B, init_params
    from ray_tpu_torch.serve.llm.engine import EngineConfig

    # fp32 results are compared below: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_card()
    phase_build()
    phase_sass()
    flash_rows, paged_rows = phase_kernels()

    cfg = LLAMA2_7B
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    log("weights", config="LLAMA2_7B", params=cfg.num_params(), seconds=time.perf_counter() - t0,
        gib=sum(p.numel() * p.element_size() for p in params.values()) / 2**30)
    with torch.inference_mode():
        phase_forward(params, cfg)
    ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8, max_blocks_per_seq=256)
    phase_decode_check(params, cfg, ecfg)
    torch.cuda.empty_cache()
    prompts, outs, counts, serve_row = phase_serve(params, cfg, ecfg)
    with torch.inference_mode():
        phase_first_tokens(params, cfg, prompts, outs)
    dense_counts = phase_dense_generate(params, cfg, serve_row)
    runtime_driver = phase_runtime_driver_serve(params, cfg, ecfg)
    dag_counts = phase_dag_pipeline(params, cfg, smi)
    log("serve_total", seconds=time.perf_counter() - t_start,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    # the later phases need the card's memory: drop the serving model
    del params
    gc.collect()
    torch.cuda.empty_cache()
    vit_counts = phase_vit(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_small_models()
    from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from ray_tpu_torch.kernels.paged_attention import paged_attention

    for kern in (flash_attention, flash_attention_backward, paged_attention):
        kern.launches = 0
    rl_row = phase_rl(smi)
    rl_counts = {kern.__name__: kern.launches
                 for kern in (flash_attention, flash_attention_backward, paged_attention)}
    # the runtime's GPU actor serves the model the driver has dropped
    gc.collect()
    torch.cuda.empty_cache()
    runtime_counts = phase_runtime_gpu(smi, ecfg, runtime_driver, rl_row)
    serve_gpu_counts = phase_serve_gpu(smi, ecfg, runtime_driver)
    bwd_rows = phase_kernels_bwd()
    ring_counts, _ = phase_ring_schedule()
    phase_train_check()
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train_row = phase_train(smi)
    # the single-device state is gone with phase_train's frame
    gc.collect()
    torch.cuda.empty_cache()
    lib_counts = phase_train_lib(smi, train_row, vit_counts["forward_images_per_s"])
    gc.collect()
    torch.cuda.empty_cache()
    mesh1_counts = phase_spmd_mesh1(smi, train_row)
    gc.collect()
    torch.cuda.empty_cache()
    tensor2_counts = phase_spmd_tensor2(smi)
    log("total", seconds=time.perf_counter() - t_start)

    def entry(name, source, row, launches, by_path):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "ray_tpu/ops/attention.py:124" if name.startswith("flash")
                else "ray_tpu/models/generation.py:187",
                "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "vs_library": row["vs_library"], "launches_by_path": by_path}

    print(smi)
    # launches: the serving run for the serving kernels, the training run
    # for the backward; each path's own run beside them
    print(json.dumps({"kernels": [
        entry("flash_attention", "ray_tpu_torch/csrc/flash_attention.cu", flash_rows[0],
              counts["flash_attention"],
              {"serve": counts["flash_attention"],
               "dense_generate": dense_counts["flash_attention"],
               "vit_forward": vit_counts["forward"]["flash_attention"],
               "vit_sgd_steps": vit_counts["sgd_steps"]["flash_attention"],
               "train": train_counts["flash_attention"], "rl": rl_counts["flash_attention"],
               "ring_schedule": ring_counts["flash_attention"],
               "spmd_mesh1": mesh1_counts["flash_attention"],
               "spmd_tensor2": tensor2_counts["flash_attention"],
               "runtime_gpu_actor": runtime_counts["flash_attention"],
               "serve_gpu_replica": serve_gpu_counts["flash_attention"],
               "train_gpu_worker": lib_counts["train_gpu_worker"][0],
               "train_restart": lib_counts["train_restart"][0],
               "data_train_gpu": lib_counts["data_train_gpu"][0],
               "data_feed_vit": lib_counts["data_feed_vit"],
               "dag_pipeline": dag_counts["flash_attention"]}),
        entry("paged_attention", "ray_tpu_torch/csrc/paged_attention.cu", paged_rows[0],
              counts["paged_attention"],
              {"serve": counts["paged_attention"],
               "dense_generate": dense_counts["paged_attention"],
               "rl": rl_counts["paged_attention"],
               "spmd_mesh1": mesh1_counts["paged_attention"],
               "runtime_gpu_actor": runtime_counts["paged_attention"],
               "serve_gpu_replica": serve_gpu_counts["paged_attention"]}),
        entry("flash_attention_bwd", "ray_tpu_torch/csrc/flash_attention_bwd.cu", bwd_rows[0],
              train_counts["flash_attention_backward"],
              {"train": train_counts["flash_attention_backward"],
               "vit_gradient": vit_counts["gradient"]["flash_attention_backward"],
               "vit_sgd_steps": vit_counts["sgd_steps"]["flash_attention_backward"],
               "rl": rl_counts["flash_attention_backward"],
               "ring_schedule": ring_counts["flash_attention_backward"],
               "spmd_mesh1": mesh1_counts["flash_attention_backward"],
               "spmd_tensor2": tensor2_counts["flash_attention_backward"],
               "train_gpu_worker": lib_counts["train_gpu_worker"][1],
               "train_restart": lib_counts["train_restart"][1],
               "data_train_gpu": lib_counts["data_train_gpu"][1]}),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
