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
plain version, gradients of a 4-layer GPT-J through flash against plain and
fp32, and ``build_lm_train_step`` training GPT-J-6B at full width and depth
for 5 AdamW steps on one fixed batch.
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
    return {"forward": fwd_launches, "gradient": bwd_launches, "sgd_steps": step_launches}


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


def phase_rl(smi) -> None:
    """The RL library: every learner update on the card against the CPU,
    PPO learning CartPole at the reference's configuration, and two
    training steps of each other algorithm."""
    batches = _rl_batches()
    dataset = _ArrayDataset(batches["offline"])
    t0 = time.perf_counter()
    updates = _rl_update_checks(dataset, batches)
    log("rl_updates", card=smi, tol=f"|card - cpu| <= {RL_ATOL} + {RL_RTOL} * |cpu|",
        seconds=time.perf_counter() - t0, cases=updates)
    _rl_ppo_learns(smi)
    t0 = time.perf_counter()
    two = _rl_two_steps(dataset)
    log("rl_two_steps", seconds=time.perf_counter() - t0, algorithms=two)


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
    phase_rl(smi)
    rl_counts = {kern.__name__: kern.launches
                 for kern in (flash_attention, flash_attention_backward, paged_attention)}
    bwd_rows = phase_kernels_bwd()
    phase_train_check()
    gc.collect()
    torch.cuda.empty_cache()
    train_counts = phase_train(smi)
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
               "train": train_counts["flash_attention"], "rl": rl_counts["flash_attention"]}),
        entry("paged_attention", "ray_tpu_torch/csrc/paged_attention.cu", paged_rows[0],
              counts["paged_attention"],
              {"serve": counts["paged_attention"],
               "dense_generate": dense_counts["paged_attention"],
               "rl": rl_counts["paged_attention"]}),
        entry("flash_attention_bwd", "ray_tpu_torch/csrc/flash_attention_bwd.cu", bwd_rows[0],
              train_counts["flash_attention_backward"],
              {"train": train_counts["flash_attention_backward"],
               "vit_gradient": vit_counts["gradient"]["flash_attention_backward"],
               "vit_sgd_steps": vit_counts["sgd_steps"]["flash_attention_backward"],
               "rl": rl_counts["flash_attention_backward"]}),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
