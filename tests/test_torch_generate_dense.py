"""The port's dense-cache decoding (``init_kv_cache``, ``make_decode_fns``,
``generate``) against the JAX package's, on the CPU, with the JAX weights
carried over.

fp32 (the config of ``test_kv_cache_generation_matches_full_forward``, GQA
4/2): greedy tokens equal JAX's, and prefill and every decode step's logits
match within 1e-4 absolute and relative (the same fp32 arithmetic in another
order), through both the kernel route (on the CPU the paged wrapper's plain
version) and the plain ``_cached_attention``. bf16 (TINY): the logits are
held to ``test_torch_transformer``'s bf16 rule.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import generation as JG  # noqa: E402
from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu_torch.models import generation as PG  # noqa: E402
from test_torch_transformer import carried, port_cfg  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)

CFG = JT.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=64, remat=False, dtype=jnp.float32,
)
PROMPT = np.array([[5, 9, 3, 7, 2], [1, 2, 3, 4, 6]], dtype=np.int32)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_greedy_generate_matches_jax(use_kernels):
    jp, tp = carried(CFG, seed=1)
    pcfg = port_cfg(CFG)
    want = np.asarray(JG.generate(jp, PROMPT, CFG, max_new_tokens=5))
    fns = PG.make_decode_fns(pcfg, PROMPT.shape[1] + 5, use_kernels=use_kernels)
    got = PG.generate(tp, PROMPT, pcfg, max_new_tokens=5, fns=fns)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_logits_match_jax(use_kernels):
    """Teacher-forced: the same tokens go into both packages' steps."""
    jp, tp = carried(CFG, seed=2)
    pcfg = port_cfg(CFG)
    max_len = PROMPT.shape[1] + 4
    jprefill, jdecode = JG.make_decode_fns(CFG, max_len)
    prefill, decode = PG.make_decode_fns(pcfg, max_len, use_kernels=use_kernels)
    jcache = JG.init_kv_cache(CFG, 2, max_len)
    cache = PG.init_kv_cache(pcfg, 2, max_len, device="cpu")
    k_storage = cache["k"].data_ptr()
    ref, jcache = jprefill(jp, jnp.asarray(PROMPT), jcache)
    out, cache = prefill(tp, torch.from_numpy(PROMPT), cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert int(cache["pos"]) == PROMPT.shape[1]
    feed = np.random.RandomState(3).randint(0, CFG.vocab_size, size=(4, 2, 1)).astype(np.int32)
    for step, tok in enumerate(feed):
        ref, jcache = jdecode(jp, jnp.asarray(tok), jcache)
        out, cache = decode(tp, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32, err_msg=f"step {step}")
    assert int(cache["pos"]) == max_len
    # the cache is updated in place, as the reference donates it
    assert cache["k"].data_ptr() == k_storage
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **F32)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), **F32)


def test_bf16_logits_within_rounding_noise_of_jax():
    """TINY in bf16, prefill and two teacher-forced decode steps: the port
    is closer to JAX than half the floor (JAX's mean distance from an fp32
    run of the same weights) and no further from fp32 than 1.25 times JAX
    is (``test_torch_transformer``'s bf16 rule)."""
    cfg = JT.TINY
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    jp, tp = carried(cfg, seed=4)
    jp32 = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    feed = np.random.RandomState(6).randint(0, cfg.vocab_size, size=(2, 2, 1)).astype(np.int32)
    max_len = prompt.shape[1] + len(feed)

    def jax_steps(params, c):
        prefill, decode = JG.make_decode_fns(c, max_len)
        logits, cache = prefill(params, jnp.asarray(prompt), JG.init_kv_cache(c, 2, max_len))
        out = [np.asarray(logits, np.float32)]
        for tok in feed:
            logits, cache = decode(params, jnp.asarray(tok), cache)
            out.append(np.asarray(logits, np.float32))
        return np.stack(out)

    ref, exact = jax_steps(jp, cfg), jax_steps(jp32, cfg32)
    pcfg = port_cfg(cfg)
    assert pcfg.dtype == torch.bfloat16
    prefill, decode = PG.make_decode_fns(pcfg, max_len)
    logits, cache = prefill(tp, torch.from_numpy(prompt), PG.init_kv_cache(pcfg, 2, max_len,
                                                                         device="cpu"))
    assert cache["k"].dtype == torch.bfloat16
    out = [logits.numpy()]
    for tok in feed:
        logits, cache = decode(tp, torch.from_numpy(tok), cache)
        out.append(logits.numpy())
    out = np.stack(out)
    floor = np.abs(ref - exact).mean()
    assert np.abs(out - ref).mean() <= 0.5 * floor
    assert np.abs(out - exact).mean() <= 1.25 * floor


def test_generate_raises_past_max_seq_len():
    _, tp = carried(CFG)
    pcfg = port_cfg(CFG)
    prompt = np.ones((1, 60), np.int32)
    with pytest.raises(ValueError, match="max_seq_len"):
        PG.generate(tp, prompt, pcfg, max_new_tokens=5)
    assert PG.generate(tp, prompt, pcfg, max_new_tokens=4).shape == (1, 4)


def test_generate_top_k_sampling():
    """The cases of ``test_llm_engine.test_generate_top_k_sampling``: top_k
    leaves greedy decoding alone, and the same seeded generator reproduces
    its sample (``generate`` does not advance it); top_k=1 sampling is
    greedy."""
    _, tp = carried(CFG, seed=7)
    pcfg = port_cfg(CFG)
    prompt = np.random.RandomState(10).randint(1, CFG.vocab_size, size=9).astype(np.int32)
    g1 = PG.generate(tp, prompt, pcfg, max_new_tokens=6)
    g2 = PG.generate(tp, prompt, pcfg, max_new_tokens=6, top_k=4)
    assert torch.equal(g1, g2), "top_k must not perturb greedy decode"
    key = torch.Generator().manual_seed(1)
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=3, key=key)
    s1 = PG.generate(tp, prompt, pcfg, **kw)
    s2 = PG.generate(tp, prompt, pcfg, **kw)
    assert torch.equal(s1, s2), "same generator must reproduce the same sample"
    s3 = PG.generate(tp, prompt, pcfg, **dict(kw, key=torch.Generator().manual_seed(1)))
    assert torch.equal(s1, s3), "same seed must reproduce the same sample"
    one = PG.generate(tp, prompt, pcfg, max_new_tokens=6, temperature=0.8, top_k=1, key=key)
    assert torch.equal(one, g1)
