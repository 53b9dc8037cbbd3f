"""The port's paged decode path (``models/generation.py``) against the JAX
package's ``make_paged_fns``, with the same weights and block tables.

fp32 configs; logits at 1e-4 absolute and relative (the same fp32
arithmetic in another order), greedy tokens identical.
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
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
CFG = JT.TransformerConfig(
    vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
    max_seq_len=128, dtype=jnp.float32, remat=False,
)
PCFG = PT.TransformerConfig(
    **{f.name: getattr(CFG, f.name) for f in dataclasses.fields(JT.TransformerConfig)
       if f.name != "dtype"},
    dtype=torch.float32,
)
BS, NB, MB = 4, 40, 8


@pytest.fixture(scope="module")
def weights():
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), CFG))
    rs = np.random.RandomState(0)
    jp = {
        k: (1.0 + 0.1 * rs.randn(*s.shape) if "norm" in k else 0.2 * rs.randn(*s.shape))
        .astype(np.float32)
        for k, s in sorted(shapes.items())
    }
    return jp, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def jax_fns():
    return JG.make_paged_fns(CFG, block_size=BS)


def _tables(lengths, extra=6, seed=0):
    """Shuffled block tables with room for ``extra`` decoded tokens."""
    perm = np.random.RandomState(seed).permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((len(lengths), MB), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        need = -(-(n + extra) // BS)
        tables[i, :need] = perm[off:off + need]
        off += need
    return tables


def test_init_paged_pool_stores_cfg_dtype():
    pool = PG.init_paged_pool(PCFG, NB, BS, device="cpu")
    assert pool["k"].shape == (CFG.n_layers, NB * BS, CFG.kv_heads, CFG.head_dim)
    assert pool["k"].dtype == pool["v"].dtype == torch.float32
    bf = PG.init_paged_pool(dataclasses.replace(PCFG, dtype=torch.bfloat16), 2, BS, device="cpu")
    assert bf["v"].dtype == torch.bfloat16  # no raw-bits storage in the port


def test_prefill_and_greedy_decode_match_jax(weights, jax_fns):
    """Padded prefill of three prompts, then six continuous-batched decode
    steps with one inactive slot: the same logits and greedy tokens."""
    jp, tp = weights
    jpre, jdec, jgreedy = jax_fns
    ppre, pdec, pgreedy = PG.make_paged_fns(PCFG, block_size=BS)
    lengths = [5, 11, 3]
    tables = _tables(lengths)
    jpool = JG.init_paged_pool(CFG, NB, BS)
    ppool = PG.init_paged_pool(PCFG, NB, BS, device="cpu")
    rs = np.random.RandomState(1)
    jtok, ptok = [], []
    for i, n in enumerate(lengths):
        toks = np.zeros((1, 16), np.int32)  # padded to a bucket
        toks[0, :n] = rs.randint(1, CFG.vocab_size, n)
        jl, jpool = jpre(jp, jnp.asarray(toks), jnp.asarray(tables[i:i + 1]), jpool,
                         jnp.int32(n))
        pl, ppool = ppre(tp, torch.from_numpy(toks), torch.from_numpy(tables[i:i + 1]), ppool, n)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **F32)
        jtok.append(int(np.asarray(jl).argmax()))
        ptok.append(int(pl.argmax()))
    assert jtok == ptok
    # slot 3 is inactive: token 0, position 0, null table
    tokens = np.array(jtok + [0], np.int32)
    positions = np.array(lengths + [0], np.int32)
    btabs = np.concatenate([tables, np.zeros((1, MB), np.int32)])
    active = np.array([True, True, True, False])
    for _ in range(6):
        jl, jpool = jdec(jp, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(btabs),
                         jpool, jnp.asarray(active))
        args = [torch.from_numpy(x) for x in (tokens, positions, btabs)]
        pl, ppool = pdec(tp, *args, ppool, torch.from_numpy(active))
        np.testing.assert_allclose(pl.numpy()[:3], np.asarray(jl)[:3], **F32)
        assert np.isfinite(pl.numpy()).all()
        greedy, _ = pgreedy(tp, *args, ppool, torch.from_numpy(active))
        assert greedy.dtype == torch.int32
        assert greedy.tolist() == pl.argmax(-1).tolist()
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert (nxt[:3] == greedy.numpy()[:3]).all()
        tokens = np.where(active, nxt, 0).astype(np.int32)
        positions = positions + active
    # the paged pool holds the same cache rows on both sides
    for i, n in enumerate(lengths):
        slots = (tables[i, :, None] * BS + np.arange(BS)).reshape(-1)[: n + 6]
        np.testing.assert_allclose(
            ppool["k"].numpy()[:, slots], np.asarray(jpool["k"])[:, slots], **F32
        )


def test_prefill_through_flash_matches_jax_forward_last_row(weights):
    """Prefill attends the bucket's own q/k/v (the flash path); its last
    real row equals JAX's full forward at length-1."""
    jp, tp = weights
    ppre, _, _ = PG.make_paged_fns(PCFG, block_size=BS)
    n = 13
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = np.random.RandomState(2).randint(1, CFG.vocab_size, n)
    ref = np.asarray(jax.jit(JT.forward, static_argnums=2)(jp, jnp.asarray(toks[:, :n]), CFG))[0, n - 1]
    ppool = PG.init_paged_pool(PCFG, NB, BS, device="cpu")
    pl, _ = ppre(tp, torch.from_numpy(toks), torch.from_numpy(_tables([n])), ppool, n)
    np.testing.assert_allclose(pl.numpy()[0], ref, **F32)


def test_padded_rows_write_only_the_null_block(weights):
    _, tp = weights
    ppre, _, _ = PG.make_paged_fns(PCFG, block_size=BS)
    pool = PG.init_paged_pool(PCFG, NB, BS, device="cpu")
    n = 6
    table = _tables([n], extra=0)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :n] = np.arange(1, n + 1)
    _, pool = ppre(tp, torch.from_numpy(toks), torch.from_numpy(table), pool, n)
    written = (pool["k"].abs().sum(dim=(0, 2, 3)) != 0).nonzero().flatten().tolist()
    own = set((table[0, :, None] * BS + np.arange(BS)).reshape(-1)[:n].tolist())
    assert set(written) - set(range(BS)) == own  # the rest went to null block 0


def test_sample_token_top_k_masks_tail():
    """top_k=1 sampling degenerates to argmax for any generator."""
    logits = torch.from_numpy(np.random.RandomState(0).randn(4, 33).astype(np.float32))
    for i in range(3):
        tok = PG.sample_token(logits, temperature=1.0, top_k=1, key=PG.sequence_key(i, 0))
        assert tok.tolist() == logits.argmax(-1).tolist()
    assert PG.sample_token(logits).tolist() == logits.argmax(-1).tolist()
    with pytest.raises(ValueError):
        PG.sample_token(logits, temperature=1.0)


def test_sequence_key_depends_only_on_seed_and_step():
    logits = torch.zeros(1000)  # uniform: samples are the generator's alone
    draw = lambda seed, step: int(  # noqa: E731
        PG.sample_token(logits, temperature=1.0, key=PG.sequence_key(seed, step))
    )
    assert draw(7, 3) == draw(7, 3)
    assert len({draw(7, s) for s in range(8)}) > 1
    assert len({draw(s, 3) for s in range(8)}) > 1
