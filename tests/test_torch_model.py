"""The port's model against the JAX package's on the same parameters:
`reduced(qwen2-7b)` initialized by JAX, carried over with
`convert.params_from_jax`, then prefill and ragged per-slot decode logits
and the written KV caches compared (f32; sums run in another order, so
atol 1e-4). Also the shared model utilities and the configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import common as jcommon
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import RGLRUSpec, get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models.transformer import build_model

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """One JAX model + params for the module, and its port twin."""
    jcfg = jreduced(jget_arch("qwen2-7b"))
    jmodel = jbuild_model(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # nonzero norms and biases, so the port's (1 + w) and bias paths count
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(
            rng.normal(size=a.shape) * 0.05, a.dtype)
        if getattr(path[-1], "key", "") in ("w", "bq", "bk", "bv") else a,
        jparams,
    )
    tcfg = reduced(get_arch("qwen2-7b"))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg, device="cpu"), tparams


def test_configs_match_reference():
    for arch in ("qwen2-7b", "mamba2-780m"):
        for conv in (lambda c: c, None):
            j, t = jget_arch(arch), get_arch(arch)
            if conv is None:
                j, t = jreduced(j), reduced(t)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert j.padded_vocab() == t.padded_vocab()
            assert j.n_params() == t.n_params()
    full = get_arch("qwen2-7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.padded_vocab()) == (
        28, 3584, 28, 4, 128, 18944, 152064)


def test_converted_layout(models):
    jcfg, _, jparams, tcfg, _, tparams = models
    assert len(tparams["layers"]) == tcfg.n_layers
    np.testing.assert_array_equal(
        tparams["layers"][1]["mixer"]["wq"].numpy(),
        np.asarray(jparams["layers"][0]["mixer"]["wq"][1]))
    assert tparams["lm_head"].shape == (tcfg.d_model, tcfg.padded_vocab())


def test_prefill_and_slot_decode_match_jax(models):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    rng = np.random.default_rng(1)
    slots, max_len, s = 3, 24, 8
    toks = rng.integers(1, tcfg.vocab_size, size=(slots, s)).astype(np.int32)

    # prefill every slot (batch 1 each, as the engine does), then decode
    # all slots at ragged positions
    jcache = jmodel.init_slot_cache(slots, max_len, jnp.float32)
    tcache = tmodel.init_slot_cache(slots, max_len, torch.float32)
    for b in range(slots):
        jl, jc1 = jmodel.prefill(jparams, jnp.asarray(toks[b:b + 1]),
                                 jmodel.init_cache(1, max_len, jnp.float32))
        tc1 = tmodel.init_cache(1, max_len, torch.float32)
        tl, tc1 = tmodel.prefill(tparams, torch.from_numpy(toks[b:b + 1]).long(),
                                 tc1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        jcache = jax.tree.map(lambda full, one: full.at[b].set(one), jcache, jc1)
        for name in ("k", "v"):
            tcache[name][:, b] = tc1[name][:, 0]

    pos = np.array([s, s - 3, s + 2], np.int32)    # ragged write positions
    cur = rng.integers(1, tcfg.vocab_size, size=slots).astype(np.int32)
    for step in range(3):
        jl, jcache = jmodel.decode_slots(jparams, jcache, jnp.asarray(cur),
                                         jnp.asarray(pos))
        tl, tcache = tmodel.decode_slots(tparams, tcache,
                                         torch.from_numpy(cur),
                                         torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        cur = np.array(jnp.argmax(jl[:, :tcfg.vocab_size], -1), np.int32)
        pos = pos + 1
    # JAX slot cache leaves: (slots, n_cyc, 1, T, kvh, hd); port: (L, slots, T, kvh, hd)
    jk = np.asarray(jcache["layers"][0]["k"])[:, :, 0].transpose(1, 0, 2, 3, 4)
    np.testing.assert_allclose(tcache["k"].numpy(), jk, atol=ATOL)


def test_batched_prefill_and_decode_step_match_jax(models):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    rng = np.random.default_rng(2)
    toks = rng.integers(1, tcfg.vocab_size, size=(2, 6)).astype(np.int32)
    jc = jmodel.init_cache(2, 16, jnp.float32)
    tc = tmodel.init_cache(2, 16, torch.float32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), jc)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    nxt = rng.integers(1, tcfg.vocab_size, size=(2, 1)).astype(np.int32)
    jl, _ = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), jnp.int32(6))
    tl, _ = tmodel.decode_step(tparams, tc, torch.from_numpy(nxt).long(), 6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_common_functions_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for plus_one in (False, True):
        np.testing.assert_allclose(
            tcommon.rms_norm(tx, tw, 1e-6, plus_one=plus_one).numpy(),
            np.asarray(jcommon.rms_norm(x, w, 1e-6, plus_one=plus_one)),
            atol=1e-6)
    for positions in (np.arange(5), rng.integers(0, 90, size=(2, 5))):
        np.testing.assert_allclose(
            tcommon.apply_rope(tx, torch.from_numpy(positions), 1e6).numpy(),
            np.asarray(jcommon.apply_rope(x, jnp.asarray(positions), 1e6)),
            atol=1e-5)
    for name in ("silu", "gelu", "relu2"):
        np.testing.assert_allclose(
            tcommon.act_fn(name)(tx).numpy(),
            np.asarray(jcommon.act_fn(name)(x)), atol=1e-6)
    np.testing.assert_allclose(tcommon.softcap(tx, 2.0).numpy(),
                               np.asarray(jcommon.softcap(x, 2.0)), atol=1e-6)
    assert tcommon.softcap(tx, None) is tx
    with pytest.raises(ValueError, match="unknown activation"):
        tcommon.act_fn("tanh")


def test_init_is_seeded_and_scaled():
    tcfg = reduced(get_arch("qwen2-7b"))
    model = build_model(tcfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(5))
    b = model.init(torch.Generator().manual_seed(5))
    assert torch.equal(a["layers"][1]["ffn"]["w_down"],
                       b["layers"][1]["ffn"]["w_down"])
    wq = a["layers"][0]["mixer"]["wq"]
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert not a["final_norm"]["w"].any()


def test_prefill_takes_any_length_and_batch(models):
    """Fault found in the port: the `rmsnorm` and `flash_attention`
    wrappers defaulted to the Pallas kernels' ``block_rows=256`` /
    ``block_q``/``block_k=512`` and so refused a prefill of 3x100 tokens
    (300 norm rows) or of S=600, where the reference model (plain jnp) runs
    any shape. The CUDA kernels tile any row count and S themselves; the
    wrappers' tiling arguments now default to the whole extent."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    rng = np.random.default_rng(6)
    for b, s in ((3, 100), (1, 600)):
        toks = rng.integers(1, tcfg.vocab_size, size=(b, s)).astype(np.int32)
        jl, _ = jmodel.prefill(jparams, jnp.asarray(toks),
                               jmodel.init_cache(b, s, jnp.float32))
        tl, _ = tmodel.prefill(tparams, torch.from_numpy(toks).long(),
                               tmodel.init_cache(b, s, torch.float32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_model_rejects_unported_archs():
    # a griffin-style pattern: rgLRU blocks mixed with sliding-window
    # attention are served with their spec, refused without it (the
    # reference cannot build them either); a bidirectional decoder block
    # is refused, as the reference's serve engine refuses it
    tcfg = dataclasses.replace(reduced(get_arch("qwen2-7b")), n_layers=3,
                               layer_pattern=("rglru", "rglru", "attn_sw"))
    with pytest.raises(ValueError, match="cfg.rglru is None"):
        build_model(tcfg, device="cpu")
    griffin = dataclasses.replace(tcfg, rglru=RGLRUSpec(block_width=64))
    model = build_model(griffin, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    logits, cache = model.prefill(params, torch.ones((1, 5), dtype=torch.long),
                                  model.init_cache(1, 8, torch.float32))
    assert torch.isfinite(logits).all() and cache["h.0"].abs().sum() > 0
    with pytest.raises(ValueError, match="decoder blocks of kinds"):
        build_model(dataclasses.replace(tcfg, layer_pattern=("attn_bidir",)),
                    device="cpu")
