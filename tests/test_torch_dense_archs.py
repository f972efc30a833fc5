"""The dense attention archs of the port — gemma2-9b (post-norms, attention
and final softcaps, sliding/global alternation, GeGLU, scaled and tied
embeddings), granite-3-2b (head_dim 64), minitron-4b (squared-ReLU MLP,
untied) and chameleon-34b (qk-norm) — on the CPU against the JAX package:

* the configs equal the reference's field for field, full and reduced,
  and every head_dim is one `flash_attention` takes;
* prefill logits, the written caches and decode equal the JAX `Model`'s
  within 3e-5 in f32 (2e-2 with bf16 caches), gemma2 with a window short
  enough that its sliding layers mask;
* `params_from_jax` carries the post-norms, the RG-LRU and the enc-dec
  leaves, and refuses a leaf the reference's model does not make; `validate_model_cfg` accepts
  post-norms, LayerNorm and an encoder, and refuses what the reference
  does not serve;
* `chip_smoke.py`'s mixed chain on each arch, reduced (gemma2's rings
  wrapping): streams, transition records and telemetry equal to the JAX
  `ServeSession`'s, and the restore under TP (4, 3);
* phase 15 rehearsed at reduced widths.

Weights are drawn by the reference's PRNG (norms and qk-norm weights
nudged off their init, so the (1 + w) paths count) and carried across with
`convert.params_from_jax`; tokens come from seeded numpy."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import EncoderSpec
from repro_torch.convert import params_from_jax
from repro_torch.kernels import mode
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.transformer import build_model, validate_model_cfg

from test_torch_serve_lifecycle import CHAIN_NEW, chain_parity

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ARCHS = ("gemma2-9b", "granite-3-2b", "minitron-4b", "chameleon-34b")
TOL = {"f32": 3e-5, "bf16": 2e-2}
# gemma2's window cut to 16 rows, so that its sliding layers mask (in a
# 20-token prefill) and their ring caches wrap (in the chain's decode)
EXTRA = {"gemma2-9b": {"window": 16}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    kw = {**EXTRA.get(arch, {}), **kw}
    return (dataclasses.replace(jreduced(jget_arch(arch)), **kw),
            dataclasses.replace(reduced(get_arch(arch)), **kw))


def _nudged(jparams):
    """The reference's params with every norm and qk-norm weight moved off
    its init."""
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.normal(size=a.shape) * 0.05,
                                        a.dtype)
        if getattr(path[-1], "key", "") in ("w", "q_norm", "k_norm") else a,
        jparams)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    jm = jbuild_model(jcfg, remat=False)
    jp = _nudged(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg, device="cpu"), tp


def test_configs_match_reference():
    for arch in ARCHS:
        j, t = jget_arch(arch), get_arch(arch)
        for jc, tc in ((j, t), (jreduced(j), reduced(t))):
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert jc.padded_vocab() == tc.padded_vocab()
            assert jc.n_params() == tc.n_params()
            assert tc.head_dim in HEAD_DIMS
    g = get_arch("gemma2-9b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim,
            g.d_ff, g.vocab_size, g.window, g.attn_softcap, g.final_softcap,
            g.post_norms, g.tie_embeddings) == (
        42, 3584, 16, 8, 256, 14336, 256_000, 4096, 50.0, 30.0, True, True)
    # the full model's parameters as the port holds them: the config's
    # count, plus the post-norms and the final norm it leaves out
    assert g.n_params() + 2 * 42 * 3584 + 3584 == 9_241_705_984
    assert get_arch("granite-3-2b").head_dim == 64


def test_prefill_and_decode_match_jax(models):
    """Two rows of 20 tokens prefilled into a 24-row cache, then two
    one-token decode steps: logits and the written K/V within 3e-5."""
    jcfg, jm, jp, tcfg, tm, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(1, tcfg.vocab_size, (2, 20))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32),
                        jm.init_cache(2, 24, jnp.float32))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(),
                        tm.init_cache(2, 24, torch.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL["f32"])
    if tcfg.final_softcap:
        assert float(tl.abs().max()) <= tcfg.final_softcap
    tleaves = sorted(tc.values(), key=lambda t: tuple(t.shape))
    jleaves = sorted(jax.tree.leaves(jc), key=lambda a: a.shape)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL["f32"])
    for pos, tok in ((20, [[3], [7]]), (21, [[11], [5]])):
        jd, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos))
        td, tc = tm.decode_step(tp, tc, torch.tensor(tok), pos)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   atol=TOL["f32"])


@pytest.mark.parametrize("models", ["gemma2-9b"], indirect=True)
def test_slot_decode_with_bf16_caches_matches_jax(models):
    """Ragged per-slot decode over bf16 slot caches (the serving engine's
    tick) against the reference's vmapped `decode_slots`, within 2e-2, on
    gemma2 (every feature of the four; the jit of the vmapped tick is the
    cost, so the other archs' f32 decode stands for them)."""
    jcfg, jm, jp, tcfg, tm, tp = models
    slots, max_len = 3, 24
    jc = jm.init_slot_cache(slots, max_len, jnp.bfloat16)
    tc = tm.init_slot_cache(slots, max_len, torch.bfloat16)
    rng = np.random.default_rng(2)
    lens = [5, 9, 13]
    for b, n in enumerate(lens):
        toks = rng.integers(1, tcfg.vocab_size, (1, n))
        _, j1 = jm.prefill(jp, jnp.asarray(toks, jnp.int32),
                           jm.init_cache(1, max_len, jnp.bfloat16))
        jc = jax.tree.map(lambda full, one: full.at[b].set(one), jc, j1)
        _, t1 = tm.prefill(tp, torch.from_numpy(toks).long(),
                           tm.init_cache(1, max_len, torch.bfloat16))
        for name, leaf in tc.items():
            leaf[:, b] = t1[name][:, 0]
    tok, pos = rng.integers(1, tcfg.vocab_size, slots), np.array(lens)
    jl, _ = jax.jit(jm.decode_slots)(jp, jc, jnp.asarray(tok, jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
    tl, _ = tm.decode_slots(tp, tc, torch.from_numpy(tok).long(),
                            torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL["bf16"])


def test_params_from_jax_carries_post_norms(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    block = set(tp["layers"][0])
    if tcfg.post_norms:
        assert {"ln1_post", "ln2_post"} <= block
        np.testing.assert_array_equal(
            tp["layers"][1]["ln2_post"]["w"].numpy(),
            np.asarray(jp["layers"][1]["ln2_post"]["w"])[0])
    else:
        assert not block & {"ln1_post", "ln2_post"}
    assert ("lm_head" in tp) != tcfg.tie_embeddings


@pytest.mark.parametrize("arch,leaves", [
    ("recurrentgemma-9b", ["mixer/lam"]),
    ("whisper-small", ["cross", "encoder", "ln1/b", "ln_cross", "pos_embed"]),
])
def test_params_from_jax_refuses_the_unported(arch, leaves):
    """The RG-LRU and enc-dec leaves, once refused, are carried now, each
    with its dtype; a leaf the reference's model does not make is still
    refused."""
    # the reference's parameter tree by shape alone, as zeros
    shapes = jax.eval_shape(jbuild_model(jreduced(jget_arch(arch))).init,
                            jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    tp = params_from_jax(p, device="cpu")
    for leaf in leaves:
        node = tp if leaf in tp else tp["layers"][0]
        for key in leaf.split("/"):
            node = node[key]
        assert node is not None, leaf
    if arch == "recurrentgemma-9b":
        assert tp["layers"][0]["mixer"]["lam"].dtype == torch.float32
    for bad in ({**p, "vision_tower": np.zeros(2)},
                {**p, "layers": (dict(p["layers"][0], adapter={}),
                                 *p["layers"][1:])}):
        with pytest.raises(ValueError, match="not leaves of the reference"):
            params_from_jax(bad, device="cpu")


def test_validate_model_cfg_accepts_post_norms_only():
    """Post-norms, LayerNorm and an encoder are served now; a decoder
    block outside the reference's serving kinds, or a recurrent block
    without its spec, is still refused."""
    _, gemma = _cfgs("gemma2-9b")
    validate_model_cfg(gemma)
    validate_model_cfg(dataclasses.replace(gemma, norm_type="ln"))
    validate_model_cfg(dataclasses.replace(
        gemma, encoder=EncoderSpec(n_layers=2, enc_seq=64)))
    with pytest.raises(ValueError, match="decoder blocks of kinds"):
        validate_model_cfg(dataclasses.replace(
            gemma, layer_pattern=("attn_sw", "attn_bidir")))
    with pytest.raises(ValueError, match="cfg.rglru is None"):
        validate_model_cfg(dataclasses.replace(
            gemma, layer_pattern=("rglru", "attn")))


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_chain_equals_jax(arch, tmp_path):
    jcfg, tcfg = _cfgs(arch, n_heads=8, n_kv_heads=4)
    trun, saved, _ = chain_parity(jcfg, tcfg, tmp_path)
    assert trun["preempted"][0][2] > 0 and saved["queue"]
    if arch == "gemma2-9b":       # the sliding rings wrap
        assert tcfg.window < 14 + CHAIN_NEW


def test_chip_dense_serve_phase_rehearsed_on_cpu(tmp_path):
    """`chip_smoke.py` phase 15 at reduced widths (8 KV heads, as every
    full-size arch of the phase has) on the CPU, at its sessions, chain
    and traffic: its checks pass, and the launches it returns are zero
    (the CPU runs the plain versions)."""
    kw = dict(n_heads=8, n_kv_heads=8)
    cfg = dataclasses.replace(reduced(get_arch("gemma2-9b")), **kw)
    (counts, kinds), clean, n_par = chip_smoke.dense_chain_part(
        torch, torch.device("cpu"), cfg, str(tmp_path))
    assert counts == dict.fromkeys(mode.KERNELS, 0) and kinds == {}
    assert n_par == sum(t.numel() for t in chip_smoke._leaves(clean.params))
    for arch in chip_smoke.DENSE_ARCHS:
        cfg = dataclasses.replace(reduced(get_arch(arch)), **kw,
                                  n_layers=chip_smoke.DENSE_ARCH_LAYERS)
        counts, kinds = chip_smoke.dense_arch_part(torch, torch.device("cpu"),
                                                   cfg)
        assert counts == dict.fromkeys(mode.KERNELS, 0) and kinds == {}


@pytest.mark.parametrize("kind", ["sliding", "causal", "chunked"])
def test_chip_flex_yardstick_computes_the_softcapped_attention(kind):
    """`chip_smoke.py` times gemma2's softcapped flash_attention rows
    against `flex_attention` (`flex_yardstick`): run eagerly on the CPU,
    the yardstick computes the port's function — softcap 50, the mask
    with a window and a chunk short enough to cut, GQA by index — within
    3e-5 in f32."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, h, 24, 64))
                                .astype(np.float32)) * c
               for h, c in ((8, 4.0), (2, 4.0), (2, 1.0)))
    kw = dict(kind=kind, window=5, chunk=8, softcap=50.0)
    (flex,) = chip_smoke.flex_yardstick(torch, q, k, v, kind, 5, 8, 50.0,
                                        compiled=False).values()
    want = flash_attention(q, k, v, **kw)
    assert float((flex() - want).abs().max()) <= TOL["f32"]
    if kind != "causal":
        causal = flash_attention(q, k, v, **dict(kw, kind="causal"))
        assert float((causal - want).abs().max()) > 1e-2
