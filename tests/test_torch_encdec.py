"""Encoder-decoder serving of the port (whisper-small) on the CPU, against
the JAX package:

* `layer_norm` against the reference's (the population variance, in f32);
* a reduced whisper-small (LayerNorm, absolute positions, no RoPE):
  `_encode`, prefill logits and the banked encoder K/V ``ek``/``ev``, then
  decode reading the bank, against the JAX `Model` within 3e-5;
* tests/test_serve.py's enc-dec chains through fail→fail→repair→repair —
  attention, and the recurrent ("ssm", "rglru") enc-dec whose bank is
  filled by the length-1 prefill of the token-by-token admission: streams,
  transition records and reshard bytes equal to the JAX `ServeSession`'s,
  streams equal to an uninterrupted run;
* the two ``enc_input`` refusals, and the launcher refusing whisper-small
  as the reference's does (it builds no ``enc_input``);
* `chip_smoke.py` phase 16 rehearsed at reduced widths.

Weights are drawn by the reference's PRNG (norm weights and biases nudged
off their init) and carried across with `convert.params_from_jax`; tokens
and ``enc_input`` come from seeded numpy."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import EncoderSpec as JEncoderSpec
from repro.configs.base import RGLRUSpec as JRGLRUSpec
from repro.configs.base import SSMSpec as JSSMSpec
from repro.models.common import layer_norm as jlayer_norm
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig, EncoderSpec, RGLRUSpec, SSMSpec
from repro_torch.convert import params_from_jax
from repro_torch.kernels import mode
from repro_torch.models.common import layer_norm
from repro_torch.models.transformer import build_model
from repro_torch.serve import Request, ServeSession

from test_torch_rglru import _cfgs, assert_cache_equal, chain_equals_jax, nudged

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TOL = 3e-5
ARCH = "whisper-small"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    # rows far off zero mean, so that the variance's mean subtraction and
    # its divisor (n, not n - 1) both show
    x = (rng.normal(size=(3, 7, 64)) * 2.0 + 5.0).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    want = np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 1e-6))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = layer_norm(tx, tw, tb, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    unbiased = (tx - tx.mean(-1, keepdim=True)) * torch.rsqrt(
        tx.var(-1, keepdim=True) + 1e-6) * tw + tb
    assert float((unbiased - got).abs().max()) > 100 * TOL
    # bf16 in, f32 math, bf16 out
    got16 = layer_norm(tx.bfloat16(), tw.bfloat16(), tb.bfloat16(), 1e-6)
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(jlayer_norm(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w, jnp.bfloat16),
                                    jnp.asarray(b, jnp.bfloat16), 1e-6))
    np.testing.assert_allclose(got16.float().numpy(),
                               want16.astype(np.float32), atol=2e-2)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs(ARCH)
    jm = jbuild_model(jcfg, remat=False)
    jp = nudged(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    enc = (rng.normal(size=(2, tcfg.encoder.enc_seq, tcfg.d_model))
           * 0.1).astype(np.float32)
    return jcfg, jm, jp, tcfg, build_model(tcfg, device="cpu"), tp, enc


def test_params_from_jax_carries_the_encoder_decoder(models):
    jcfg, jm, jp, tcfg, tm, tp, _ = models
    assert {"pos_embed", "encoder"} <= set(tp)
    assert tp["pos_embed"].shape == (tcfg.max_position, tcfg.d_model)
    assert len(tp["encoder"]["layers"]) == tcfg.encoder.n_layers
    block = tp["layers"][1]
    assert {"ln_cross", "cross"} <= set(block) and "b" in block["ln1"]
    assert "bq" not in block["cross"]
    np.testing.assert_array_equal(
        block["ln_cross"]["b"].numpy(),
        np.asarray(jp["layers"][0]["ln_cross"]["b"])[1])
    np.testing.assert_array_equal(
        tp["encoder"]["layers"][1]["mixer"]["wq"].numpy(),
        np.asarray(jp["encoder"]["layers"][0]["mixer"]["wq"])[1])
    assert "cross" not in tp["encoder"]["layers"][0]


def test_encode_prefill_and_decode_match_jax(models):
    """The encoder over two rows of frames; a 12-token prefill into a
    16-row cache banking every layer's encoder K/V; two decode steps
    reading the bank (the encoder does not run again)."""
    jcfg, jm, jp, tcfg, tm, tp, enc = models
    np.testing.assert_allclose(
        tm._encode(tp, torch.from_numpy(enc)).numpy(),
        np.asarray(jm._encode(jp, jnp.asarray(enc))), atol=TOL)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, tcfg.vocab_size, (2, 12))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32),
                        jm.init_cache(2, 16, jnp.float32),
                        enc_input=jnp.asarray(enc))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(),
                        tm.init_cache(2, 16, torch.float32),
                        enc_input=torch.from_numpy(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    assert sorted(tc) == ["ek", "ev", "k", "v"]
    assert tc["ek"].shape == (2, 2, tcfg.encoder.enc_seq, 2, 64)
    assert float(tc["ek"].abs().min(dim=2).values.max()) > 0
    assert_cache_equal(tc, jc, TOL)
    runs = []
    tm._encode = lambda *a: runs.append(a)        # decode never encodes
    try:
        for pos, tok in ((12, [[3], [7]]), (13, [[11], [5]])):
            jd, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.int32(pos))
            td, tc = tm.decode_step(tp, tc, torch.tensor(tok), pos)
            np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)
        assert_cache_equal(tc, jc, TOL)
        tm.decode_slots(tp, tc, torch.tensor([9, 4]), torch.tensor([14, 14]))
    finally:
        del tm._encode
    assert not runs
    with pytest.raises(ValueError, match="enc_input"):
        tm.prefill(tp, torch.from_numpy(toks).long(),
                   tm.init_cache(2, 16, torch.float32))


# --------------------------------------------------------- serve chains

# tests/test_serve.py::test_encdec_*_failover_token_equivalence
FAILOVER = [(2, "FailureEvent", dict(domain=0)),
            (7, "FailureEvent", dict(domain=0)),
            (16, "RecoveryEvent", dict(domain=0)),
            (20, "RecoveryEvent", dict(domain=0))]
ENC = EncoderSpec(n_layers=2, enc_seq=16)
ATTN_KW = dict(arch_id="serve-test-encdec", family="dense", citation="test",
               n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
               d_ff=128, vocab_size=128, layer_pattern=("attn",), window=64,
               chunk_size=64, use_rope=False, tie_embeddings=True)
REC_KW = dict(arch_id="serve-test-encdec-rec", family="hybrid",
              citation="test", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
              layer_pattern=("ssm", "rglru"), use_rope=False,
              tie_embeddings=True)
REC_SPECS = dict(ssm=dict(d_state=16, head_dim=16, expand=2, d_conv=4,
                          chunk=16), rglru=dict(d_conv=4, block_width=16))


def _pair(kw, specs=None):
    specs = specs or {}
    j = JArchConfig(**kw, encoder=JEncoderSpec(n_layers=2, enc_seq=16),
                    **({"ssm": JSSMSpec(**specs["ssm"]),
                        "rglru": JRGLRUSpec(**specs["rglru"])}
                       if specs else {}))
    t = ArchConfig(**kw, encoder=ENC,
                   **({"ssm": SSMSpec(**specs["ssm"]),
                       "rglru": RGLRUSpec(**specs["rglru"])}
                      if specs else {}))
    return j, t


def _enc_fn(rng):
    return (rng.standard_normal((16, 64)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("recurrent", [False, True],
                         ids=["attention", "recurrent"])
def test_encdec_chain_equals_jax(recurrent):
    """The encoder bank resharded as its own unit family (``enc_kv_head``)
    with the self-attention KV heads, or with SSD heads and RG-LRU gate
    blocks: through TP 4 -> 3 -> 2 -> 3 -> 4. (Phase 16's rehearsal below
    preempts, and re-admission runs the encoder again.)"""
    jcfg, tcfg = _pair(REC_KW, REC_SPECS) if recurrent else _pair(ATTN_KW)
    streams, records, stats = chain_equals_jax(jcfg, tcfg, FAILOVER, n=6,
                                               seed=3, enc_fn=_enc_fn)
    assert [r[4:6] for r in records] == [(4, 3), (3, 2), (2, 3), (3, 4)]
    # two KV heads stay on ranks 0 and 1 at every TP; SSD heads and gate
    # blocks move
    assert (stats["reshard_bytes"] > 0) == recurrent


def test_encdec_requires_enc_input():
    _, cfg = _pair(dict(ATTN_KW, arch_id="serve-test-encdec2"))
    session = ServeSession.create(cfg, replicas=1, n1=4, slots=2, max_len=64,
                                  prefill_len=16, policy="ntp", device="cpu")
    eng = session.engines[0]
    with pytest.raises(ValueError, match=r"enc_input"):
        eng.admit(Request(rid=0, prompt=np.ones(4, np.int32), max_new=2))
    with pytest.raises(ValueError, match=r"\(16, 64\)"):
        eng.admit(Request(rid=1, prompt=np.ones(4, np.int32), max_new=2,
                          enc_input=np.zeros((8, 64), np.float32)))
    assert eng.n_active == 0          # refused before taking a slot


def test_launcher_refuses_whisper_as_the_reference(monkeypatch):
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as launch

    argv = ["--arch", ARCH, "--requests", "2", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError, match="enc_input") as want:
        jlaunch.main()
    with pytest.raises(ValueError, match="enc_input") as got:
        launch.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_chip_hybrid_serve_phase_rehearsed_on_cpu():
    """`chip_smoke.py` phase 16 at reduced widths on the CPU, at its
    sessions, chain and traffic: recurrentgemma with its two tail layers
    and MQA, whisper with 8 KV heads (so that heads move): its checks
    pass, and the launches it returns are zero (the CPU runs the plain
    versions)."""
    cpu = torch.device("cpu")
    for arch, kw in (("recurrentgemma-9b", dict(n_layers=5)),
                     (ARCH, dict(n_heads=8, n_kv_heads=8))):
        cfg = dataclasses.replace(reduced(get_arch(arch)), **kw)
        (counts, kinds), clean, n_par = chip_smoke.hybrid_model_part(
            torch, cpu, cfg, chip_smoke.HYBRID_REF_LAYERS[arch])
        assert counts == dict.fromkeys(mode.KERNELS, 0) and kinds == {}
        assert n_par == sum(t.numel() for t in chip_smoke._leaves(
            clean.params))
        prompts, enc = chip_smoke.hybrid_traffic(cfg)
        assert len(prompts) == chip_smoke.HYBRID_REQ
        assert (enc is None) == (cfg.encoder is None)


def test_chip_hybrid_chain_is_pinned():
    """Phase 16's chain, sessions and traffic, as `chip_smoke.py`'s
    docstring and PERF.md state them."""
    assert chip_smoke.HYBRID_CHAIN == {
        3: ("FailureEvent", dict(domain=0)),
        5: ("FailureEvent", dict(domain=0)),
        9: ("RecoveryEvent", dict(domain=0)),
        11: ("RecoveryEvent", dict(domain=0))}
    assert chip_smoke.HYBRID_SERVE_KW == dict(
        replicas=1, n1=4, slots=8, max_len=64, prefill_len=16,
        policy="ntp_pw")
    assert (chip_smoke.HYBRID_REQ, chip_smoke.HYBRID_PROMPT,
            chip_smoke.HYBRID_NEW, chip_smoke.HYBRID_PER_TICK) == (12, 8, 8, 4)
    assert chip_smoke.HYBRID_REF_LAYERS == {"recurrentgemma-9b": 3,
                                            ARCH: 1}
