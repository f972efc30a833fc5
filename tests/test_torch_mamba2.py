"""Mamba-2 in the port against the JAX package on the CPU, at
`reduced(mamba2-780m)` (2 layers, d_model 256, 8 SSD heads of 64, d_state
32, chunk 32): the config, the model (prefill logits and the h/conv cache,
then one-token decode, atol 1e-4 as `tests/test_torch_model.py` — f32 sums
in another order), the `ssm_head` reshard of h and conv through a TP chain
(bit for bit, with the byte ledger), the serve engine through
fail→fail→repair→repair (identical token streams, the
`examples/serve_failover.py` oracle), and the launchers' CPU smoke runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.transformer import build_model as jbuild_model
from repro.reshard import units as junits
from repro.reshard.state import ShardedState as JShardedState
from repro.runtime import FailureEvent as JFail
from repro.runtime import RecoveryEvent as JRepair
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeSession as JServeSession
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import mode
from repro_torch.models.ssm import init_ssm_cache, ssm_apply, ssm_init
from repro_torch.models.transformer import build_model
from repro_torch.reshard import units as tunits
from repro_torch.reshard.state import ShardedState
from repro_torch.runtime import FailureEvent, RecoveryEvent
from repro_torch.serve import Request, Router, ServeSession
from repro_torch.serve.engine import ServeEngine, validate_serve_cfg

ATOL = 1e-4
ARCH = "mamba2-780m"


@pytest.fixture(scope="module")
def models():
    """One JAX reduced mamba2 + params (norms, biases and D made nonzero so
    every leaf counts), and its port twin on the converted params."""
    jcfg = jreduced(jget_arch(ARCH))
    jmodel = jbuild_model(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.normal(size=a.shape) * 0.05, a.dtype)
        if getattr(path[-1], "key", "") in ("w", "dt_bias", "conv_b", "D",
                                            "norm") else a,
        jparams,
    )
    tcfg = reduced(get_arch(ARCH))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(tcfg, device="cpu"), tparams


def test_config_matches_reference():
    for j, t in ((jget_arch(ARCH), get_arch(ARCH)),
                 (jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH)))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.n_params() == t.n_params()
    full = get_arch(ARCH)
    s = full.ssm
    assert (full.n_layers, full.d_model, s.d_inner(1536), s.n_heads(1536),
            s.head_dim, s.d_state, s.d_conv, s.chunk, full.padded_vocab(),
            full.tie_embeddings) == (48, 1536, 3072, 48, 64, 128, 4, 256,
                                     50432, True)
    r = reduced(full)
    assert (r.n_layers, r.d_model, r.ssm.n_heads(256), r.ssm.d_state,
            r.ssm.chunk) == (2, 256, 8, 32, 32)


def test_converted_layout(models):
    _, jparams, tmodel, tparams = models
    assert "lm_head" not in tparams and len(tparams["layers"]) == 2
    assert set(tparams["layers"][1]) == {"ln1", "mixer"}
    assert set(tparams["layers"][1]["mixer"]) == {
        "w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias", "conv_w", "conv_b",
        "A_log", "D", "norm", "w_out"}
    np.testing.assert_array_equal(
        tparams["layers"][1]["mixer"]["conv_w"].numpy(),
        np.asarray(jparams["layers"][0]["mixer"]["conv_w"][1]))


@pytest.mark.parametrize("b,s", [(2, 64), (1, 32), (3, 20)])
def test_prefill_cache_and_decode_match_jax(models, b, s):
    jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(b * 10 + s)
    toks = rng.integers(1, 500, size=(b, s)).astype(np.int32)
    jc = jmodel.init_cache(b, s + 4, jnp.float32)
    tc = tmodel.init_cache(b, s + 4, torch.float32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), jc)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # JAX cache leaves (n_cyc, b, ...) are the port's (layers, b, ...)
    for name in ("h", "conv"):
        np.testing.assert_allclose(
            tc[name].numpy(), np.asarray(jc["layers"][0][name]), atol=ATOL)
    for step in range(2):
        nxt = rng.integers(1, 500, size=(b, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt),
                                    jnp.int32(s + step))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(nxt).long(),
                                    s + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc["h"].numpy(),
                               np.asarray(jc["layers"][0]["h"]), atol=ATOL)


def test_slot_decode_matches_jax(models):
    """`decode_slots` over a slot cache: every slot advances its own
    recurrent state (positions do not enter the SSD update)."""
    jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(5)
    slots = 3
    jcache = jmodel.init_slot_cache(slots, 16, jnp.float32)
    tcache = tmodel.init_slot_cache(slots, 16, torch.float32)
    for b in range(slots):
        toks = rng.integers(1, 500, size=(1, 4 + b)).astype(np.int32)
        _, jc1 = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.init_cache(1, 16, jnp.float32))
        _, tc1 = tmodel.prefill(tparams, torch.from_numpy(toks).long(),
                                tmodel.init_cache(1, 16, torch.float32))
        jcache = jax.tree.map(lambda full, one: full.at[b].set(one), jcache, jc1)
        for name in ("h", "conv"):
            tcache[name][:, b] = tc1[name][:, 0]
    cur = rng.integers(1, 500, size=slots).astype(np.int32)
    pos = np.array([4, 5, 6], np.int32)
    for _ in range(2):
        jl, jcache = jmodel.decode_slots(jparams, jcache, jnp.asarray(cur),
                                         jnp.asarray(pos))
        tl, tcache = tmodel.decode_slots(tparams, tcache, torch.from_numpy(cur),
                                         torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        cur, pos = np.array(jnp.argmax(jl[:, :500], -1), np.int32), pos + 1


def test_chunked_prefill_equals_token_by_token(models):
    """The SSD scan of a prefill and the recurrent update fed one token at
    a time reach the same logits and state — the check the chip smoke
    makes at full size."""
    _, _, tmodel, tparams = models
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(1, 500, size=(2, 64))).long()
    lp, cp = tmodel.prefill(tparams, toks, tmodel.init_cache(2, 64, torch.float32))
    cr = tmodel.init_cache(2, 64, torch.float32)
    lr, cr = tmodel.prefill(tparams, toks[:, :1], cr)
    for t in range(1, 64):
        lr, cr = tmodel.decode_step(tparams, cr, toks[:, t:t + 1], t)
    np.testing.assert_allclose(lr[:, 0].numpy(), lp[:, -1].numpy(), atol=ATOL)
    np.testing.assert_allclose(cr["h"].numpy(), cp["h"].numpy(), atol=ATOL)
    np.testing.assert_allclose(cr["conv"].numpy(), cp["conv"].numpy(), atol=ATOL)


def test_ssm_apply_contract(models):
    _, _, tmodel, tparams = models
    cfg = tmodel.cfg
    p = tparams["layers"][0]["mixer"]
    x = torch.randn((1, 48, cfg.d_model), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError,
                       match=r"sequence length s=48 .* chunk length chunk=32"):
        ssm_apply(cfg, p, x)
    cache = {n: t[0] for n, t in
             init_ssm_cache(cfg, 1, 1, torch.float32, "cpu").items()}
    with pytest.raises(ValueError, match="continuing from a cached state"):
        ssm_apply(cfg, p, x[:, :32], cache=cache, cache_pos=5)
    out, _ = ssm_apply(cfg, p, x[:, :32])        # cache-less forward
    assert out.shape == (1, 32, cfg.d_model) and torch.isfinite(out).all()
    # an SSD block has no FFN whatever d_ff says (the reference's
    # `_has_ffn`), so such a config is served, as the reference serves it;
    # an SSD block without its spec is refused
    wide = build_model(dataclasses.replace(cfg, d_ff=512), device="cpu")
    block = wide.init(torch.Generator().manual_seed(0))["layers"][0]
    assert "ffn" not in block and "ln2" not in block
    with pytest.raises(ValueError, match="cfg.ssm is None"):
        build_model(dataclasses.replace(cfg, ssm=None), device="cpu")


def test_init_is_seeded():
    cfg = reduced(get_arch(ARCH))
    a = ssm_init(cfg, torch.Generator().manual_seed(3), torch.float32)
    b = ssm_init(cfg, torch.Generator().manual_seed(3), torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    A = torch.exp(a["A_log"])
    assert bool(((A >= 1.0) & (A <= 16.0)).all())
    assert abs(a["w_x"].std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not a["dt_bias"].any() and bool((a["D"] == 1).all())


# ---------------------------------------------------------------------------
# the ssm_head reshard


def test_unit_specs_match_reference():
    jcfg, tcfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    assert tunits.arch_unit_counts(tcfg) == junits.arch_unit_counts(jcfg)
    assert tunits.serve_unit_count(tcfg) == junits.serve_unit_count(jcfg) == 8
    assert (junits.serve_unit_count(jget_arch(ARCH))
            == tunits.serve_unit_count(get_arch(ARCH)) == 48)
    res = tunits.cache_unit_resolver(tcfg)
    jspec = junits._kind_state_specs(jcfg, "ssm")
    for name in ("h", "conv"):
        assert dataclasses.asdict(res(name)) == dataclasses.asdict(jspec[name])
    with pytest.raises(ValueError, match="unknown state leaf 'k'"):
        res("k")


@pytest.mark.parametrize("n1,chain", [(4, [3, 2, 3, 4]), (4, [1, 4]),
                                      (8, [5, 7, 2, 8])])
def test_ssm_state_reshard_bit_identical(n1, chain):
    jcfg, tcfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    s = tcfg.ssm
    nh, hp, ds = s.n_heads(256), s.head_dim, s.d_state
    rng = np.random.default_rng(n1 + len(chain))
    # the port's slot-cache layout: (layers, slots, ...)
    h = rng.normal(size=(2, 3, nh, hp, ds)).astype(np.float32)
    conv = rng.normal(size=(2, 3, s.d_conv - 1, nh * hp + 2 * ds)).astype(np.float32)
    jstate = JShardedState(
        {"layers": ({"h": jnp.asarray(h), "conv": jnp.asarray(conv)},)},
        junits.cache_unit_resolver(jcfg), n1)
    tstate = ShardedState({"h": torch.from_numpy(h),
                           "conv": torch.from_numpy(conv)},
                          tunits.cache_unit_resolver(tcfg), n1)
    jbufs = dict(zip(("conv", "h"), jstate.sharded))   # JAX: sorted keys
    tbufs = dict(zip(("h", "conv"), tstate.sharded))
    for name in ("h", "conv"):
        assert np.array_equal(np.asarray(jbufs[name]), tbufs[name].numpy())
    for tp in chain:
        js, ts = jstate.apply_tp(tp), tstate.apply_tp(tp)
        assert ts == js and ts["bytes_moved"] > 0
        jbufs = dict(zip(("conv", "h"), jstate.sharded))
        tbufs = dict(zip(("h", "conv"), tstate.sharded))
        jd, td = jstate.gather()["layers"][0], tstate.gather()
        for name in ("h", "conv"):
            assert np.array_equal(np.asarray(jbufs[name]), tbufs[name].numpy())
            assert np.array_equal(np.asarray(jd[name]), td[name].numpy())
        # the replicated B/C tail of conv never moves
        assert np.array_equal(td["conv"][..., nh * hp:].numpy(),
                              conv[..., nh * hp:])
    if chain[-1] == n1:
        assert np.array_equal(tstate.gather()["h"].numpy(), h)
        assert np.array_equal(tstate.gather()["conv"].numpy(), conv)


def test_conv_tail_and_unit_geometry():
    tcfg = reduced(get_arch(ARCH))
    res = tunits.cache_unit_resolver(tcfg)
    conv = torch.arange(2 * 3 * (8 * 64 + 64), dtype=torch.float32).reshape(
        2, 3, 8 * 64 + 64)
    st = ShardedState({"conv": conv}, res, 4)
    # (n1, buf, unit, ...): 8 SSD heads of 64 channels each
    assert tuple(st.sharded[0].shape) == (4, 8, 64, 2, 3)
    with pytest.raises(ValueError, match="is not"):
        ShardedState({"conv": conv[..., 1:]}, res, 4)


# ---------------------------------------------------------------------------
# serving through fail→repair

SESSION_KW = dict(replicas=1, n1=4, slots=8, max_len=48, prefill_len=16,
                  policy="ntp_pw")
N_REQ, MAX_NEW = 16, 8
EVENTS = [(5, "fail"), (9, "fail"), (22, "repair"), (26, "repair")]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=int(rng.integers(4, 15))).astype(np.int32)
            for _ in range(N_REQ)]


def _run(session, router, req_cls, fail_cls, repair_cls, events, vocab):
    pending = [req_cls(rid=i, prompt=p, max_new=MAX_NEW)
               for i, p in enumerate(_prompts(vocab))]
    log, tick = [], 0
    while pending or router.queue or session.engines[0].n_active:
        while pending and pending[0].rid <= tick:
            router.submit(pending.pop(0))
        for at, kind in events:
            if at == tick:
                router.apply((fail_cls if kind == "fail" else repair_cls)(domain=0))
                e = session.engines[0]
                log.append((tick, e.tp, e.capacity, dict(e.last_reshard),
                            e.stats["preemptions"]))
        router.step()
        tick += 1
        assert tick < 2000
    return {r.rid: list(r.generated) for r in router.completed}, log


def test_engine_tokens_equal_jax_through_fail_repair():
    jcfg = jreduced(jget_arch(ARCH))
    js = JServeSession.create(jcfg, key=jax.random.PRNGKey(3), **SESSION_KW)
    jtoks, jlog = _run(js, JRouter(js), JRequest, JFail, JRepair, EVENTS,
                       jcfg.vocab_size)
    tcfg = reduced(get_arch(ARCH))
    params = params_from_jax(jax.tree.map(np.asarray, js.params), device="cpu")
    ts = ServeSession.create(tcfg, params=params, device="cpu", **SESSION_KW)
    mode.reset_launches()
    ttoks, tlog = _run(ts, Router(ts), Request, FailureEvent, RecoveryEvent,
                       EVENTS, tcfg.vocab_size)
    assert len(ttoks) == N_REQ and all(len(t) == MAX_NEW for t in ttoks.values())
    assert ttoks == jtoks
    assert [e[1] for e in tlog] == [3, 2, 3, 4]
    assert tlog == jlog                       # same ssm_head bytes, preemptions
    assert tlog[-1][4] > 0 and tlog[0][3]["bytes_moved"] > 0
    # recurrent admission never runs the SSD scan (length-1 prefills)
    assert mode.launches()["ssd_scan"] == 0
    clean = ServeSession.create(tcfg, params=params, device="cpu", **SESSION_KW)
    ctoks, _ = _run(clean, Router(clean), Request, FailureEvent, RecoveryEvent,
                    [], tcfg.vocab_size)
    assert ctoks == ttoks


def test_engine_admits_recurrent_token_by_token(models):
    _, _, tmodel, tparams = models
    eng = ServeEngine(tmodel.cfg, tparams, n1=4, slots=2, max_len=32,
                      prefill_len=4, model=tmodel)
    prompt = np.arange(1, 11, dtype=np.int32)        # longer than prefill_len
    assert eng.admit(Request(rid=0, prompt=prompt, max_new=3))
    # the slot holds the state of the whole prompt, not of a padded prefix
    _, c = tmodel.prefill(tparams, torch.from_numpy(prompt[None]).long()[:, :1],
                          tmodel.init_cache(1, 32, torch.float32))
    for t in range(1, 10):
        _, c = tmodel.decode_step(tparams, c, torch.tensor([[int(prompt[t])]]), t)
    assert torch.equal(eng.cache["h"][:, 0], c["h"][:, 0])
    eng.apply_tp(0)                                  # death zeroes the slots
    eng.apply_tp(4)
    assert not eng.cache["h"].any() and not eng.cache["conv"].any()


def test_validate_serve_cfg():
    tcfg = reduced(get_arch(ARCH))
    assert validate_serve_cfg(tcfg) == {"ssm"}
    bad = dataclasses.replace(tcfg, layer_pattern=("attn_bidir",))
    with pytest.raises(ValueError, match="serve engine supports kinds"):
        ServeSession.create(bad, device="cpu")


# ---------------------------------------------------------------------------
# launchers


def test_serve_launcher_runs_mamba2_on_cpu(capsys):
    from repro_torch.launch.serve import main

    g = main(["--arch", ARCH, "--device", "cpu", "--requests", "6",
              "--max-new", "4", "--log-every", "5"])
    out = capsys.readouterr().out
    assert "mamba2-780m-smoke" in out and "device=cpu" in out
    assert g["completed"] == 6


@pytest.mark.parametrize("arch,prompt_len", [(ARCH, 64), (ARCH, 20),
                                             ("qwen2-7b", 24)])
def test_serve_decode_launcher_on_cpu(capsys, arch, prompt_len):
    from repro_torch.launch.serve_decode import main

    out = main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", str(prompt_len), "--new", "5"])
    assert out["tokens"].shape == (2, 5)
    assert "OK" in capsys.readouterr().out
    if arch == ARCH:
        with pytest.raises(ValueError, match="chunk length chunk=32"):
            main(["--device", "cpu", "--prompt-len", "48", "--new", "2"])
