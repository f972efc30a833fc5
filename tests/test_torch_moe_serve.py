"""MoE serving (arctic-480b, llama4-scout) and ring KV caches on the CPU:
the port against the JAX package.

* Through fail→fail→repair→repair at the published capacity factor
  (1.25) every request's greedy stream equals the JAX `ServeSession`'s on
  the same parameters and requests, and so do each transition's TP,
  capacity, reshard ledger and preemptions. Configs: `reduced()`
  arctic-480b and llama4-scout with 4 KV heads and 4 layers (llama4's
  chunk 16, so its three `attn_chunked` layers keep rings of 16 rows
  beside the global layer's 48, and the rings wrap).
* At a drop-free capacity (``capacity_factor = E/k``) every stream equals
  an uninterrupted run's. At 1.25 they need not: a preempted request
  re-prefills its generated tokens, and those compete for an expert's
  capacity in that prefill where the uninterrupted run decoded them one
  slot at a time, with no drop.
* A decode tick dispatches each slot on its own, as the reference's
  vmapped `decode_slots`: where more slots pick one expert than the
  tick's per-call capacity the port's tick equals the reference's within
  3e-5, and one dispatch of the whole tick at that capacity differs.
* Ring caches: decode across a chunk boundary and past a sliding window,
  and a prefill longer than the ring, equal the reference's `attn_apply`
  on the same cache.
* `validate_model_cfg`'s and the engine's refusals, and the launcher at
  both archs.

Inputs are made with numpy (the weights by the reference's PRNG,
converted with `params_from_jax`)."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models.common import NO_SHARD
from repro.models.transformer import build_model as jbuild_model
from repro.runtime import FailureEvent as JFail
from repro.runtime import RecoveryEvent as JRepair
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeSession as JServeSession
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import mlp as tmlp
from repro_torch.models.transformer import (
    build_model, cache_groups, validate_model_cfg,
)
from repro_torch.reshard.units import cache_unit_resolver
from repro_torch.runtime import FailureEvent, RecoveryEvent
from repro_torch.serve import Request, Router, ServeSession
from repro_torch.serve.engine import ServeEngine

ARCHS = {"arctic-480b": {},
         "llama4-scout-17b-a16e": {"chunk_size": 16}}
N_REQ, MAX_NEW = 16, 8
SESSION_KW = dict(replicas=1, n1=4, slots=8, max_len=48, prefill_len=16,
                  policy="ntp_pw")
EVENTS = [(7, "fail"), (10, "fail"), (24, "repair"), (28, "repair")]
TOL = 3e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **extra):
    kw = {"n_layers": 4, "n_kv_heads": 4, **ARCHS[arch], **extra}
    return (dataclasses.replace(jreduced(jget_arch(arch)), **kw),
            dataclasses.replace(reduced(get_arch(arch)), **kw))


def _drop_free(cfg):
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=int(rng.integers(4, 15)))
            .astype(np.int32) for _ in range(N_REQ)]


def _run(session, router, req_cls, fail_cls, repair_cls, events, vocab):
    """One arrival a tick, events at fixed ticks. Returns ({rid: tokens},
    [(tick, tp, capacity, last_reshard, preemptions)])."""
    pending = [req_cls(rid=i, prompt=p, max_new=MAX_NEW)
               for i, p in enumerate(_prompts(vocab))]
    log, tick = [], 0
    while pending or router.queue or session.engines[0].n_active:
        while pending and pending[0].rid <= tick:
            router.submit(pending.pop(0))
        for at, kind in events:
            if at == tick:
                router.apply((fail_cls if kind == "fail" else repair_cls)(
                    domain=0))
                e = session.engines[0]
                log.append((tick, e.tp, e.capacity, dict(e.last_reshard),
                            e.stats["preemptions"]))
        router.step()
        tick += 1
        assert tick < 2000
    return {r.rid: list(r.generated) for r in router.completed}, log


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    """The JAX session's run at the published capacity, and the port's
    weights converted from it."""
    jcfg, tcfg = _cfgs(request.param)
    js = JServeSession.create(jcfg, key=jax.random.PRNGKey(3), **SESSION_KW)
    jtoks, jlog = _run(js, JRouter(js), JRequest, JFail, JRepair, EVENTS,
                       jcfg.vocab_size)
    params = params_from_jax(jax.tree.map(np.asarray, js.params),
                             device="cpu")
    return tcfg, params, jtoks, jlog, (jcfg, js.engines[0], js.params)


def test_streams_equal_jax_through_fail_repair(served):
    tcfg, params, jtoks, jlog, _ = served
    s = ServeSession.create(tcfg, params=params, device="cpu", **SESSION_KW)
    toks, log = _run(s, Router(s), Request, FailureEvent, RecoveryEvent,
                     EVENTS, tcfg.vocab_size)
    assert len(toks) == N_REQ and all(len(t) == MAX_NEW
                                      for t in toks.values())
    assert toks == jtoks
    assert [e[1] for e in log] == [3, 2, 3, 4]
    assert log == jlog              # capacity, KV ledger, preemptions
    assert log[-1][4] > 0 and log[1][3]["bytes_moved"] > 0
    if tcfg.layer_pattern[0] == "attn_chunked":
        # three chunked rings of 16 rows beside the global layer's 48,
        # and requests decode past 16 positions: the rings wrap
        rows = {n: t.shape[2] for n, t in s.engines[0].cache.items()}
        assert rows == {"k.0": 16, "v.0": 16, "k.1": 16, "v.1": 16,
                        "k.2": 16, "v.2": 16, "k.3": 48, "v.3": 48}
        assert max(len(p) for p in _prompts(tcfg.vocab_size)) + MAX_NEW > 16


def test_params_from_jax_carries_the_moe_ffn(served):
    tcfg, params, _, _, (jcfg, _, jparams) = served
    side = "shared" if tcfg.moe.shared_expert else "dense"
    pat = len(tcfg.layer_pattern)
    for i, block in enumerate(params["layers"]):
        ffn = block["ffn"]
        assert set(ffn) == {"router", "w_up", "w_gate", "w_down", side}
        assert ffn["router"].dtype == torch.float32
        e, d, ff = tcfg.moe.n_experts, tcfg.d_model, tcfg.d_ff
        assert ffn["w_up"].shape == (e, d, ff) == ffn["w_gate"].shape
        assert ffn["w_down"].shape == (e, ff, d)
        want = jparams["layers"][i % pat]["ffn"]
        for name in ("router", "w_down"):
            np.testing.assert_array_equal(ffn[name].numpy(),
                                          np.asarray(want[name])[i // pat])
        np.testing.assert_array_equal(
            ffn[side]["w_up"].numpy(), np.asarray(want[side]["w_up"])[i // pat])


def test_drop_free_streams_equal_uninterrupted(served):
    tcfg, params, _, _, _ = served
    cfg = _drop_free(tcfg)
    runs = []
    for events in (EVENTS, []):
        s = ServeSession.create(cfg, params=params, device="cpu",
                                **SESSION_KW)
        runs.append(_run(s, Router(s), Request, FailureEvent, RecoveryEvent,
                         events, cfg.vocab_size))
    (toks, log), (clean, clean_log) = runs
    assert [e[1] for e in log] == [3, 2, 3, 4] and log[-1][4] > 0
    assert clean_log == [] and len(toks) == N_REQ
    assert toks == clean


def _slot_state(jm, jp, tm, tp):
    """8 slots decoded to ragged positions (prefills of 5 and 9 tokens) on
    both sides. Slots 0-5 hold one token repeated and decode it again:
    their K/V rows are equal whatever their positions, so attention hands
    every layer's FFN the same row in each, and those six slots pick the
    same experts, more than the tick's per-call capacity (2 for llama4, 5
    for arctic). Returns the caches, each slot's token and position."""
    slots, max_len = SESSION_KW["slots"], SESSION_KW["max_len"]
    jc = jm.init_slot_cache(slots, max_len, jnp.float32)
    tc = tm.init_slot_cache(slots, max_len, torch.float32)
    rng = np.random.default_rng(5)
    pos = np.where(np.arange(slots) % 2, 9, 5)
    tok = np.full(slots, 7)
    tok[6:] = rng.integers(1, jm.cfg.vocab_size, size=2)
    for n in (5, 9):
        rows = np.flatnonzero(pos == n)
        toks = np.where(rows[:, None] < 6, 7,
                        rng.integers(1, jm.cfg.vocab_size, size=(len(rows), n)))
        _, c1 = jm.prefill(jp, jnp.asarray(toks, jnp.int32),
                           jm.init_cache(len(rows), max_len, jnp.float32))
        for i, b in enumerate(rows):
            jc = jax.tree.map(lambda full, one: full.at[b].set(one[:, i:i + 1]),
                              jc, c1)
        _, t1 = tm.prefill(tp, torch.from_numpy(toks).long(),
                           tm.init_cache(len(rows), max_len, torch.float32))
        for name, leaf in tc.items():
            leaf[:, torch.from_numpy(rows)] = t1[name]
    return jc, tc, tok, pos


def test_decode_slots_dispatch_each_slot_alone(served):
    tcfg, tp, _, _, (jcfg, jengine, jp) = served
    tm = build_model(tcfg, device="cpu")
    jc, tc, tok, pos = _slot_state(jengine.model, jp, tm, tp)
    # the reference engine's jitted `decode_slots` (the session's shapes)
    jl, _ = jengine._decode(jp, jc, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32))
    ttok, tpos = torch.from_numpy(tok).long(), torch.from_numpy(pos).long()
    tc0 = {n: t.clone() for n, t in tc.items()}
    tl, _ = tm.decode_slots(tp, tc, ttok, tpos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)

    # several slots pick one expert: one dispatch of the whole tick at its
    # per-call capacity (round(8·k/E·1.25) < 8) drops some and differs
    m = tcfg.moe
    assert tmlp._capacity(m, len(tok)) < len(tok)
    x = tm._embed(tp, ttok[:, None])
    whole = tm._logits(tp, tm._trunk(tp, x, tc0, tpos, slots=False))[:, 0]
    assert (whole - tl).abs().max() > 1e-2

    # moe_apply_slots against the reference's moe_apply on each token alone
    from repro.models import mlp as jmlp

    p = jax.tree.map(lambda a: np.asarray(a)[0], jp["layers"][0]["ffn"])
    # eight tokens near one direction pick the same experts
    rng = np.random.default_rng(2)
    h = (rng.standard_normal(tcfg.d_model) + 0.1 * rng.standard_normal(
        (8, 1, tcfg.d_model))).astype(np.float32)
    want = np.stack([np.asarray(jmlp.moe_apply(jcfg, p, h[i:i + 1],
                                               NO_SHARD)[0][0])
                     for i in range(8)])
    tparams = tp["layers"][0]["ffn"]
    got = tmlp.moe_apply_slots(tcfg, tparams, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert tmlp.dropped_slots(tcfg, tparams, torch.from_numpy(h)
                              .reshape(1, 8, -1)) > 0
    with pytest.raises(ValueError, match="one token a slot"):
        tmlp.moe_apply_slots(tcfg, tparams, torch.from_numpy(h).reshape(
            1, 8, -1))


def test_route_breaks_ties_as_the_reference():
    """Probabilities that underflow to 0 tie; the reference's `lax.top_k`
    takes the lower expert id first, and so must the port, or another
    slot drops (torch.topk: 1.245 off on this input)."""
    from repro.models import mlp as jmlp

    jcfg, tcfg = _cfgs("arctic-480b")
    p = jmlp.moe_init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    p = dict(p, router=p["router"].at[:, 0].add(50.0))
    tp = {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
          {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in p.items()}
    x = np.random.default_rng(10).standard_normal(
        (1, 10, tcfg.d_model)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x)[0] @ tp["router"], -1)
    assert (probs[:, 1:] == 0).any()               # the ties are there
    want = np.asarray(jmlp.moe_apply(jcfg, p, jnp.asarray(x), NO_SHARD)[0])
    got = tmlp.moe_apply(tcfg, tp, torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def _attn_cfgs(kind):
    kw = dict(n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16, d_model=64,
              d_ff=128, vocab_size=128, window=8, chunk_size=8,
              layer_pattern=(kind,), moe=None)
    return (dataclasses.replace(jreduced(jget_arch("qwen2-7b")), **kw),
            dataclasses.replace(reduced(get_arch("qwen2-7b")), **kw))


@pytest.mark.parametrize("kind,prefill", [("attn_sw", 6), ("attn_chunked", 6),
                                          ("attn_sw", 12),
                                          ("attn_chunked", 12)])
def test_ring_cache_decode_equals_reference(kind, prefill):
    jcfg, tcfg = _attn_cfgs(kind)
    p = jattn.attn_init(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    max_len, b = 40, 2
    jcache = [jattn.init_kv_cache(jcfg, 1, max_len, jnp.float32, kind=kind)
              for _ in range(b)]
    tcache = tattn.init_kv_cache(tcfg, 1, b, max_len, torch.float32, "cpu",
                                 kind=kind)
    assert tcache["k"].shape[2] == jcache[0]["k"].shape[1] == 8
    tcache = {n: t[0] for n, t in tcache.items()}
    step = jax.jit(functools.partial(jattn.attn_apply, jcfg, kind=kind,
                                     ctx=NO_SHARD))
    rng = np.random.default_rng(6)
    # row 1 starts 3 positions later: the rows sit at ragged positions
    lens = [prefill, prefill + 3]
    for r in range(b):
        x = rng.standard_normal((1, lens[r], 64)).astype(np.float32)
        jo, jcache[r] = step(
            p, jnp.asarray(x), positions=jnp.arange(lens[r], dtype=jnp.int32),
            cache=jcache[r], cache_pos=jnp.int32(0))
        one = {n: t[r:r + 1] for n, t in tcache.items()}
        to, _ = tattn.attn_apply(tcfg, tp, torch.from_numpy(x), kind=kind,
                                 cache=one, cache_pos=0)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    pos = np.array(lens)
    for _ in range(14):        # past the window, across chunk boundaries
        x = rng.standard_normal((b, 1, 64)).astype(np.float32)
        to, _ = tattn.attn_apply(tcfg, tp, torch.from_numpy(x), kind=kind,
                                 cache=tcache,
                                 cache_pos=torch.from_numpy(pos))
        for r in range(b):
            jo, jcache[r] = step(
                p, jnp.asarray(x[r:r + 1]),
                positions=jnp.int32(pos[r]) + jnp.arange(1, dtype=jnp.int32),
                cache=jcache[r], cache_pos=jnp.int32(pos[r]))
            np.testing.assert_allclose(to[r:r + 1].numpy(), np.asarray(jo),
                                       atol=TOL)
            np.testing.assert_allclose(tcache["k"][r].numpy(),
                                       np.asarray(jcache[r]["k"][0]),
                                       atol=TOL)
        pos += 1


def test_cache_groups_and_resolver_follow_the_reference_tree():
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e", n_layers=6)
    groups = cache_groups(tcfg)
    # 6 layers over a pattern of 4: one cycle, then two tail layers
    assert groups == [(".0", "attn_chunked", [0]), (".1", "attn_chunked", [1]),
                      (".2", "attn_chunked", [2]), (".3", "attn", [3]),
                      (".t0", "attn_chunked", [4]),
                      (".t1", "attn_chunked", [5])]
    jcache = jbuild_model(jcfg).init_cache(1, 48, jnp.float32)
    jleaves = jax.tree_util.tree_leaves(jcache)
    tcache = build_model(tcfg, device="cpu").init_cache(1, 48, torch.float32)
    assert len(tcache) == len(jleaves)
    assert sorted(t.numel() for t in tcache.values()) == sorted(
        x.size for x in jleaves)
    res = cache_unit_resolver(tcfg)
    assert all(res(n).kind == "kv_head" for n in tcache)
    for bad in ("k", "k.4", "h.0", "k.t4", "k.x"):
        with pytest.raises(ValueError, match="unknown state leaf"):
            res(bad)
    with pytest.raises(ValueError, match="unknown state leaf"):
        cache_unit_resolver(reduced(get_arch("qwen2-7b")))("k.0")


def test_refusals_follow_the_reference():
    jscout, tcfg = _cfgs("llama4-scout-17b-a16e")
    # LayerNorm (whisper-small) and post-norm blocks (gemma2-9b) are
    # served, MoE FFN included
    validate_model_cfg(dataclasses.replace(tcfg, norm_type="ln"))
    validate_model_cfg(dataclasses.replace(tcfg, post_norms=True))
    whisper = reduced(get_arch("qwen2-7b"))
    from repro_torch.configs.base import EncoderSpec

    # an encoder, and attention without RoPE (absolute positions)
    validate_model_cfg(dataclasses.replace(
        whisper, encoder=EncoderSpec(n_layers=2, enc_seq=64)))
    validate_model_cfg(dataclasses.replace(tcfg, use_rope=False))
    validate_model_cfg(dataclasses.replace(
        tcfg, layer_pattern=("attn_sw", "attn", "attn_chunked")))
    # a decoder kind outside the reference's DECODER_KINDS: both refuse
    bidir = ("attn_bidir", "attn")
    with pytest.raises(ValueError, match="decoder blocks of kinds"):
        validate_model_cfg(dataclasses.replace(tcfg, layer_pattern=bidir))
    with pytest.raises(ValueError, match="serve engine supports kinds"):
        JServeEngine(dataclasses.replace(jscout, layer_pattern=bidir), None,
                     n1=4)

    # the engine's prefill_len refusals, under the reference's conditions
    cases = [(("attn_sw", "attn"), dict(window=8), 9, "sliding-window"),
             (("attn_chunked", "attn"), dict(chunk_size=8), 9, "chunked"),
             (("attn_sw", "attn"), dict(window=8), 8, None),
             (("attn_chunked", "attn"), dict(chunk_size=8), 8, None)]
    for pattern, kw, prefill_len, match in cases:
        jcfg, cfg = _cfgs("arctic-480b", layer_pattern=pattern, **kw)
        args = dict(n1=4, slots=2, max_len=16, prefill_len=prefill_len)
        if match is None:
            ServeEngine(cfg, None, model=build_model(cfg, device="cpu"),
                        **args)
            JServeEngine(jcfg, None, model=jbuild_model(jcfg), **args)
            continue
        with pytest.raises(ValueError, match=match):
            ServeEngine(cfg, None, model=build_model(cfg, device="cpu"),
                        **args)
        with pytest.raises(ValueError, match=match):
            JServeEngine(jcfg, None, model=jbuild_model(jcfg), **args)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launcher_serves_moe_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    g = main(["--arch", arch, "--device", "cpu", "--requests", "4",
              "--max-new", "4", "--log-every", "50"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "served 4/4" in out
    assert g["completed"] == 4


@pytest.mark.parametrize("arch", list(ARCHS))
def test_chip_moe_serve_phase_rehearsed_on_cpu(arch):
    """`chip_smoke.py` phase 13's serving runs at reduced widths on the
    CPU, at the phase's depth, sessions and traffic: its checks pass (TP
    path, preemptions, complete requests, the KV ledger, drop-free streams
    equal with no drop; llama4-scout's one-layer reference), and the
    launches it returns are zero (the CPU runs the plain versions)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = dataclasses.replace(reduced(get_arch(arch)),
                              n_layers=chip_smoke.MOE_SERVE_LAYERS[arch])
    (counts, kinds), clean, n_par = chip_smoke.moe_serve_model(
        torch, torch.device("cpu"), cfg, *chip_smoke.moe_serve_traffic(cfg),
        ref_layers=int("llama4" in arch))
    assert counts == dict.fromkeys(counts, 0) and kinds == {}
    assert n_par == sum(t.numel() for t in chip_smoke._leaves(clean.params))
