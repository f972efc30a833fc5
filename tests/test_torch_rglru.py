"""The RG-LRU block and recurrentgemma-9b of the port on the CPU, against the
JAX package:

* `rglru_apply` against the reference's, for a full sequence from the zero
  state, for a multi-token call from a non-zero cache, and for a one-token
  step: the output, ``h`` and ``conv`` within 3e-5 in f32;
* a five-layer reduced recurrentgemma (one cycle of (rglru, rglru,
  attn_sw) and two tail layers, window 16 so that the sliding ring wraps):
  prefill logits, every cache leaf and decode against the JAX `Model`, and
  the tail carried by `params_from_jax` in execution order; a ragged
  slot decode over bf16 caches within 2e-2;
* the configs equal the reference's field for field, full and reduced,
  and the state unit families equal the reference's;
* the griffin serve chain with one KV head on TP 4 (MQA) through
  tests/test_serve.py's failover events, a TP-1 squeeze forcing
  preemptions: streams, transition records and reshard bytes equal to the
  JAX `ServeSession`'s, streams equal to an uninterrupted run;
* the launcher serves recurrentgemma-9b at reduced size on the CPU.

Weights are drawn by the reference's PRNG (norms, biases and the conv
bias nudged off their init) and carried across with
`convert.params_from_jax`; inputs come from seeded numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import rglru as jrglru
from repro.models.common import NO_SHARD
from repro.models.transformer import build_model as jbuild_model
from repro.reshard import units as junits
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeSession as JServeSession
from repro_torch import runtime as truntime
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import rglru
from repro_torch.models.transformer import build_model
from repro_torch.reshard import units
from repro_torch.serve import Request, Router, ServeSession

TOL = {"f32": 3e-5, "bf16": 2e-2}
ARCH = "recurrentgemma-9b"
# one full cycle and two tail layers; the window cut to 16 rows, so that a
# 20-token prefill masks and the rings wrap
EXTRA = dict(n_layers=5, window=16)
NUDGED = ("w", "b", "q_norm", "k_norm", "bias_a", "bias_i", "conv_b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(jreduced(jget_arch(arch)), **kw),
            dataclasses.replace(reduced(get_arch(arch)), **kw))


def nudged(jparams, seed=0):
    """The reference's params with every norm weight and bias, qk-norm
    weight, RG-LRU gate bias and conv bias moved off its init."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.normal(size=a.shape) * 0.05,
                                        a.dtype)
        if getattr(path[-1], "key", "") in NUDGED else a, jparams)


def jax_leaf(jcache, name):
    """The reference cache tree's leaf behind the port's leaf ``name``
    (`models.transformer.cache_groups`), with its layer axis."""
    base, _, group = name.partition(".")
    if not group:
        return np.asarray(jcache["layers"][0][base])
    if group.startswith("t"):
        return np.asarray(jcache["tail"][int(group[1:])][base])[None]
    return np.asarray(jcache["layers"][int(group)][base])


def assert_cache_equal(tcache, jcache, tol):
    assert len(tcache) == len(jax.tree.leaves(jcache))
    for name, leaf in tcache.items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   jax_leaf(jcache, name).astype(np.float32),
                                   atol=tol, err_msg=name)


# ---------------------------------------------------------------- the block

@pytest.mark.parametrize("case", ["zero_state", "cached", "one_token"])
def test_rglru_apply_matches_reference(case):
    jcfg, tcfg = _cfgs()
    jp = nudged(jrglru.rglru_init(jcfg, jax.random.PRNGKey(1), jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert tp["lam"].dtype == tp["bias_a"].dtype == torch.float32
    rng = np.random.default_rng(2)
    s = 1 if case == "one_token" else 13
    x = rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    di, k = tcfg.rglru.d_inner(tcfg.d_model), tcfg.rglru.d_conv
    if case == "zero_state":
        jcache = None
        tcache = {n: t[0] for n, t in rglru.init_rglru_cache(
            tcfg, 1, 2, torch.float32, "cpu").items()}
    else:
        h = rng.normal(size=(2, di)).astype(np.float32)
        conv = rng.normal(size=(2, k - 1, di)).astype(np.float32)
        jcache = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        tcache = {"h": torch.from_numpy(h.copy()),
                  "conv": torch.from_numpy(conv.copy())}
    jout, jnew = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x), NO_SHARD,
                                    cache=jcache)
    tout, _ = rglru.rglru_apply(tcfg, tp, torch.from_numpy(x), cache=tcache)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=TOL["f32"])
    for name in ("h", "conv"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jnew[name]), atol=TOL["f32"])
    if case == "zero_state":     # the cache-less call computes the same
        bare, none = rglru.rglru_apply(tcfg, tp, torch.from_numpy(x))
        assert none is None
        np.testing.assert_allclose(bare.numpy(), tout.numpy(), atol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 5, 16, 33])
def test_linear_scan_is_the_recurrence(s):
    """The log-depth scan against the sequential recurrence h_t = a_t
    h_{t-1} + b_t, from zero and folded from a state h0."""
    g = torch.Generator().manual_seed(s)
    a = torch.rand((2, s, 6), generator=g)
    b = torch.randn((2, s, 6), generator=g)
    h0 = torch.randn((2, 6), generator=g)
    a_sc, b_sc = rglru._linear_scan(a, b)
    h, want = h0, []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose((b_sc + a_sc * h0[:, None]).numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-6)


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs(**EXTRA)
    jm = jbuild_model(jcfg, remat=False)
    jp = nudged(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg, device="cpu"), tp


def test_prefill_and_decode_match_jax(models):
    """Two rows of 20 tokens prefilled into a 24-row cache (the 16-row
    sliding ring keeps the tail), then two decode steps: logits and every
    cache leaf within 3e-5."""
    jcfg, jm, jp, tcfg, tm, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(1, tcfg.vocab_size, (2, 20))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32),
                        jm.init_cache(2, 24, jnp.float32))
    tc = tm.init_cache(2, 24, torch.float32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL["f32"])
    assert sorted(tc) == sorted(
        f"{n}{s}" for s in (".0", ".1", ".t0", ".t1") for n in ("h", "conv")
    ) + ["k.2", "v.2"]
    assert tc["k.2"].shape[2] == 16 and tc["h.t1"].dtype == torch.float32
    assert_cache_equal(tc, jc, TOL["f32"])
    for pos, tok in ((20, [[3], [7]]), (21, [[11], [5]])):
        jd, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos))
        td, tc = tm.decode_step(tp, tc, torch.tensor(tok), pos)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   atol=TOL["f32"])
    assert_cache_equal(tc, jc, TOL["f32"])


def test_params_from_jax_carries_the_mixers_and_the_tail(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    assert len(tp["layers"]) == 5
    # execution order: the cycle's three blocks, then the two tail blocks
    for i, kind in enumerate(("rglru", "rglru", "attn_sw")):
        want = jax.tree.map(lambda a: np.asarray(a)[0], jp["layers"][i])
        np.testing.assert_array_equal(tp["layers"][i]["ln1"]["w"].numpy(),
                                      want["ln1"]["w"])
        assert ("lam" in tp["layers"][i]["mixer"]) == (kind == "rglru")
    for j in range(2):
        mixer = tp["layers"][3 + j]["mixer"]
        np.testing.assert_array_equal(
            mixer["lam"].numpy(), np.asarray(jp["tail"][j]["mixer"]["lam"]))
        assert mixer["lam"].dtype == mixer["bias_i"].dtype == torch.float32
        assert mixer["gate_a"].shape == (4, 64, 64)


def test_slot_decode_with_bf16_caches_matches_jax(models):
    """Ragged per-slot decode over bf16 slot caches (the serving engine's
    tick) against the reference's vmapped `decode_slots`, within 2e-2:
    each slot admitted token by token, as the engine admits a recurrent
    arch."""
    jcfg, jm, jp, tcfg, tm, tp = models
    slots, max_len = 3, 24
    jc = jm.init_slot_cache(slots, max_len, jnp.bfloat16)
    tc = tm.init_slot_cache(slots, max_len, torch.bfloat16)
    rng = np.random.default_rng(2)
    lens = [5, 9, 18]
    jstep = jax.jit(jm.decode_step)
    for b, n in enumerate(lens):
        toks = rng.integers(1, tcfg.vocab_size, n)
        j1 = jm.init_cache(1, max_len, jnp.bfloat16)
        _, j1 = jm.prefill(jp, jnp.asarray(toks[None, :1], jnp.int32), j1)
        t1 = tm.init_cache(1, max_len, torch.bfloat16)
        _, t1 = tm.prefill(tp, torch.from_numpy(toks[None, :1]).long(), t1)
        for pos in range(1, n):
            _, j1 = jstep(jp, j1, jnp.asarray(toks[None, pos:pos + 1],
                                              jnp.int32), jnp.int32(pos))
            tm.decode_step(tp, t1, torch.from_numpy(
                toks[None, pos:pos + 1]).long(), pos)
        jc = jax.tree.map(lambda full, one: full.at[b].set(one), jc, j1)
        for name, leaf in tc.items():
            leaf[:, b] = t1[name][:, 0]
    tok, pos = rng.integers(1, tcfg.vocab_size, slots), np.array(lens)
    jl, _ = jax.jit(jm.decode_slots)(jp, jc, jnp.asarray(tok, jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
    tl, _ = tm.decode_slots(tp, tc, torch.from_numpy(tok).long(),
                            torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL["bf16"])


# ----------------------------------------------------- configs and units

@pytest.mark.parametrize("arch", [ARCH, "whisper-small"])
def test_configs_match_reference(arch):
    j, t = jget_arch(arch), get_arch(arch)
    for jc, tc in ((j, t), (jreduced(j), reduced(t))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.padded_vocab() == tc.padded_vocab()
        assert jc.n_params() == tc.n_params()
    if arch == ARCH:
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.head_dim,
                t.d_ff, t.vocab_size, t.window, t.layer_pattern,
                t.rglru.block_width, t.tie_embeddings) == (
            38, 4096, 16, 1, 256, 12288, 256_000, 2048,
            ("rglru", "rglru", "attn_sw"), 128, True)
        assert round(t.n_params() / 1e7) == 852
    else:
        assert (t.n_layers, t.encoder.n_layers, t.encoder.enc_seq, t.d_model,
                t.n_heads, t.n_kv_heads, t.head_dim, t.norm_type, t.use_rope,
                t.max_position, t.vocab_size) == (
            12, 12, 1500, 768, 12, 12, 64, "ln", False, 65_536, 51_865)
        assert round(t.n_params() / 1e6) == 238


@pytest.mark.parametrize("arch", [ARCH, "whisper-small"])
def test_state_units_follow_the_reference(arch):
    for jc, tc in ((jget_arch(arch), get_arch(arch)),
                   _cfgs(arch)):
        assert units.arch_unit_counts(tc) == junits.arch_unit_counts(jc)
        assert units.serve_unit_count(tc) == junits.serve_unit_count(jc)
        for kind in dict.fromkeys(tc.layer_pattern):
            got = units._kind_state_specs(tc, kind)
            want = junits._kind_state_specs(jc, kind)
            assert {n: dataclasses.asdict(s) for n, s in got.items()} == \
                {n: dataclasses.asdict(s) for n, s in want.items()}
    if arch == ARCH:     # MQA: the coarsest family is the single KV head
        assert units.serve_unit_count(get_arch(arch)) == 1
        res = units.cache_unit_resolver(get_arch(arch))
        assert res("h.t1") == units.UnitSpec("rglru_block", 32, axis=-1,
                                             unit=128)


# --------------------------------------------------------- serve chains

N1 = 4
# tests/test_serve.py::test_griffin_failover_and_preemption_token_equivalence
GRIFFIN_EVENTS = [(2, "FailureEvent", dict(domain=0)),
                  (6, "FailureEvent", dict(domain=0, n_gpus=2)),
                  (14, "RecoveryEvent", dict(domain=0, n_gpus=2)),
                  (18, "RecoveryEvent", dict(domain=0))]
RECORD_KEYS = ("replica", "kind", "tp_from", "tp_to", "preempted",
               "rel_speed", "power_boost", "reshard")


def _records(transitions):
    return [(type(t["event"]).__name__, dataclasses.asdict(t["event"]),
             *(t.get(k) for k in RECORD_KEYS)) for t in transitions]


def serve_run(session, req_cls, ev_mod, n, seed, events, vocab, enc_fn=None):
    """tests/test_serve.py's `_run` for either package: ``n`` requests of
    4-13 tokens (`_requests`, 8 new tokens, one every 2 ticks), ``events``
    [(tick, class name, fields)] from ``ev_mod``, ``enc_fn(rng)`` each
    request's ``enc_input``. Returns ({rid: tokens}, records, stats)."""
    rng = np.random.default_rng(seed)
    pending = {}
    for i in range(n):
        r = req_cls(rid=i, prompt=rng.integers(1, vocab, size=int(
            rng.integers(4, 14))).astype(np.int32), max_new=8)
        r.arrival = 2.0 * i
        if enc_fn is not None:
            r.enc_input = enc_fn(rng)
        pending[i] = r
    router = (Router if ev_mod is truntime else JRouter)(session)
    tick = 0
    while pending or router.queue or any(e.n_active for e in session.engines):
        for rid in [r for r, q in list(pending.items())
                    if q.arrival <= tick]:
            router.submit(pending.pop(rid))
        for at, name, kw in events:
            if at == tick:
                router.apply(getattr(ev_mod, name)(**kw))
        router.step()
        tick += 1
        assert tick < 3000, "serve run did not converge"
    return ({r.rid: list(r.generated) for r in router.completed},
            _records(session.transitions), dict(session.engines[0].stats))


def chain_equals_jax(jcfg, tcfg, events, n=6, seed=7, enc_fn=None,
                     slots=4):
    """The chain on the JAX `ServeSession` and on the port's (the JAX
    session's weights) and uninterrupted on the port: streams, records
    and reshard stats equal. Returns the port's (streams, records,
    stats)."""
    kw = dict(replicas=1, n1=N1, slots=slots, max_len=64, prefill_len=16,
              policy="ntp")
    js = JServeSession.create(jcfg, key=jax.random.PRNGKey(seed), **kw)
    jrun = serve_run(js, JRequest, jruntime, n, seed, events,
                     jcfg.vocab_size, enc_fn)
    params = params_from_jax(jax.tree.map(np.asarray, js.params),
                             device="cpu")
    ts = ServeSession.create(tcfg, params=params, device="cpu", **kw)
    trun = serve_run(ts, Request, truntime, n, seed, events,
                     tcfg.vocab_size, enc_fn)
    clean = ServeSession.create(tcfg, params=params, device="cpu", **kw)
    want = serve_run(clean, Request, truntime, n, seed, [], tcfg.vocab_size,
                     enc_fn)
    assert len(trun[0]) == n and all(len(t) == 8 for t in trun[0].values())
    assert trun[0] == jrun[0] == want[0]
    assert trun[1] == jrun[1]
    for key in ("preemptions", "reshards", "reshard_bytes", "tokens",
                "prefills"):
        assert trun[2][key] == jrun[2][key], key
    return trun


def test_griffin_chain_equals_jax():
    """MQA: one KV head on TP 4 (three ranks hold none, the head never
    moves), 32 gate blocks moving through TP 4 -> 3 -> 1 -> 3 -> 4; the
    squeeze to TP 1 preempts, and the token-by-token re-admission resumes
    the same streams."""
    jcfg, tcfg = _cfgs(**EXTRA)
    assert tcfg.n_kv_heads == 1
    streams, records, stats = chain_equals_jax(jcfg, tcfg, GRIFFIN_EVENTS)
    assert [r[4:6] for r in records] == [(4, 3), (3, 1), (1, 3), (3, 4)]
    assert stats["preemptions"] >= 1 and stats["reshard_bytes"] > 0
    # the rings wrapped: some request ran past the 16-row window
    assert max(len(s) for s in streams.values()) + 13 > tcfg.window


def test_launcher_serves_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    g = launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "4", "--prompt-len", "6", "--max-new", "4",
                           "--max-len", "16", "--prefill-len", "8"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b-smoke" in out
    assert g["completed"] == 4
