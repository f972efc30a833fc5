"""Serving of the port through fail→fail→repair→repair on the CPU: every
request's greedy token stream equals the JAX package's `ServeSession` on
the same parameters and requests, and equals an uninterrupted run of the
port; the reshard ledger and preemptions agree with the reference. Also
the launcher's smoke path."""
import jax
import numpy as np
import pytest

from repro.configs.base import ArchConfig as JArchConfig
from repro.runtime import FailureEvent as JFail
from repro.runtime import RecoveryEvent as JRepair
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeSession as JServeSession
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.runtime import FailureEvent, RecoveryEvent
from repro_torch.serve import Request, Router, ServeSession

# 4 KV heads over a 4-wide domain: every TP transition physically moves
# heads between ranks
CFG_KW = dict(
    arch_id="serve-failover-torch", family="dense", citation="test",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, layer_pattern=("attn",), attn_bias=True,
)
N_REQ, MAX_NEW = 16, 8
SESSION_KW = dict(replicas=1, n1=4, slots=8, max_len=48, prefill_len=16,
                  policy="ntp_pw")
EVENTS = [(7, "fail"), (10, "fail"), (24, "repair"), (28, "repair")]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, CFG_KW["vocab_size"],
                         size=int(rng.integers(4, 15))).astype(np.int32)
            for _ in range(N_REQ)]


def _run(session, router, req_cls, fail_cls, repair_cls, events):
    """Drive a session: one arrival per tick, events at fixed ticks.
    Returns ({rid: tokens}, [(tick, tp, last_reshard)], router)."""
    pending = [req_cls(rid=i, prompt=p, max_new=MAX_NEW)
               for i, p in enumerate(_prompts())]
    log = []
    tick = 0
    while pending or router.queue or session.engines[0].n_active:
        while pending and pending[0].rid <= tick:
            router.submit(pending.pop(0))
        for at, kind in events:
            if at == tick:
                ev = (fail_cls if kind == "fail" else repair_cls)(domain=0)
                router.apply(ev)
                e = session.engines[0]
                log.append((tick, e.tp, e.capacity,
                            dict(e.last_reshard), e.stats["preemptions"]))
        router.step()
        tick += 1
        assert tick < 2000
    return {r.rid: list(r.generated) for r in router.completed}, log, router


@pytest.fixture(scope="module")
def jax_run():
    jcfg = JArchConfig(**CFG_KW)
    session = JServeSession.create(jcfg, key=jax.random.PRNGKey(3),
                                   **SESSION_KW)
    toks, log, router = _run(session, JRouter(session), JRequest, JFail,
                             JRepair, EVENTS)
    params = jax.tree.map(np.asarray, session.params)
    return params, toks, log, router.goodput()


def test_port_tokens_equal_jax_through_fail_repair(jax_run):
    jparams, jtoks, jlog, jgood = jax_run
    tcfg = ArchConfig(**CFG_KW)
    params = params_from_jax(jparams, device="cpu")
    session = ServeSession.create(tcfg, params=params, device="cpu",
                                  **SESSION_KW)
    toks, log, router = _run(session, Router(session), Request, FailureEvent,
                             RecoveryEvent, EVENTS)
    assert len(toks) == N_REQ and all(len(t) == MAX_NEW for t in toks.values())
    assert toks == jtoks
    assert [e[1] for e in log] == [3, 2, 3, 4]
    # same transitions, same KV bytes moved, same preemptions
    assert log == jlog
    assert log[-1][4] > 0
    g = router.goodput()
    assert g == jgood

    # ... and equal to an uninterrupted run sharing the same weights
    clean = ServeSession.create(tcfg, params=session.params, device="cpu",
                                **SESSION_KW)
    ctoks, clog, _ = _run(clean, Router(clean), Request, FailureEvent,
                          RecoveryEvent, [])
    assert ctoks == toks and clog == []
    assert clean.params is session.params


def test_drop_policy_and_debt():
    tcfg = ArchConfig(**CFG_KW)
    s = ServeSession.create(tcfg, device="cpu", **dict(SESSION_KW, policy="drop"))
    router = Router(s)
    for p in _prompts()[:3]:
        router.submit(Request(rid=len(router.queue), prompt=p, max_new=4))
    router.step()
    assert s.engines[0].n_active == 3
    router.apply(FailureEvent(domain=0, n_gpus=5))     # clamps at 4, debt 1
    assert s.engines[0].dead and len(router.queue) == 3
    assert s.replica_tp == (0,)
    router.apply(RecoveryEvent(domain=0))              # absorbed by the debt
    assert s.transitions[-1]["kind"] == "absorbed" and s.engines[0].dead
    router.apply(RecoveryEvent(domain=0, n_gpus=4))
    assert not s.engines[0].dead and s.replica_tp == (4,)
    router.drain()
    assert len(router.completed) == 3
    with pytest.raises(ValueError, match="policy"):
        ServeSession.create(tcfg, device="cpu", policy="boost")
    with pytest.raises(TypeError, match="create"):
        ServeSession()


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    g = main(["--device", "cpu", "--requests", "6", "--max-new", "4",
              "--slo", "40", "--log-every", "5"])
    out = capsys.readouterr().out
    assert "served" in out and "device=cpu" in out
    assert g["completed"] + g["rejected"] == 6
