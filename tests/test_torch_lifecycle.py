"""The port's session lifecycle on the CPU: `PowerPolicy`, `schedule_from_trace`
and `TraceRunner` against the JAX package, the session's degradation,
quarantine and rollback paths, and the launcher's trace path.

* `PowerPolicy.decide` equal to the reference's over a grid of plans ×
  degradations, for ``ntp`` and ``ntp_pw``;
* `schedule_from_trace` lists equal for binary and mixed traces (pp 1 and
  2), and the schedule `chip_smoke.py` replays on the card pinned event by
  event;
* SDC rollback restores canonical params bit-exactly on every replica,
  across a plan change (mirrors
  `tests/test_taxonomy_properties.py::test_sdc_rollback_restores_canonical_bit_exact`);
* the port's `TraceRunner` against the JAX `TraceRunner` on a 2×4
  fake-device mesh (the JAX side in a subprocess, as
  `tests/test_torch_session.py` runs it): same canonical params, the chip's
  mixed schedule, SGD, ``ntp_pw``, quarantine on — per-step records and the
  summary equal, losses and canonical params within 1e-4;
* the launcher's ``--trace … --ckpt … --telemetry … --device cpu`` run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import failure_model as jfm
from repro.core.nonuniform import FailurePlan as JPlan
from repro.runtime import events as jev
from repro.runtime import orchestrator as jor
from repro_torch import tree as tr
from repro_torch.convert import ntp_params_from_jax
from repro_torch.core import failure_model as tfm
from repro_torch.core import ntp_train as nt
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.core.policies import WorkloadGeometry
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.optim import sgd
from repro_torch.runtime import (
    DeadReplicaError, FailureEvent, LinkDegradeEvent, NTPSession,
    RecoveryEvent, ScheduledEvent, SdcClearEvent, SdcSuspectEvent,
    StragglerEvent, TraceRunner, power_policy, schedule_from_trace,
)
from repro_torch.runtime import events as tev
from repro_torch.runtime import orchestrator as tor

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, vocab=128)
LB, SEQ = 4, 32

# the schedule chip_smoke.py replays on the card (2 replicas x TP 4)
CHIP_TRACE = dict(n_gpus=8, domain_size=4, days=16 / 1.0 / 24.0,
                  rate_multiplier=200.0, seed=136, straggler_rate_mult=2.0,
                  link_rate_mult=2.0, sdc_rate_mult=1.0)
CHIP_STEPS, CHIP_STEPS_PER_HOUR = 16, 1.0


# ------------------------------------------------------------ PowerPolicy

PLANS = [(4, 4), (3, 4), (2, 4), (1, 4), (2, 3), (4, 4, 4), (3, 3)]
DEGS = [None, "clear", "straggle", "link", "both", "sdc", "mixed"]


def _degradations(pkg, kind, d):
    C = pkg.DomainDegradation
    one = {"clear": C(), "straggle": C(straggle=(1.4,)),
           "link": C(link=(0.35,)), "both": C(straggle=(1.2, 2.6),
                                              link=(0.5, 0.8)),
           "sdc": C(sdc=1)}
    if kind is None:
        return None
    if kind == "mixed":
        seq = ["sdc", "straggle", "link", "clear"]
        return tuple(one[seq[r % 4]] for r in range(d))
    return tuple(one[kind] if r == d - 1 else C() for r in range(d))


@pytest.mark.parametrize("name", ["ntp", "ntp_pw"])
@pytest.mark.parametrize("tp", PLANS, ids=str)
def test_power_policy_decisions_match_reference(name, tp):
    n1 = max(tp)
    for lb in (1, 4, 8):
        for deg in DEGS:
            for heads in (None, 4, 6):
                jg = None if heads is None else jor.WorkloadGeometry(
                    n_heads=heads)
                tg = None if heads is None else WorkloadGeometry(n_heads=heads)
                want = jor.power_policy(name).decide(
                    JPlan(n1, tp), local_batch=lb, geom=jg,
                    degradations=_degradations(jev, deg, len(tp)))
                got = tor.power_policy(name).decide(
                    FailurePlan(n1, tp), local_batch=lb, geom=tg,
                    degradations=_degradations(tev, deg, len(tp)))
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (tp, lb, deg, heads)


def test_power_policy_names_and_refusals():
    assert tor.power_policy("NTP-PW").name == "ntp_pw"
    with pytest.raises(ValueError, match="not in"):
        tor.PowerPolicy(name="boost")
    cfg = nt.NTPModelConfig(n_layers=2, **KW)
    with pytest.raises(ValueError, match="DP_DROP"):
        NTPSession.create(cfg, (2, 4), mode="dpdrop", device="cpu",
                          power_policy=power_policy("ntp"))


# ------------------------------------------------------------ schedules

def _sched(items):
    return [(s.step, type(s.event).__name__, dataclasses.asdict(s.event))
            for s in items]


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("seed", [0, 3, 136])
@pytest.mark.parametrize("mixed", [False, True])
def test_schedule_from_trace_matches_reference(mixed, seed, pp):
    kw = dict(n_gpus=8 * pp, domain_size=4, days=2.0, rate_multiplier=300.0,
              seed=seed)
    if mixed:
        kw.update(straggler_rate_mult=2.0, link_rate_mult=1.0,
                  sdc_rate_mult=0.5)
    for steps, sph in ((16, 1.0), (40, 0.5)):
        want = jor.schedule_from_trace(jfm.FailureTraceConfig(**kw),
                                       steps=steps, steps_per_hour=sph, pp=pp)
        got = tor.schedule_from_trace(tfm.FailureTraceConfig(**kw),
                                      steps=steps, steps_per_hour=sph, pp=pp)
        assert _sched(got) == _sched(want)


def test_chip_schedule_is_pinned():
    """The 16-step schedule chip_smoke.py replays: a failure and its repair,
    a straggler and its clear, a link degrade and its repair, and an SDC
    suspicion that rolls back — the same in both packages."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.TRACE, smoke.TRACE_STEPS, smoke.TRACE_STEPS_PER_HOUR) == \
        (CHIP_TRACE, CHIP_STEPS, CHIP_STEPS_PER_HOUR)
    got = tor.schedule_from_trace(tfm.FailureTraceConfig(**CHIP_TRACE),
                                  steps=CHIP_STEPS,
                                  steps_per_hour=CHIP_STEPS_PER_HOUR)
    want = jor.schedule_from_trace(jfm.FailureTraceConfig(**CHIP_TRACE),
                                   steps=CHIP_STEPS,
                                   steps_per_hour=CHIP_STEPS_PER_HOUR)
    assert _sched(got) == _sched(want)
    slim = [(s, k, e["domain"], e.get("slowdown", e.get("bw_frac")))
            for s, k, e in _sched(got)]
    assert [x[:3] for x in slim] == [
        (0, "FailureEvent", 1), (5, "LinkDegradeEvent", 0),
        (7, "LinkRepairEvent", 0), (8, "RecoveryEvent", 1),
        (10, "SdcSuspectEvent", 1), (11, "SdcClearEvent", 1),
        (12, "StragglerEvent", 1), (15, "StragglerClearEvent", 1)]
    # each clear carries the exact severity its onset pushed
    assert slim[1][3] == slim[2][3] and 0 < slim[1][3] < 1
    assert slim[6][3] == slim[7][3] and slim[6][3] > 1


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_lifecycle_chain_is_pinned():
    """The hand chain chip_smoke.py's phase 10 (c) drives over 4 processes
    (the sampled `TRACE` needs 8 GPUs in domains of 4): every event kind
    and its inverse in 6 steps; through an emulated (2, 2) overlap-on
    NTP-PW session it degrades to TP (1, 2), quarantines replica 1 and
    rolls back once under that plan, and ends pristine."""
    smoke = _chip_smoke()
    chain = smoke._life_chain()
    assert smoke.LIFE_STEPS == 6
    assert {i: [(type(e).__name__, e.replica, e.domain,
                 getattr(e, "slowdown", getattr(e, "bw_frac", None)))
                for e in evs] for i, evs in chain.items()} == {
        1: [("FailureEvent", 1, None, None),
            ("LinkDegradeEvent", None, 1, 0.5)],
        2: [("SdcSuspectEvent", 1, None, None)],
        3: [("SdcClearEvent", 1, None, None),
            ("LinkRepairEvent", None, 1, 0.5)],
        4: [("RecoveryEvent", 0, None, None),
            ("StragglerEvent", None, 0, 2.0)],
        5: [("StragglerClearEvent", None, 0, 2.0)]}
    cfg = nt.NTPModelConfig(n_layers=2, **KW)
    s = NTPSession.create(cfg, (2, 2), local_batch=LB, optimizer=sgd(0.05),
                          params=_canonical(cfg), device="cpu", overlap=True,
                          power_policy=power_policy("ntp_pw"))
    s.snapshot()
    seen = []
    for i in range(smoke.LIFE_STEPS):
        for ev in chain.get(i, ()):
            s.apply(ev)
            seen.append((i, s.plan.replica_tp, s.last_rollback,
                         s.quarantined))
        s.step(_pipe(cfg)._batch_np(i))
    assert seen == [(1, (1, 2), False, ()), (1, (1, 2), False, ()),
                    (2, (1, 2), True, (1,)), (3, (1, 2), False, ()),
                    (3, (1, 2), False, ()), (4, (2, 2), False, ()),
                    (4, (2, 2), False, ()), (5, (2, 2), False, ())]
    assert s.health.healthy and s.health.degraded is None


# ------------------------------------------------------------- session

def _canonical(cfg, seed=0):
    return nt.init_canonical(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")


def _session(n_layers=2, **kw):
    cfg = nt.NTPModelConfig(n_layers=n_layers, **KW)
    kw.setdefault("optimizer", sgd(0.05))
    return NTPSession.create(cfg, (2, 4), local_batch=LB,
                             params=_canonical(cfg), device="cpu", **kw)


def _pipe(cfg, seed=0):
    return SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=seed))


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tr.leaves(a), tr.leaves(b)))


def test_sdc_rollback_restores_canonical_bit_exact():
    """snapshot, corrupt the packed buffers (a simulated SDC), move through
    a plan change, roll back: every replica recovers the snapshot's
    canonical content bit-exactly, params and optimizer step alike."""
    s = _session()
    want = s.canonical_params()
    s.snapshot()
    with torch.no_grad():
        for t in tr.leaves(s.params):
            t.add_(1.0)
    s.step(_pipe(s.cfg)._batch_np(0))
    assert s.opt_step == 1
    s.apply(FailureEvent(domain=0))
    assert s.plan.replica_tp == (3, 4) and not s.last_rollback
    assert s.rollback() == 0 and s.last_rollback
    for r in range(2):
        assert _bit_equal(s.canonical_params(r), want), r


def test_sdc_suspect_quarantines_and_rolls_back_in_apply():
    s = _session(power_policy=power_policy("ntp_pw"))
    pipe = _pipe(s.cfg)
    s.snapshot()
    want = s.canonical_params()
    s.step(pipe._batch_np(0))
    plan = s.apply(SdcSuspectEvent(domain=1))
    assert plan == s.plan and s.last_rollback
    assert s.quarantined == (1,) and s.local_batches == [4, 0]
    assert s.power_decision.method == "ntp_pw"
    assert _bit_equal(s.canonical_params(0), want)
    m = s.step(pipe._batch_np(1))
    assert m["policy"] == "ntp_pw" and m["power_boost"] == 1.0
    s.apply(SdcClearEvent(domain=1))
    assert not s.last_rollback and s.quarantined == ()
    assert s.local_batches == [4, 4] and s.power_decision.method == "uniform"
    assert s.health.degraded is None
    # quarantine off: the suspicion is ledgered but priced as healthy
    off = _session(quarantine=False)
    off.snapshot()
    off.apply(SdcSuspectEvent(domain=1))
    assert not off.last_rollback and off.quarantined == ()
    assert off.local_batches == [4, 4] and off.health.degraded is not None


def test_degradations_reprice_without_moving_state():
    s = _session(power_policy=power_policy("ntp"))
    before = s.params
    s.apply(StragglerEvent(domain=0, slowdown=2.0))
    assert s.params is before and s.plan.replica_tp == (4, 4)
    assert s.local_batches == [2, 4] and s.power_decision.method == "ntp"
    s.apply(LinkDegradeEvent(replica=1, bw_frac=0.5))
    assert s.local_batches == [2, 3]
    m = s.step(_pipe(s.cfg)._batch_np(0))
    assert m["policy"] == "ntp" and m["rel_iter_time"] == pytest.approx(
        s.power_decision.rel_iter_time)
    assert [type(e).__name__ for e in s.events] == \
        ["StragglerEvent", "LinkDegradeEvent"]


def test_spares_absorb_failures_at_pp1():
    s = _session(spares=1)
    s.apply(FailureEvent(domain=0))
    assert s.plan.replica_tp == (4, 4)
    s.apply(FailureEvent(domain=1))
    assert s.plan == tev.plan_from_health(s.health, spares=1)
    assert s.plan.replica_tp == (3, 4)
    with pytest.raises(DeadReplicaError):
        _session().apply(FailureEvent(domain=0, n_gpus=4))


def test_runner_rejects_dead_replicas_and_absorbs_their_repairs():
    s = _session()
    sched = [ScheduledEvent(0, FailureEvent(step=0, domain=0, n_gpus=4)),
             ScheduledEvent(2, RecoveryEvent(step=2, domain=0, n_gpus=4)),
             ScheduledEvent(3, FailureEvent(step=3, domain=1))]
    runner = TraceRunner(s, sched, verify=True)
    hist = runner.run(_pipe(s.cfg)._batch_np, 5)
    assert [t["kind"] for t in runner.transitions] == \
        ["rejected", "absorbed", "failure"]
    assert [h["replica_tp"] for h in hist] == [(4, 4)] * 3 + [(3, 4)] * 2
    summ = runner.summary()
    assert (summ["rejected"], summ["absorbed_repairs"], summ["failures"]) == \
        (1, 1, 1)


@pytest.mark.parametrize("overlap", [False, True])
def test_runner_verify_on_chip_schedule(overlap):
    """The port's TraceRunner holds the session to its dense reference at
    every step and transition through the chip schedule, the SDC rollback
    included; drained metrics are plain floats."""
    s = _session(power_policy=power_policy("ntp_pw"), overlap=overlap)
    sched = schedule_from_trace(tfm.FailureTraceConfig(**CHIP_TRACE),
                                steps=CHIP_STEPS,
                                steps_per_hour=CHIP_STEPS_PER_HOUR)
    runner = TraceRunner(s, sched, verify=True, atol=1e-4)
    hist = runner.run(_pipe(s.cfg)._batch_np, CHIP_STEPS)
    assert all(isinstance(h["loss"], float) and
               isinstance(h["grad_norm"], float) for h in hist)
    assert [t["kind"] for t in runner.transitions if t.get("rollback")] == \
        ["sdc_suspect"]
    assert all(t["canonical_err"] < 1e-4 for t in runner.transitions
               if "canonical_err" in t)
    assert hist[10]["quarantined"] == (1,)
    assert runner.summary()["rollbacks"] == 1


def test_runner_drains_every_n_steps():
    s = _session()
    runner = TraceRunner(s, [], drain_every=3)
    pipe = _pipe(s.cfg)
    runner.run(pipe._batch_np, 2)
    assert all(isinstance(h["loss"], float) for h in runner.history)
    runner.run(pipe._batch_np, 2)   # resumable: the step counter goes on
    assert [h["step"] for h in runner.history] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="fresh"):
        TraceRunner(s, [], verify=True)


# --------------------------------------------- parity with the JAX runner

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import ntp_train as nt
from repro.core.failure_model import FailureTraceConfig
from repro.data.pipeline import DataConfig, SyntheticLMPipeline
from repro.optim import sgd
from repro.runtime import NTPSession, TraceRunner, power_policy, schedule_from_trace

out_path, (KW, N_LAYERS, LB, SEQ, STEPS, SPH, TRACE, LR) = sys.argv[1], eval(sys.argv[2])
cfg = nt.NTPModelConfig(n_layers=N_LAYERS, **KW)
mesh = jax.make_mesh((2, 4), ("data", "model"))
canon = nt.init_canonical(cfg, jax.random.PRNGKey(0))
s = NTPSession.create(cfg, mesh, local_batch=LB, params=canon, overlap=True,
                      optimizer=sgd(LR), power_policy=power_policy("ntp_pw"),
                      quarantine=True)
sched = schedule_from_trace(FailureTraceConfig(**TRACE), steps=STEPS,
                            steps_per_hour=SPH)
pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
runner = TraceRunner(s, sched)
hist = runner.run(lambda i: jnp.asarray(pipe._batch_np(i)), STEPS)
keys = ("replica_tp", "local_batches", "events_applied", "policy",
        "power_boost", "rel_iter_time", "loss", "quarantined")
summary = runner.summary()
summary["final_plan"] = list(summary["final_plan"].replica_tp)
arrays = {"canonical/" + str(i): np.asarray(x)
          for i, x in enumerate(jax.tree.leaves(canon))}
for r in range(2):
    for i, x in enumerate(jax.tree.leaves(s.canonical_params(r))):
        arrays[f"end{r}/{i}"] = np.asarray(x)
arrays["meta"] = np.asarray(json.dumps({
    "history": [{k: (list(h[k]) if isinstance(h.get(k), tuple) else h.get(k))
                 for k in keys} for h in hist],
    "summary": summary}))
np.savez(out_path, **arrays)
"""


def _leaves_of(res, prefix):
    keys = sorted((k for k in res.files if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [res[k] for k in keys]


def test_trace_runner_matches_jax_runner_on_fake_mesh(tmp_path):
    steps, lr = CHIP_STEPS, 0.05
    path = str(tmp_path / "jax_runner.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, path,
         repr((KW, 2, LB, SEQ, steps, CHIP_STEPS_PER_HOUR, CHIP_TRACE, lr))],
        capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = np.load(path)
    meta = json.loads(str(res["meta"]))

    cfg = nt.NTPModelConfig(n_layers=2, **KW)
    paths = [p for p, _ in tr.leaves_with_path(_canonical(cfg))]
    numpy_tree = tr.tree_map(lambda t: None, _canonical(cfg))
    for p, v in zip(paths, _leaves_of(res, "canonical")):
        tr.set_path(numpy_tree, p, v)
    canon = ntp_params_from_jax(numpy_tree, device="cpu")
    s = NTPSession.create(cfg, (2, 4), local_batch=LB, params=canon,
                          overlap=True, optimizer=sgd(lr), device="cpu",
                          power_policy=power_policy("ntp_pw"),
                          quarantine=True)
    sched = schedule_from_trace(tfm.FailureTraceConfig(**CHIP_TRACE),
                                steps=steps,
                                steps_per_hour=CHIP_STEPS_PER_HOUR)
    runner = TraceRunner(s, sched)
    hist = runner.run(_pipe(cfg)._batch_np, steps)
    for h, j in zip(hist, meta["history"]):
        for k in ("replica_tp", "local_batches", "quarantined"):
            got = h.get(k)
            assert (list(got) if got is not None else None) == j[k], (h, j)
        for k in ("events_applied", "policy", "power_boost",
                  "rel_iter_time"):
            assert h[k] == j[k], (k, h, j)
        assert abs(h["loss"] - j["loss"]) < 1e-4, (h["step"], h, j)
    assert len(hist) == len(meta["history"]) == steps
    summ = runner.summary()
    summ["final_plan"] = list(summ["final_plan"].replica_tp)
    assert summ == meta["summary"]
    for rep in range(2):
        got = tr.leaves(s.canonical_params(rep))
        want = _leaves_of(res, f"end{rep}")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.max(np.abs(a.numpy() - b)) < 1e-4


# ------------------------------------------------------------- launcher

def test_launcher_trace_ckpt_telemetry_cpu_smoke(tmp_path, capsys):
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import main
    from repro_torch.telemetry import EVENT_KEYS, load_jsonl

    ckpt, tel = str(tmp_path / "ckpt.npz"), str(tmp_path / "run.jsonl")
    out = main(["--ntp", "--device", "cpu", "--steps", "12", "--trace", "200",
                "--trace-seed", "136", "--trace-mix",
                "straggler=2,link=2,sdc=1", "--power-policy", "ntp_pw",
                "--ckpt", ckpt, "--ckpt-every", "4", "--telemetry", tel,
                "--seq-len", "16", "--batch", "2", "--overlap", "on",
                "--log-every", "4"])
    text = capsys.readouterr().out
    assert "trace: 7 events over 12 steps" in text
    assert text.count("saved canonical checkpoint") == 2
    assert "*** step 0: failure domain 1 -> plan FailurePlan(n1=4, " \
        "replica_tp=(3, 4))" in text
    assert "rollbacks 1" in text and "final canonical checkpoint" in text
    assert out["summary"]["rollbacks"] == 1 and len(out["losses"]) == 12
    assert np.isfinite(out["losses"]).all()
    tree, step = load_checkpoint(ckpt)
    assert step > 0 and "params/embed" in tree and "opt/m/head" in tree
    evs = load_jsonl(tel)
    assert evs and all(tuple(sorted(e)) == tuple(sorted(EVENT_KEYS[e["kind"]]))
                       for e in evs)
    names = {e["name"] for e in evs}
    assert {"session.step", "session.transition", "orchestrator.event",
            "train.goodput", "kernels.dispatch"} <= names
    with pytest.raises(SystemExit):
        main(["--ntp", "--device", "cpu", "--trace-mix", "sdc=1"])
    with pytest.raises(SystemExit):
        main(["--ntp", "--device", "cpu", "--trace", "1", "--trace-mix",
              "gpu=1"])
