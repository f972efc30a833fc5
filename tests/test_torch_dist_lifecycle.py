"""The process path's overlapped sync and lifecycle (`NTPSession` on a
`launch.mesh.RankMesh` with ``overlap=True``, a power policy, spares, every
event kind, snapshots, checkpoints, `TraceRunner` and the launcher), on gloo
with CPU tensors.

Fast tier (each spawn of 4 ranks runs several checks that share a chain):

* the overlapped rank session against the sequential rank session and the
  emulated overlap-on session through `tests/test_torch_dist.py`'s 2×2
  fail→repair chain: losses, grad norms and canonical params within 1e-5;
  the unit buckets' collectives as `sync_collectives(bucketed=True,
  chunks=...)` counts them, the replicated ones apart; one `bucket_pack`
  and one `bucket_unpack` wrapper call a bucket; `reshard_pack` on degraded
  steps only;
* `tests/dist/session_mixed_lifecycle.py`'s schedule (domain-addressed for
  a 2×2 mesh) plus a fail/repair pair, under NTP-PW with overlap on,
  through `TraceRunner(verify=True)` on the ranks: against the emulated
  session's `TraceRunner` (losses 1e-5, the history's decisions and the
  transition ledgers equal, one rollback) and the JAX package's dense
  reference (SGD under the same sample masks and the step-0 rollback,
  losses 1e-4);
* snapshot at TP (2, 2) and rollback at (1, 2), and the reverse; a save at
  one plan restored at another; each bit for bit equal to the emulated
  session's result through `pack_rank_params`; an AdamW snapshot after a
  step rolled back across a plan change equal to `pack_rank_params` of its
  own canonical state; `spares=1` absorbing a failure without a
  transition;
* the launcher's ``--nproc`` run through a mixed trace with overlap,
  NTP-PW, a checkpoint (`repro.checkpoint` loads it) and telemetry (every
  event on `EVENT_KEYS`).

Slow tier: a 2×4 AdamW lifecycle with overlap on against the emulated
session; the moments survive the rollback.

Spawned ranks import this module, so JAX is imported inside the tests only.
Every spawn has a deadline and its own file store (`launch.spawn`)."""
import json

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch import tree as tr
from repro_torch.core import collectives as C
from repro_torch.core import ntp_train as nt
from repro_torch.core import overlap as ov
from repro_torch.core import reshard as rs
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.optim import AdamWConfig, adamw, sgd
from repro_torch.runtime import (
    FailureEvent, LinkDegradeEvent, LinkRepairEvent, NTPSession,
    RecoveryEvent, ScheduledEvent, SdcClearEvent, SdcSuspectEvent,
    StragglerClearEvent, StragglerEvent, TraceRunner, power_policy,
)

KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, n_layers=2, vocab=128)
LB, SEQ, LR = 4, 32, 0.05
CHAIN = {2: FailureEvent(step=2, replica=1), 4: RecoveryEvent(step=4, replica=0)}
STEPS = 6
TRACE_STEPS = 15
DEADLINE = 120


def _cfg():
    return nt.NTPModelConfig(**KW)


def _canonical(cfg):
    return nt.init_canonical(cfg, torch.Generator().manual_seed(0),
                             device="cpu")


def _pipe(cfg):
    return SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))


def _numpy(tree):
    return None if tree is None else tr.tree_map(
        lambda t: t.detach().numpy().copy(), tree)


def mixed_schedule():
    """`tests/dist/session_mixed_lifecycle.py`'s schedule, addressed by
    domain, with domain 1 failing at step 4 and repaired at 12: the SDC
    suspicion (step 9) rolls back under TP (1, 2)."""
    return [
        ScheduledEvent(2, StragglerEvent(step=2, domain=0, slowdown=2.0)),
        ScheduledEvent(4, FailureEvent(step=4, domain=1)),
        ScheduledEvent(5, LinkDegradeEvent(step=5, domain=1, bw_frac=0.5)),
        ScheduledEvent(7, StragglerClearEvent(step=7, domain=0,
                                              slowdown=2.0)),
        ScheduledEvent(9, SdcSuspectEvent(step=9, domain=1)),
        ScheduledEvent(11, SdcClearEvent(step=11, domain=1)),
        ScheduledEvent(12, RecoveryEvent(step=12, domain=1)),
        ScheduledEvent(13, LinkRepairEvent(step=13, domain=1, bw_frac=0.5)),
    ]


def _count_wrappers():
    """Count the sync's calls of the bucket and reshard_pack wrappers (the
    CPU runs their plain versions, which no launch counter sees)."""
    calls = {"bucket_pack": 0, "bucket_unpack": 0, "reshard_pack": 0}

    def counted(module, name):
        inner = getattr(module, name)

        def call(*a):
            calls[name] += 1
            return inner(*a)

        setattr(module, name, call)

    counted(ov, "bucket_pack")
    counted(ov, "bucket_unpack")
    counted(rs, "reshard_pack")
    return calls


def _train(session, pipe, chain, steps, calls):
    """Drive ``session`` through ``chain``; per step the metrics, the
    collective counts and the wrapper calls; per event the ledger."""
    out = {"loss": [], "grad_norm": [], "ledgers": [], "counts": [],
           "calls": []}
    for i in range(steps):
        if i in chain:
            session.apply(chain[i])
            out["ledgers"].append(session.last_transition.as_dict())
        C.reset_counts()
        before = dict(calls)
        m = session.step(pipe._batch_np(i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        step = session.step_fn
        out["counts"].append((C.counts(), step.collectives,
                              getattr(step, "replicated_collectives", None),
                              getattr(step, "chunks", None)))
        out["calls"].append({k: calls[k] - before[k] for k in calls})
    return out


# ------------------------------------------------------- overlapped sync

def _rank_overlap():
    """One 2×2 process: the fail→repair chain with the sequential and the
    overlapped rank sessions, then the standalone syncs of one degraded
    step's gradients."""
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    cfg = _cfg()
    calls = _count_wrappers()
    out = {}
    for overlap in (False, True):
        s = NTPSession.create(cfg, mesh, local_batch=LB, optimizer=sgd(LR),
                              params=_canonical(cfg), overlap=overlap)
        assert s.step_fn.overlap is overlap
        out[overlap] = _train(s, _pipe(cfg), CHAIN, STEPS, calls)
        out[overlap]["canonical"] = _numpy(s.canonical_params(mesh.replica))
    # the standalone syncs of the overlapped step on a degraded plan agree
    s.apply(FailureEvent(replica=1))
    step = s.step_fn
    _, grads = nt.make_rank_train_step(
        cfg, s.plan, mesh, local_batch=LB).grads_fn(s.params,
                                                    _pipe(cfg)._batch_np(0))
    copy = tr.tree_map(torch.clone, grads)
    C.reset_counts()
    bucketed = step.sync_fn(grads)
    counts = C.counts()
    per_leaf = step.sync_off_fn(copy)
    out["sync"] = (max(float((a - b).abs().max()) for a, b in zip(
        tr.leaves(bucketed), tr.leaves(per_leaf))), counts,
        step.sync_fn.collectives, step.sync_fn.replicated_collectives)
    rec = telemetry.Recorder(sinks=[telemetry.MemorySink()])
    with telemetry.recording(rec):
        out["measure"] = s.measure_sync(_pipe(cfg)._batch_np(1))
    out["span"] = rec.sinks[0].spans("train.sync")[0]["attrs"]
    return out


def test_overlapped_rank_session_matches_sequential_and_emulated():
    """2×2 processes, fail (TP (1, 2)) → repair with SGD: the overlapped
    rank session within 1e-5 of the sequential rank session and of the
    emulated overlap-on session (losses, grad norms, canonical params); its
    unit-bucket collectives as `sync_collectives(bucketed=True, chunks=)`,
    the replicated ones counted apart; one bucket_pack and one
    bucket_unpack a bucket; reshard_pack on degraded steps only; the
    standalone bucketed sync equal to the per-leaf one."""
    cfg = _cfg()
    ranks = spawn(_rank_overlap, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE)
    emu = NTPSession.create(cfg, (2, 2), local_batch=LB, optimizer=sgd(LR),
                            params=_canonical(cfg), device="cpu",
                            overlap=True)
    want = _train(emu, _pipe(cfg), CHAIN, STEPS, {})
    plans = [FailurePlan(2, (2, 2))] * 2 + [FailurePlan(2, (1, 2))] * 2 + \
        [FailurePlan(2, (2, 2))] * 2
    chunks = ov.chunk_ranges(cfg.n_layers, 1)
    for r, got in enumerate(ranks):
        seq, ovl = got[False], got[True]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ovl[key], seq[key], rtol=0, atol=1e-5)
            np.testing.assert_allclose(ovl[key], want[key], rtol=0, atol=1e-5)
        assert ovl["ledgers"] == seq["ledgers"] == want["ledgers"]
        for a, b, c in zip(tr.leaves(ovl["canonical"]),
                           tr.leaves(seq["canonical"]),
                           tr.leaves(emu.canonical_params(r // 2))):
            assert np.max(np.abs(a - b)) < 1e-5
            assert np.max(np.abs(a - c.numpy())) < 1e-5
        for i, plan in enumerate(plans):
            counts, collectives, rep, step_chunks = ovl["counts"][i]
            assert step_chunks == chunks
            assert collectives == ov.sync_collectives(
                cfg, plan, "ntp", bucketed=True, chunks=chunks)
            # a rep bucket a chunk; final_norm, head and embed in place
            assert rep == len(chunks) + 3
            a2a = counts.get(("all_to_all", "model"), (0, 0))[0]
            data = counts[("all_reduce", "data")][0]
            # unit buckets + replicated + the loss's totals and counts
            assert a2a + data == collectives + rep + 1
            assert a2a == (0 if plan.healthy else 4 * len(chunks))
            assert counts[("all_reduce", "model")][0] == 4 * cfg.n_layers + 1
            n_buckets = 3 * len(chunks)   # attn, mlp and rep a chunk
            assert ovl["calls"][i] == {
                "bucket_pack": n_buckets, "bucket_unpack": n_buckets,
                "reshard_pack": 0 if plan.healthy else 2 * 2 * len(chunks)}
            assert seq["calls"][i]["bucket_pack"] == 0
        err, counts, collectives, rep = got["sync"]
        assert err < 1e-5
        assert collectives == ov.sync_collectives(
            cfg, FailurePlan(2, (1, 2)), "ntp", bucketed=True, chunks=chunks)
        assert rep == len(chunks) + 3
        assert counts[("all_to_all", "model")][0] + \
            counts[("all_reduce", "data")][0] == collectives + rep
        # measure_sync: the step's collectives, sync_s the max over ranks
        m = got["measure"]
        assert m["overlap"] == "on" and m["collectives"] == \
            ov.sync_collectives(cfg, FailurePlan(2, (1, 2)), "ntp",
                                bucketed=True, chunks=chunks)
        assert m["sync_s"] == m["exposed_s"] == ranks[0]["measure"]["sync_s"]
        assert {k: got["span"][k] for k in ("collectives", "sync_s")} == \
            {k: m[k] for k in ("collectives", "sync_s")}


# ------------------------------------------------------------ lifecycle

def _rank_trace(canon_np):
    """One 2×2 process: the mixed schedule through `TraceRunner(verify=
    True)` under NTP-PW with overlap on; the ledger of every transition."""
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    cfg = _cfg()
    s = NTPSession.create(cfg, mesh, local_batch=LB, optimizer=sgd(LR),
                          params=ntp_params_from_jax(canon_np, device="cpu"),
                          overlap=True, power_policy=power_policy("ntp_pw"))
    return _run_trace(s, cfg) + (_numpy(s.canonical_params(mesh.replica)),)


def _run_trace(session, cfg):
    ledgers = []
    runner = TraceRunner(
        session, mixed_schedule(), verify=True, atol=1e-4,
        on_event=lambda ev, plan: ledgers.append(
            None if session.last_transition is None
            else session.last_transition.as_dict()))
    hist = runner.run(_pipe(cfg)._batch_np, TRACE_STEPS)
    keep = ("step", "loss", "grad_norm", "replica_tp", "local_batches",
            "policy", "power_boost", "rel_iter_time", "quarantined")
    hist = [{k: h[k] for k in keep if k in h} for h in hist]
    trans = [{k: t.get(k) for k in ("step", "kind", "rollback", "old_plan",
                                    "new_plan", "canonical_err")}
             for t in runner.transitions]
    return hist, trans, ledgers, runner.summary()


def test_rank_trace_runner_matches_emulated_and_jax():
    """The mixed schedule plus a fail/repair pair through `TraceRunner(
    verify=True)` on 2×2 processes (NTP-PW, overlap on, quarantine): rank 0
    holds the dense reference at every step and transition; every rank's
    losses within 1e-5 of the emulated runner's, its history's decisions
    and its transition ledgers equal, one rollback (under TP (1, 2)); the
    JAX package's dense reference under the same masks and the step-0
    rollback within 1e-4."""
    import jax
    import jax.numpy as jnp

    from repro.core import ntp_train as jnt
    from repro_torch.convert import ntp_params_from_jax

    cfg = _cfg()
    canon_np = jax.tree.map(np.asarray, jnt.init_canonical(
        jnt.NTPModelConfig(**KW), jax.random.PRNGKey(0)))
    ranks = spawn(_rank_trace, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np,))
    emu = NTPSession.create(cfg, (2, 2), local_batch=LB, optimizer=sgd(LR),
                            params=ntp_params_from_jax(canon_np,
                                                       device="cpu"),
                            device="cpu", overlap=True,
                            power_policy=power_policy("ntp_pw"))
    w_hist, w_trans, w_ledgers, w_summary = _run_trace(emu, cfg)
    decisions = ("step", "replica_tp", "local_batches", "policy",
                 "power_boost", "rel_iter_time", "quarantined")
    for r, (hist, trans, ledgers, summary, canonical) in enumerate(ranks):
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in w_hist], rtol=0,
                                   atol=1e-5)
        assert [{k: h.get(k) for k in decisions} for h in hist] == \
            [{k: h.get(k) for k in decisions} for h in w_hist]
        assert ledgers == w_ledgers
        assert [{k: v for k, v in t.items() if k != "canonical_err"}
                for t in trans] == \
            [{k: v for k, v in t.items() if k != "canonical_err"}
             for t in w_trans]
        assert summary == w_summary and summary["rollbacks"] == 1
        checked = [t["canonical_err"] for t in trans
                   if t["canonical_err"] is not None]
        # rank 0 checks both transitions and the rollback; the others none
        assert len(checked) == (3 if r == 0 else 0) and all(
            e < 1e-4 for e in checked)
        if canonical is not None:
            for a, b in zip(tr.leaves(canonical),
                            tr.leaves(emu.canonical_params(r // 2))):
                assert np.max(np.abs(a - b.numpy())) < 1e-5
    roll = [t for t in w_trans if t["rollback"]]
    assert [(t["step"], t["kind"], t["new_plan"]) for t in roll] == \
        [(9, "sdc_suspect", FailurePlan(2, (1, 2)))]

    # the JAX package's dense reference, SGD under the same masks, rolled
    # back to its step-0 params where the session rolled back
    ref_grad = jax.jit(jax.value_and_grad(jnt.make_reference_loss(
        jnt.NTPModelConfig(**KW))))
    ref = start = jax.tree.map(jnp.asarray, canon_np)
    pipe = _pipe(cfg)
    for h in w_hist:
        if h["step"] == roll[0]["step"]:
            ref = start
        mask = jnp.asarray(np.concatenate([
            np.arange(LB) < b for b in h["local_batches"]]),
            dtype=jnp.float32)
        rl, g = ref_grad(ref, jnp.asarray(pipe._batch_np(h["step"])), mask)
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        for hist, *_ in ranks:
            assert abs(hist[h["step"]]["loss"] - float(rl)) < 1e-4


# --------------------------------------------------- snapshots, restore

def _slots(session):
    return _numpy({"params": session.params, "opt": session.opt_state})


def _rank_state(ckpt):
    """One 2×2 process: rollbacks across a plan change both ways, a
    restore at another plan, an AdamW rollback against its own canonical
    state, spares."""
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    cfg = _cfg()
    pipe = _pipe(cfg)
    out = {}
    for name, plan, event in (
            ("down", None, FailureEvent(replica=1)),
            ("up", FailurePlan(2, (1, 2)), RecoveryEvent(replica=0))):
        s = NTPSession.create(cfg, mesh, plan=plan, local_batch=LB,
                              optimizer=adamw(AdamWConfig(lr=1e-2)),
                              params=_canonical(cfg), overlap=True)
        s.snapshot()
        s.step(pipe._batch_np(0))
        s.apply(event)
        assert s.rollback() == 0 and s.last_rollback
        out[name] = (s.plan, _slots(s))
    # a checkpoint saved at (2, 2) after a step, restored at (1, 2)
    s = NTPSession.create(cfg, mesh, local_batch=LB,
                          optimizer=adamw(AdamWConfig(lr=1e-2)),
                          params=_canonical(cfg))
    s.step(pipe._batch_np(0))
    s.save(ckpt)
    s.step(pipe._batch_np(1))
    s.apply(FailureEvent(replica=1))
    out["restore"] = (s.restore(ckpt), s.plan, _slots(s))
    # an AdamW snapshot after two steps (moments set), rolled back under
    # another plan: pack_rank_params of its own canonical state
    s.step(pipe._batch_np(2))
    s.snapshot()
    want = {"params": s.canonical_params(mesh.replica),
            "m": nt.unpack_rank_params(cfg, s.opt_state["m"], s.plan, mesh),
            "v": nt.unpack_rank_params(cfg, s.opt_state["v"], s.plan, mesh)}
    s.step(pipe._batch_np(3))
    s.apply(RecoveryEvent(replica=0))
    assert s.rollback() == 2
    out["own"] = all(
        torch.equal(a, b) for k, tree in (("params", s.params),
                                          ("m", s.opt_state["m"]),
                                          ("v", s.opt_state["v"]))
        for a, b in zip(tr.leaves(tree), tr.leaves(nt.pack_rank_params(
            cfg, want[k], s.plan, mesh.replica, mesh.rank))))
    # a spare domain absorbs the failure: same plan, nothing moves
    s = NTPSession.create(cfg, mesh, local_batch=LB, optimizer=sgd(LR),
                          params=_canonical(cfg), spares=1)
    before = s.params
    plan = s.apply(FailureEvent(domain=0))
    out["spares"] = (plan, s.last_transition, s.params is before)
    out["at"] = (mesh.replica, mesh.rank)
    return out


def _rank_slice(cfg, canonical, plan, at):
    return _numpy(nt.pack_rank_params(cfg, canonical, plan, *at))


def _bit_equal(a, b):
    la, lb = tr.leaves(a), tr.leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


def test_rank_rollback_and_restore_bit_exact_across_plans(tmp_path):
    """Snapshot at TP (2, 2), rollback at (1, 2), and the reverse; a
    checkpoint saved at (2, 2) restored at (1, 2): every rank's params and
    AdamW state bit for bit equal to the emulated session's result sliced
    through `pack_rank_params`; an AdamW rollback after moments were set
    equal to `pack_rank_params` of the rank's own canonical state; a spare
    absorbs a failure without a transition."""
    cfg = _cfg()
    ckpt = str(tmp_path / "ck.npz")
    ranks = spawn(_rank_state, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(ckpt,))
    pipe = _pipe(cfg)
    emu = {}
    for name, plan, event in (
            ("down", None, FailureEvent(replica=1)),
            ("up", FailurePlan(2, (1, 2)), RecoveryEvent(replica=0))):
        s = NTPSession.create(cfg, (2, 2), plan=plan, local_batch=LB,
                              optimizer=adamw(AdamWConfig(lr=1e-2)),
                              params=_canonical(cfg), device="cpu",
                              overlap=True)
        s.snapshot()
        s.step(pipe._batch_np(0))
        s.apply(event)
        s.rollback()
        emu[name] = s
    restored = NTPSession.create(cfg, (2, 2), plan=FailurePlan(2, (1, 2)),
                                 local_batch=LB,
                                 optimizer=adamw(AdamWConfig(lr=1e-2)),
                                 params=_canonical(cfg), device="cpu")
    step = restored.restore(ckpt)
    emu["restore"] = restored
    for got in ranks:
        at = got["at"]
        for name, s in emu.items():
            plan, slots = got[name][-2:]
            assert plan == s.plan, name
            assert _bit_equal(slots["params"], _rank_slice(
                cfg, s.canonical_params(at[0]), plan, at)), name
            for k in ("m", "v"):
                assert _bit_equal(slots["opt"][k], _rank_slice(
                    cfg, nt.unpack_params(cfg, s.opt_state[k], plan, at[0]),
                    plan, at)), (name, k)
            assert int(slots["opt"]["step"]) == s.opt_step, name
        assert got["restore"][0] == step == 1
        assert got["own"]
        plan, moved, same = got["spares"]
        assert plan == FailurePlan(2, (2, 2)) and moved is None and same


# -------------------------------------------------------------- launcher

def test_launcher_nproc_trace_overlap_cpu_smoke(tmp_path, capfd):
    """`launch.train --nproc 4 --mesh 2x2 --backend gloo --overlap on
    --trace ... --power-policy ntp_pw --ckpt ... --telemetry ...`: finite
    losses, the lifecycle line, a checkpoint `repro.checkpoint` loads, a
    JSONL stream whose events keep `EVENT_KEYS`."""
    from repro.checkpoint import load_checkpoint
    from repro_torch.launch.train import main
    from repro_torch.telemetry import EVENT_KEYS

    ckpt, jsonl = str(tmp_path / "ck.npz"), str(tmp_path / "run.jsonl")
    out = main(["--ntp", "--device", "cpu", "--nproc", "4", "--mesh", "2x2",
                "--backend", "gloo", "--overlap", "on", "--steps", "12",
                "--seq-len", "16", "--batch", "2", "--log-every", "4",
                "--trace", "200", "--trace-seed", "136", "--trace-mix",
                "straggler=2,link=2,sdc=1", "--power-policy", "ntp_pw",
                "--ckpt", ckpt, "--ckpt-every", "4", "--telemetry", jsonl])
    assert len(out["losses"]) == 12 and np.isfinite(out["losses"]).all()
    assert out["summary"]["rollbacks"] == 1
    text = capfd.readouterr().out
    assert "overlap on  policy ntp_pw" in text
    assert "trace: 6 events over 12 steps" in text
    assert "rollbacks 1" in text and text.count("saved canonical") == 2
    flat, step = load_checkpoint(ckpt)
    # the SDC suspicion at step 2 rolled the optimizer back to step 0
    assert step == 10 and "params/embed" in flat and "opt/m/embed" in flat
    with open(jsonl) as f:
        events = [json.loads(line) for line in f]
    assert events and all(tuple(e) == EVENT_KEYS[e["kind"]] for e in events)
    names = {e["name"] for e in events}
    assert {"session.step", "orchestrator.events", "train.goodput"} <= names


def test_launcher_nproc_refusals():
    from repro_torch.launch.train import main

    base = ["--ntp", "--device", "cpu", "--nproc", "4", "--backend", "gloo"]
    # --mesh sizes each stage: 2 stages of 2x2 are 8 processes, not 4
    with pytest.raises(SystemExit):
        main(base + ["--pp", "2", "--microbatches", "2", "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        main(base + ["--devices", "4"])


def test_launcher_nproc_pp2_cpu_smoke(capfd):
    """``--nproc 4 --pp 2 --mesh 1x2``: a staged mesh of 4 processes (each
    holding its stage's layers), microbatches 2, a failure on stage 1;
    finite losses, the plan degrading stage 1 only."""
    from repro_torch.launch.train import main

    out = main(["--ntp", "--device", "cpu", "--nproc", "4", "--pp", "2",
                "--mesh", "1x2", "--backend", "gloo", "--microbatches", "2",
                "--steps", "4", "--fail-at", "2", "--fail-replica", "0",
                "--fail-stage", "1", "--seq-len", "16", "--batch", "2",
                "--log-every", "1"])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["plan"].stage_tp == ((2, 1),)
    text = capfd.readouterr().out
    assert "processes 4 (mesh stage=2 data=1 model=2, gloo)" in text
    assert "pp=2 stages (0, 2, 4)" in text
    assert "*** step 2: FailureEvent(replica=0, stage=1, n_gpus=1)" in text


# ------------------------------------------------------------ slow tier

def _rank_adamw_lifecycle():
    mesh = make_test_mesh(2, 4, backend="gloo", device="cpu")
    cfg = _cfg()
    s = NTPSession.create(cfg, mesh, local_batch=LB, params=_canonical(cfg),
                          optimizer=adamw(AdamWConfig(lr=1e-2)),
                          overlap=True, power_policy=power_policy("ntp"))
    return _adamw_chain(s, cfg) + (_numpy(s.canonical_params(mesh.replica)),)


ADAMW_CHAIN = {4: FailureEvent(step=4, replica=1),
               5: SdcSuspectEvent(step=5, domain=0),
               7: SdcClearEvent(step=7, domain=0),
               8: RecoveryEvent(step=8, replica=0)}


def _adamw_chain(session, cfg):
    """Two steps, a snapshot (moments set), a failure, a step, an SDC
    suspicion rolling back under TP (3, 4), its clear, the repair, steps.
    Returns the losses and whether the rollback restored params and
    moments as `pack_rank_params` of the snapshot's canonical state."""
    pipe = _pipe(cfg)
    mesh = session.rank_mesh
    losses, rolled = [], None
    for i in range(10):
        if i == 2:
            session.snapshot()
            snap = {k: nt.unpack_rank_params(
                cfg, session.params if k == "params"
                else session.opt_state[k], session.plan, mesh)
                for k in ("params", "m", "v")}
        if i in ADAMW_CHAIN:
            session.apply(ADAMW_CHAIN[i])
            if session.last_rollback:
                rolled = all(
                    torch.equal(a, b) for k in ("params", "m", "v")
                    for a, b in zip(
                        tr.leaves(session.params if k == "params"
                                  else session.opt_state[k]),
                        tr.leaves(nt.pack_rank_params(
                            cfg, snap[k], session.plan, mesh.replica,
                            mesh.rank))))
        losses.append(float(session.step(pipe._batch_np(i))["loss"]))
    return losses, rolled


@pytest.mark.slow
def test_rank_adamw_lifecycle_2x4():
    """2×4 processes, AdamW, overlap on, NTP policy: a snapshot after two
    steps, replica 1 fails, an SDC suspicion rolls every rank back under TP
    (3, 4) (params and moments equal to `pack_rank_params` of the snapshot's
    canonical state), its clear and the repair; losses within 1e-5 of the
    emulated overlap-on session through the same chain (snapshot, rollback
    and all), canonical params within 5e-4."""
    cfg = _cfg()
    ranks = spawn(_rank_adamw_lifecycle, 8, backend="gloo", device="cpu",
                  deadline_s=600)
    emu = NTPSession.create(cfg, (2, 4), local_batch=LB, device="cpu",
                            params=_canonical(cfg),
                            optimizer=adamw(AdamWConfig(lr=1e-2)),
                            overlap=True, power_policy=power_policy("ntp"))
    pipe = _pipe(cfg)
    want = []
    for i in range(10):
        if i == 2:
            emu.snapshot()
        if i in ADAMW_CHAIN:
            emu.apply(ADAMW_CHAIN[i])
            assert emu.last_rollback == (i == 5)
        want.append(float(emu.step(pipe._batch_np(i))["loss"]))
    for r, (losses, rolled, canonical) in enumerate(ranks):
        assert rolled
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
        if canonical is not None:
            for a, b in zip(tr.leaves(canonical),
                            tr.leaves(emu.canonical_params(r // 4))):
                assert np.max(np.abs(a - b.numpy())) < 5e-4
