"""NTP with the expert as the partition unit (DESIGN.md §4) and the MoE FFN
of `models/mlp.py`: the port against the JAX package on the CPU.

* the config (``k_ff``, ``is_moe``), `ntp_unit_specs` and the canonical
  shapes (``router``, expert-shaped ``A``/``B``) as the reference's;
* `_moe_local` against the reference's `_moe_local(..., model_axis=None)`
  on slot ids with a pad slot (-1) whose weights are NOT zero, so only the
  gate mask keeps it out;
* tests/dist/ntp_moe_equivalence.py at its own shapes (d 64, 4×2 heads of
  16, d_ff 128, 2 layers, vocab 128, 6 experts top-2, `FailurePlan(4, (3,
  4))`, 5 SGD steps at 0.05): the emulated session with overlap off and on
  against the JAX dense reference (losses and both replicas' canonical
  params within 1e-4; on against off within 1e-5), and pp=2 with a
  stage-1 failure and its repair;
* the fail → repair transition chain of
  tests/test_transition_engine.py::test_direct_transition_moe_expert_units
  bit for bit, with ledgers and `expected_transfer` equal;
* the session's lifecycle on an MoE config: a step-0 snapshot rolled back
  under another plan bit for bit, a canonical checkpoint (``router``
  included) restored under another plan bit for bit, and
  `TraceRunner(verify=True)` through fail, SDC rollback and repair against
  its dense reference;
* the router's gradient: no signal at top-1 (the renormalised gate is
  w/w = 1) and a real one at top-2, in both packages;
* `moe_apply` / `moe_apply_dense_ref` / capacity drops for reduced
  llama4-scout and arctic-480b (tests/test_substrate.py:139-175).

Inputs are made with numpy (or the reference's PRNG, converted) and handed
to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import ntp_train as jnt
from repro.core.nonuniform import FailurePlan as JFailurePlan
from repro.models import mlp as jmlp
from repro.models.common import NO_SHARD
from repro.reshard import transition as jtransition
from repro.reshard.units import ntp_unit_specs as jspecs
from repro_torch import tree as tr
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import ntp_params_from_jax
from repro_torch.core import ntp_train as tnt
from repro_torch.core.nonuniform import FailurePlan, StagedPlan
from repro_torch.models import mlp as tmlp
from repro_torch.optim import sgd
from repro_torch.reshard import transition as ttransition
from repro_torch.reshard.units import ntp_unit_specs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.runtime import (
    FailureEvent, NTPSession, RecoveryEvent, ScheduledEvent, SdcClearEvent,
    SdcSuspectEvent, TraceRunner, power_policy,
)

KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=128,
          n_layers=2, vocab=128, n_experts=6, top_k=2)
LR, LB, STEPS, SEQ = 0.05, 4, 5, 24


def _cfgs(**kw):
    kw = dict(KW, **kw)
    return jnt.NTPModelConfig(**kw), tnt.NTPModelConfig(**kw)


def _canon(jcfg, seed=1):
    canon_j = jnt.init_canonical(jcfg, jax.random.PRNGKey(seed))
    return canon_j, ntp_params_from_jax(jax.tree.map(np.asarray, canon_j),
                                        device="cpu")


def _max_err(ttree, jtree):
    tl, jl = tr.leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    return max(float(np.max(np.abs(a.detach().numpy() - np.asarray(b))))
               for a, b in zip(tl, jl))


def _bit_equal(ttree, jtree):
    tl, jl = tr.leaves(ttree), jax.tree.leaves(jtree)
    return len(tl) == len(jl) and all(
        np.array_equal(a.detach().numpy(), np.asarray(b))
        for a, b in zip(tl, jl))


_REF_GRAD = {}


def _ref_grad(jcfg):
    if jcfg not in _REF_GRAD:
        _REF_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            jnt.make_reference_loss(jcfg)))
    return _REF_GRAD[jcfg]


def _mask(local_batches):
    return jnp.asarray(np.concatenate(
        [(np.arange(LB) < b).astype(np.float32) for b in local_batches]))


# ----------------------------------------------------------------- config

def test_config_specs_and_shapes_match_reference():
    jcfg, tcfg = _cfgs()
    assert tcfg.is_moe and tcfg.k_ff == jcfg.k_ff == 6 and tcfg.ffu == 128
    for cfg in (jcfg, tcfg):
        assert {k: (s.kind, s.k) for k, s in jspecs(jcfg).items()} == \
            {k: (s.kind, s.k) for k, s in ntp_unit_specs(tcfg).items()}
    assert ntp_unit_specs(tcfg)["A"].kind == "expert"
    dense = tnt.NTPModelConfig(**dict(KW, n_experts=0, d_ff=256))
    assert not dense.is_moe and ntp_unit_specs(dense)["B"].kind == "rows128"
    canon_j, canon_t = _canon(jcfg)
    like = tnt.canonical_like(tcfg)
    drawn = tnt.init_canonical(tcfg, device="cpu")
    for tree in (canon_t, like, drawn):
        assert [(p, tuple(t.shape)) for p, t in tr.leaves_with_path(tree)] \
            == [(p, tuple(t.shape)) for p, t in tr.leaves_with_path(canon_t)]
    assert tuple(canon_t["layers"][0]["router"].shape) == (64, 6)
    with pytest.raises(ValueError, match="top_k"):
        tnt.NTPModelConfig(**dict(KW, top_k=7))
    # packing carries the router as a replicated leaf, bit for bit
    tplan, jplan = FailurePlan(4, (3, 4)), JFailurePlan(4, (3, 4))
    assert _bit_equal(tnt.pack_params(tcfg, canon_t, tplan),
                      jnt.pack_params(jcfg, canon_j, jplan))
    for r in range(2):
        assert _bit_equal(
            tnt.unpack_params(tcfg, tnt.pack_params(tcfg, canon_t, tplan),
                              tplan, r), canon_j)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_local_matches_reference_with_a_pad_slot(top_k):
    """One rank's slots: experts 4, 0, 5 and a pad slot (-1) holding
    random, non-zero weights: only the gate mask keeps it out (an index of
    -1 would read the last expert's gate, a clipped one expert 0's)."""
    jcfg, tcfg = _cfgs(top_k=top_k)
    rng = np.random.default_rng(3)
    d, f = KW["d_model"], KW["d_ff"]
    lp = {"router": rng.standard_normal((d, 6)).astype(np.float32) * 0.3,
          "A": rng.standard_normal((4, d, f)).astype(np.float32) * 0.1,
          "B": rng.standard_normal((4, f, d)).astype(np.float32) * 0.1}
    h = rng.standard_normal((2, 16, d)).astype(np.float32)
    uids = np.array([4, -1, 0, 5], np.int32)
    want = np.asarray(jnt._moe_local(jax.tree.map(jnp.asarray, lp),
                                     jnp.asarray(h), jnp.asarray(uids), jcfg,
                                     model_axis=None))
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    view = dict(tlp, A=tlp["A"][None], B=tlp["B"][None])
    got = tnt._moe_local(view, torch.from_numpy(h)[None],
                         torch.from_numpy(uids).long()[None, None], tcfg, 1)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    # the pad slot's weights are live: gated as expert 0 (a clipped id
    # unmasked) or as the last expert (an unclipped -1), they would count
    for stand_in in (0, 5):
        ids = torch.from_numpy(np.where(uids < 0, stand_in, uids)).long()
        wrong = tnt._moe_local(view, torch.from_numpy(h)[None],
                               ids[None, None], tcfg, 1)[0]
        assert float((wrong - got).abs().max()) > 1e-3, stand_in


# ------------------------------------------------------- training routes

def _train_against_reference(sessions, jcfg, canon_j, events, steps):
    """Step ``sessions`` (in lockstep) and the JAX dense reference through
    ``events``; returns each session's losses and the reference's losses
    and final canonical params."""
    ref, ref_grad = canon_j, _ref_grad(jcfg)
    rng = np.random.default_rng(1)
    losses = {name: [] for name in sessions}
    ref_losses = []
    for i in range(steps):
        for s in sessions.values():
            if i in events:
                s.apply(events[i])
        tokens = rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
        for name, s in sessions.items():
            losses[name].append(float(s.step(tokens)["loss"]))
        lbs = next(iter(sessions.values())).local_batches
        rl, g = ref_grad(ref, jnp.asarray(tokens), _mask(lbs))
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        ref_losses.append(float(rl))
    return losses, ref_losses, ref


def test_moe_session_matches_dense_reference_overlap_off_and_on():
    """tests/dist/ntp_moe_equivalence.py: TP (3, 4) MoE training through
    the session == the dense reference (router gating included)."""
    jcfg, tcfg = _cfgs()
    canon_j, canon_t = _canon(jcfg)
    plan = FailurePlan(4, (3, 4))
    sessions = {o: NTPSession.create(tcfg, (2, 4), plan=plan, local_batch=LB,
                                     optimizer=sgd(LR), params=canon_t,
                                     overlap=o, device="cpu")
                for o in (False, True)}
    losses, ref_losses, ref = _train_against_reference(
        sessions, jcfg, canon_j, {}, STEPS)
    np.testing.assert_allclose(losses[False], ref_losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(losses[True], losses[False], rtol=0,
                               atol=1e-5)
    for s in sessions.values():
        for r in range(2):
            assert _max_err(s.canonical_params(r), ref) < 1e-4
    # the router trained (top-2) and is held to the reference's
    r0 = ref["layers"][0]["router"]
    assert float(jnp.abs(r0 - canon_j["layers"][0]["router"]).max()) > 1e-4
    assert sessions[True].step_fn.collectives == 3 * 2 * 2


def test_moe_pp2_stage_failure_and_repair():
    """pp=2 (one layer a stage), microbatches 2, overlap off and on:
    stage 1 fails (TP (3, 4) there), then is repaired; held to the dense
    reference."""
    jcfg, tcfg = _cfgs()
    canon_j, canon_t = _canon(jcfg)
    sessions = {o: NTPSession.create(tcfg, (2, 4), local_batch=LB,
                                     optimizer=sgd(LR), params=canon_t,
                                     pp=2, microbatches=2, overlap=o,
                                     device="cpu")
                for o in (False, True)}
    events = {1: FailureEvent(step=1, replica=1, stage=1, n_gpus=1),
              3: RecoveryEvent(step=3, replica=0, stage=1, n_gpus=1)}
    plans = []
    ref, ref_grad = canon_j, _ref_grad(jcfg)
    rng = np.random.default_rng(1)
    for i in range(4):
        for s in sessions.values():
            if i in events:
                s.apply(events[i])
        plans.append(sessions[False].plan)
        tokens = rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
        got = [float(s.step(tokens)["loss"]) for s in sessions.values()]
        rl, g = ref_grad(ref, jnp.asarray(tokens),
                         _mask(sessions[False].local_batches))
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        assert abs(got[0] - float(rl)) < 1e-4 and abs(got[1] - got[0]) < 1e-5
        if i == 1:
            st = sessions[False].last_transition
            assert set(k[0] for k in st.per_pair) == {1}   # stage-local
    assert isinstance(plans[1], StagedPlan)
    assert plans[1].stages[1].replica_tp == (3, 4)
    assert plans[1].stages[0].healthy and plans[3].stages[1].healthy
    for s in sessions.values():
        for r in range(2):
            assert _max_err(s.canonical_params(r), ref) < 1e-4


def test_moe_expert_transition_chain_matches_reference():
    """(4,4) → (2,4) → (4,4) with whole experts as units (8 experts, 1
    layer, params and two moment trees): moved trees bit for bit, ledgers
    and `expected_transfer` equal to the reference's."""
    kw = dict(d_model=32, n_kv_groups=4, q_per_kv=1, head_dim=8, d_ff=64,
              unit_rows=32, n_layers=1, vocab=64, n_experts=8, top_k=2)
    jcfg, tcfg = jnt.NTPModelConfig(**kw), tnt.NTPModelConfig(**kw)
    plans = [(FailurePlan(4, tp), JFailurePlan(4, tp))
             for tp in ((4, 4), (2, 4), (4, 4))]
    jtrees = [jnt.pack_params(jcfg, jnt.init_canonical(
        jcfg, jax.random.PRNGKey(i)), plans[0][1]) for i in range(3)]
    ttrees = [ntp_params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in jtrees]
    for (told, jold), (tnew, jnew) in zip(plans, plans[1:]):
        ttrees, tst = ttransition.transition_trees(tcfg, ttrees, told, tnew)
        jtrees, jst = jtransition.transition_trees(jcfg, jtrees, jold, jnew)
        assert tst.as_dict() == jst.as_dict() and tst.moved_units > 0
        assert tst.per_pair == {tuple(int(x) for x in k): v
                                for k, v in jst.per_pair.items()}
        assert all(_bit_equal(t, j) for t, j in zip(ttrees, jtrees))
        te = ttransition.expected_transfer(tcfg, told, tnew)
        je = jtransition.expected_transfer(jcfg, jold, jnew)
        assert te.keys() == je.keys()
        assert all(np.array_equal(te[k], je[k]) for k in te)
        # an expert moves whole (its A and B rows are d·d_ff each), in
        # each of the three trees
        assert tst.bytes_moved == 3 * sum(
            int(m.sum() - np.trace(m)) * ttrees[0]["layers"][0][k][0, 0].numel()
            * 4 for k, m in te.items())
        assert ttrees[0]["layers"][0]["A"][0, 0].numel() == 32 * 64


def _torch_equal(a, b):
    la, lb = tr.leaves(a), tr.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_moe_session_lifecycle_rollback_checkpoint_and_trace(tmp_path):
    """The emulated MoE session (6 experts, top-2) through the lifecycle:
    a step-0 snapshot rolls back under a degraded plan bit for bit; a
    canonical checkpoint carries every layer's ``router`` and restores
    under another plan bit for bit; `TraceRunner(verify=True)` holds it to
    the dense reference through a failure, an SDC rollback and a repair."""
    jcfg, tcfg = _cfgs()
    _, canon_t = _canon(jcfg)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
               for _ in range(5)]

    def make(**kw):
        return NTPSession.create(tcfg, (2, 4), local_batch=LB,
                                 optimizer=sgd(LR), params=canon_t,
                                 device="cpu", **kw)

    s = make()
    want = s.canonical_params()
    assert _torch_equal(want, canon_t)
    s.snapshot()
    s.step(batches[0])
    s.apply(FailureEvent(replica=1))
    assert not s.plan.healthy
    assert s.rollback() == 0
    for r in range(2):
        assert _torch_equal(s.canonical_params(r), want), r
    # a step under the degraded plan, then a checkpoint restored under
    # another plan (replica 0 down two ranks)
    s.step(batches[1])
    path = str(tmp_path / "moe.npz")
    s.save(path)
    flat, step = load_checkpoint(path)
    assert step == s.opt_step
    assert all(f"params/layers/{l}/router" in flat
               for l in range(KW["n_layers"]))
    assert flat["params/layers/0/router"].shape == (KW["d_model"],
                                                    KW["n_experts"])
    t = make()
    t.apply(FailureEvent(replica=0, n_gpus=2))
    assert t.plan != s.plan and not t.plan.healthy
    assert t.restore(path) == s.opt_step
    saved = s.canonical_params()
    for r in range(2):
        got = t.canonical_params(r)
        assert _torch_equal(got, saved), r
        assert torch.equal(got["layers"][1]["router"],
                           saved["layers"][1]["router"])
    # the runner against its dense reference: fail, SDC rollback, repair
    sched = [ScheduledEvent(1, FailureEvent(step=1, replica=1)),
             ScheduledEvent(2, SdcSuspectEvent(step=2, replica=1)),
             ScheduledEvent(3, SdcClearEvent(step=3, replica=1)),
             ScheduledEvent(4, RecoveryEvent(step=4, replica=0))]
    runner = TraceRunner(make(power_policy=power_policy("ntp_pw")), sched,
                         verify=True, atol=1e-4)
    hist = runner.run(lambda i: batches[i], 5)
    assert len(hist) == 5 and all(np.isfinite(h["loss"]) for h in hist)
    assert [t["kind"] for t in runner.transitions if t.get("rollback")] == \
        ["sdc_suspect"]
    checked = [t["canonical_err"] for t in runner.transitions
               if "canonical_err" in t]
    assert len(checked) >= 2 and max(checked) < 1e-4


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_gradient_is_null_at_top1_and_live_at_top2(top_k):
    jcfg, tcfg = _cfgs(top_k=top_k)
    canon_j, canon_t = _canon(jcfg)
    tokens = np.random.default_rng(5).integers(0, KW["vocab"], (LB, SEQ + 1))
    mask = np.ones(LB, np.float32)
    _, g = _ref_grad(jcfg)(canon_j, jnp.asarray(tokens), jnp.asarray(mask))
    leaves = tr.tree_map(lambda t: t.clone().requires_grad_(True), canon_t)
    loss = tnt.make_reference_loss(tcfg)(leaves, torch.from_numpy(tokens),
                                         torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, tr.leaves(leaves))
    path = [p for p, _ in tr.leaves_with_path(leaves)].index(
        ("layers", 0, "router"))
    got, want = grads[path].numpy(), np.asarray(g["layers"][0]["router"])
    scale = float(np.abs(np.asarray(g["layers"][0]["A"])).max())
    if top_k == 1:
        # w/w = 1: the gate carries no gradient to the router
        assert np.abs(got).max() <= 1e-6 * scale
        assert np.abs(want).max() <= 1e-6 * scale
    else:
        assert np.abs(want).max() > 1e-3 * scale
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


# ------------------------------------------------------- models/mlp.py MoE

def _moe_pair(arch, cf, seed=0):
    jcfg = jreduced(jget_arch(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = reduced(get_arch(arch))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    p = jmlp.moe_init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, tcfg, p, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), p)


@pytest.mark.parametrize("arch,cf,batch,scale", [
    ("arctic-480b", 8.0, (2, 16), 0.5),
    ("llama4-scout-17b-a16e", 1.0, (2, 32), 1.0),
], ids=str)
def test_moe_apply_matches_reference(arch, cf, batch, scale):
    """The sort-based dispatch against the reference's at drop-free (8.0)
    and dropping (1.0) capacity, and against the dense oracle when nothing
    drops (tests/test_substrate.py:139-175)."""
    jcfg, tcfg, p, tp = _moe_pair(arch, cf)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     batch + (jcfg.d_model,))) * scale
    # jitted: the reference's eager first calls cost seconds
    want, jaux = jax.jit(lambda p, x: jmlp.moe_apply(jcfg, p, x, NO_SHARD))(
        p, jnp.asarray(x))
    got, aux = tmlp.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)
    assert abs(float(aux["moe_aux_loss"]) - float(jaux["moe_aux_loss"])) \
        < 1e-6
    assert float(aux["moe_aux_loss"]) >= 0 and torch.isfinite(got).all()
    dense = tmlp.moe_apply_dense_ref(tcfg, tp, torch.from_numpy(x))
    jdense = jax.jit(lambda p, x: jmlp.moe_apply_dense_ref(
        jcfg, p, x, NO_SHARD))(p, jnp.asarray(x))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=0,
                               atol=3e-5)
    dropped = tmlp.dropped_slots(tcfg, tp, torch.from_numpy(x))
    if cf == 8.0:
        assert dropped == 0
        assert float((got - dense).abs().max()) < 1e-4
    else:
        # the drops are the reference's: the outputs agree above, and they
        # differ from the oracle's
        assert dropped > 0 and float((got - dense).abs().max()) > 1e-3
