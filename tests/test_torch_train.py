"""The port's NTP training path against the JAX package on the CPU, at the
reference's own test size (d_model 64, 4 kv-groups, 2 or 4 layers):

* plans, packing, health→plan bridging and the synthetic token streams bit
  for bit over sweeps;
* SGD and AdamW updates on identical packed grads (3e-5);
* the port's step in UNIFORM, NTP and DP_DROP modes against the reference's
  dense `make_reference_loss` + `jax.grad` (loss and canonical params within
  1e-4 after 6 SGD steps, as tests/dist/ntp_equivalence.py), sequential and
  overlapped;
* bucketed sync equal to sequential sync, with the reference's collective
  counts;
* the transition ledger (`TransferStats`) equal to the reference's on the
  same numpy trees through fail→repair;
* the CPU launcher smoke.

Inputs are made with numpy from seeds and handed to both packages."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nonuniform as jnu
from repro.core import ntp_train as jnt
from repro.core import overlap as jov
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMPipeline as JPipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.reshard import transition as jtransition
from repro.reshard import twin as jtwin
from repro.runtime import events as jev
from repro_torch import tree as tr
from repro_torch.convert import ntp_params_from_jax
from repro_torch.core import nonuniform as tnu
from repro_torch.core import ntp_train as tnt
from repro_torch.core import overlap as tov
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.kernels import mode as kmode
from repro_torch.optim import AdamWConfig, adamw, sgd, warmup_cosine
from repro_torch.reshard import transition as ttransition
from repro_torch.reshard import twin as ttwin
from repro_torch.reshard.engine import reshard_ranks
from repro_torch.runtime import events as tev

KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, vocab=128)
LR, LB, STEPS, SEQ = 0.05, 4, 6, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(n_layers):
    return (jnt.NTPModelConfig(n_layers=n_layers, **KW),
            tnt.NTPModelConfig(n_layers=n_layers, **KW))


def _canon(jcfg, seed=0):
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


# ------------------------------------------------------------ plans, packing

PLAN_SWEEP = [(k, n1, tp) for k in (1, 2, 4, 5, 8, 12)
              for n1 in (1, 2, 4)
              for tp in itertools.product(range(1, n1 + 1), repeat=2)
              if k >= n1]


@pytest.mark.parametrize("k,n1,tp", PLAN_SWEEP)
def test_weight_plan_and_global_packing_match_reference(k, n1, tp):
    tp_ = tnu.weight_plan(k, tnu.FailurePlan(n1, tp))
    jp = jnu.weight_plan(k, jnu.FailurePlan(n1, tp))
    assert tp_.k == jp.k and tp_.buf == jp.buf
    assert np.array_equal(tp_.comp_slots, jp.comp_slots)
    assert np.array_equal(tp_.sync_slots, jp.sync_slots)
    for a, b in ((tp_.pre, jp.pre), (tp_.post, jp.post)):
        assert a.buf == b.buf and a.s_max == b.s_max
        for f in ("send_idx", "recv_idx", "stay_idx"):
            assert np.array_equal(getattr(a, f), np.asarray(getattr(b, f)))
    w = np.random.default_rng(k).standard_normal((k * 3, 5)).astype(np.float32)
    packed = tnu.pack_global(w, tp_, 3)
    assert np.array_equal(packed, jnu.pack_global(w, jp, 3))
    for r in range(len(tp)):
        assert np.array_equal(tnu.unpack_global(packed, tp_, 3, r),
                              jnu.unpack_global(packed, jp, 3, r))
    assert np.array_equal(tnu.FailurePlan(n1, tp).local_batch_fraction(6),
                          jnu.FailurePlan(n1, tp).local_batch_fraction(6))


@pytest.mark.parametrize("tp", [(4, 4), (3, 4), (2, 3), (1, 4)])
def test_pack_unpack_params_match_reference(tp):
    jcfg, tcfg = _cfgs(2)
    canon_j, canon_t = _canon(jcfg)
    packed = tnt.pack_params(tcfg, canon_t, tnu.FailurePlan(4, tp))
    jpacked = jnt.pack_params(jcfg, canon_j, jnu.FailurePlan(4, tp))
    assert _bit_equal(packed, jpacked)
    for r in range(2):
        back = tnt.unpack_params(tcfg, packed, tnu.FailurePlan(4, tp), r)
        assert _bit_equal(back, canon_j)


def test_plan_from_health_matches_reference():
    rng = np.random.default_rng(0)
    for n_dom, size, dpr in ((2, 4, 1), (4, 4, 1), (6, 8, 2), (3, 2, 1)):
        th = tev.ClusterHealth.pristine(n_dom, size, dpr)
        jh = jev.ClusterHealth.pristine(n_dom, size, dpr)
        for _ in range(40):
            fail = bool(rng.integers(0, 2))
            n = int(rng.integers(1, 3))
            if rng.integers(0, 2):
                site = dict(replica=int(rng.integers(0, n_dom // dpr)))
            else:
                site = dict(domain=int(rng.integers(0, n_dom)))
            tcls = tev.FailureEvent if fail else tev.RecoveryEvent
            jcls = jev.FailureEvent if fail else jev.RecoveryEvent
            assert th.resolve_domain(tcls(n_gpus=n, **site)) == \
                jh.resolve_domain(jcls(n_gpus=n, **site))
            th = th.apply(tcls(n_gpus=n, **site))
            jh = jh.apply(jcls(n_gpus=n, **site))
            assert th.failed == jh.failed
            for spares in (0, 1):
                try:
                    want = jev.plan_from_health(jh, spares=spares)
                except jev.DeadReplicaError:
                    with pytest.raises(tev.DeadReplicaError):
                        tev.plan_from_health(th, spares=spares)
                    continue
                got = tev.plan_from_health(th, spares=spares)
                assert (got.n1, got.replica_tp) == (want.n1, want.replica_tp)
    plan = tnu.FailurePlan(4, (3, 4))
    assert tev.ClusterHealth.from_plan(plan).failed == (1, 0)
    with pytest.raises(ValueError, match="no replica 5"):
        th.apply(tev.FailureEvent(replica=5))


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 32, 8, 0), (2048, 16, 16, 3), (152064, 8, 4, 7), (5, 64, 3, 1)])
def test_synthetic_token_streams_match_reference(vocab, seq, batch, seed):
    tp = SyntheticLMPipeline(DataConfig(vocab, seq, batch, seed=seed))
    jp = JPipeline(JDataConfig(vocab, seq, batch, seed=seed))
    assert (tp.a, tp.b) == (jp.a, jp.b)
    for step in (0, 1, 17):
        got = tp._batch_np(step)
        assert got.dtype == np.int32
        assert np.array_equal(got, jp._batch_np(step))


# --------------------------------------------------------------- optimizers

def _packed_grads(jcfg, plan, seed):
    """Random packed grads with exact-zero pad slots (the layout a synced
    gradient tree has), as numpy."""
    rng = np.random.default_rng(seed)
    canon = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        jax.tree.map(np.asarray, jnt.init_canonical(
            jcfg, jax.random.PRNGKey(seed))))
    return jax.tree.map(np.asarray, jnt.pack_params(
        jcfg, canon, jnu.FailurePlan(plan.n1, plan.replica_tp)))


@pytest.mark.parametrize("opt", ["sgd", "adamw", "adamw_sched"])
def test_optimizer_updates_match_reference(opt):
    jcfg, tcfg = _cfgs(2)
    plan = tnu.FailurePlan(4, (3, 4))
    params_np = jax.tree.map(np.asarray, jnt.pack_params(
        jcfg, jnt.init_canonical(jcfg, jax.random.PRNGKey(1)),
        jnu.FailurePlan(4, (3, 4))))
    if opt == "sgd":
        topt, jopt = sgd(0.05), jsgd(0.05)
    else:
        sched = (lambda s: warmup_cosine(s, warmup=2, total=10)) \
            if opt == "adamw_sched" else None
        jsched = (lambda s: jwarmup_cosine(s, warmup=2, total=10)) \
            if opt == "adamw_sched" else None
        topt = adamw(AdamWConfig(lr=1e-2, grad_clip=5.0), lr_schedule=sched)
        jopt = jadamw(JAdamWConfig(lr=1e-2, grad_clip=5.0),
                      lr_schedule=jsched)
    tparams = ntp_params_from_jax(params_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    tstate, jstate = topt.init(tparams), jopt.init(jparams)
    for i in range(4):
        g = _packed_grads(jcfg, plan, 10 + i)
        tg = ntp_params_from_jax(g, device="cpu")
        nw = tnt._norm_weights(tg, 2)
        jnw = jnt._norm_weights(jax.tree.map(jnp.asarray, g), 2)
        tparams, tstate, tm = topt.update(tg, tstate, tparams,
                                          norm_weights=nw)
        jparams, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, g),
                                          jstate, jparams, norm_weights=jnw)
        assert _max_err(tparams, jparams) < 3e-5
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 3e-5 * float(jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) < 1e-9
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["step"].dtype == torch.int32
        if opt != "sgd":
            assert _max_err(tstate["m"], jstate["m"]) < 3e-5
            assert _max_err(tstate["v"], jstate["v"]) < 3e-5
    # pad slots stay exact zeros through the updates (weight decay too)
    pad = torch.from_numpy(tnu.weight_plan(4, plan).comp_slots
                           .reshape(2, -1) < 0)
    assert pad.any()
    assert tparams["layers"][0]["wq"][pad].abs().max() == 0


# ------------------------------------------- the step vs the dense reference

MODE_CASES = [
    # (mode, replica_tp, replicas held to the dense reference)
    ("ntp", (3, 4), (0, 1)),
    ("ntp", (2, 4), (0, 1)),
    ("uniform", (4, 4), (0, 1)),
    # DP_DROP: the degraded replica contributes nothing and its buffers are
    # not in the healthy layout, so only the healthy replica follows the
    # dense reference (the reference step does the same)
    ("dpdrop", (3, 4), (1,)),
]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode,rtp,held", MODE_CASES)
def test_step_matches_dense_reference(mode, rtp, held, overlap):
    n_layers = 4 if overlap else 2
    jcfg, tcfg = _cfgs(n_layers)
    canon_j, canon_t = _canon(jcfg)
    plan = tnu.FailurePlan(4, rtp)
    jplan = jnu.FailurePlan(4, rtp)
    step = tnt.make_ntp_train_step(tcfg, plan, (2, 4), mode=mode,
                                   local_batch=LB, optimizer=sgd(LR),
                                   overlap=overlap)
    packed = tnt.pack_params(tcfg, canon_t, plan)
    opt = sgd(LR).init(packed)
    lb = jnt.default_local_batches(jplan, jnt.Mode.coerce(mode), LB)
    mask = jnp.asarray(np.concatenate(
        [(np.arange(LB) < lb[d]).astype(np.float32) for d in range(2)]))
    ref_grad = jax.jit(jax.value_and_grad(jnt.make_reference_loss(jcfg)))
    ref = canon_j
    rng = np.random.default_rng(0)
    for i in range(STEPS):
        tokens = rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
        packed, opt, m = step(packed, opt, tokens.astype(np.int32))
        rl, g = ref_grad(ref, jnp.asarray(tokens), mask)
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        assert abs(float(m["loss"]) - float(rl)) < 1e-4, (i, mode)
    for r in held:
        assert _max_err(tnt.unpack_params(tcfg, packed, plan, r), ref) < 1e-4
    assert int(opt["step"]) == STEPS


def test_reference_loss_and_grad_match_jax():
    jcfg, tcfg = _cfgs(2)
    canon_j, canon_t = _canon(jcfg, seed=3)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, KW["vocab"], (5, SEQ + 1))
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    jl, jg = jax.value_and_grad(jnt.make_reference_loss(jcfg))(
        canon_j, jnp.asarray(tokens), jnp.asarray(mask))
    leaves = tr.tree_map(lambda t: t.clone().requires_grad_(True), canon_t)
    tl = tnt.make_reference_loss(tcfg)(
        leaves, torch.from_numpy(tokens.astype(np.int32)),
        torch.from_numpy(mask))
    grads = torch.autograd.grad(tl, tr.leaves(leaves))
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    for a, b in zip(grads, jax.tree.leaves(jg)):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-5


# ------------------------------------------------ bucketed vs sequential sync

@pytest.mark.parametrize("mode,rtp", [("ntp", (4, 4)), ("ntp", (3, 4)),
                                      ("ntp", (2, 3)), ("uniform", (4, 4)),
                                      ("dpdrop", (3, 4))])
def test_bucketed_sync_equals_sequential(mode, rtp):
    n1 = max(rtp)
    plan = tnu.FailurePlan(n1, rtp)
    jplan = jnu.FailurePlan(n1, rtp)
    kw = dict(KW, n_kv_groups=6, d_ff=384, n_layers=4)
    tcfg, jcfg = tnt.NTPModelConfig(**kw), jnt.NTPModelConfig(**kw)
    grads = ntp_params_from_jax(_packed_grads(jcfg, plan, 5), device="cpu")
    # per-replica grads differ (pre-sync), pad slots zero
    for lp in grads["layers"]:
        for k in tnt.UNIT_KEYS:
            lp[k][1] *= 0.5
    seq = tov.make_sync_grads(tcfg, plan, mode=mode, bucketed=False)
    bkt = tov.make_sync_grads(tcfg, plan, mode=mode, bucketed=True)
    # the per-leaf sync consumes its grads: give it a copy
    a, b = seq(tr.tree_map(torch.clone, grads)), bkt(grads)
    for x, y in zip(tr.leaves(a), tr.leaves(b)):
        if plan.healthy or mode != "ntp":
            assert torch.equal(x, y)
        else:
            assert (x - y).abs().max() < 1e-4
    for bucketed in (False, True):
        assert (bkt if bucketed else seq).collectives == jov.sync_collectives(
            jcfg, jplan, mode, bucketed=bucketed)
    step = tnt.make_ntp_train_step(tcfg, plan, mode=mode, overlap=True)
    assert step.chunks == jov.chunk_ranges(4, 1)
    assert step.collectives == jov.sync_collectives(
        jcfg, jplan, mode, bucketed=True, chunks=step.chunks)


def test_collective_counts_at_four_layers():
    jcfg, tcfg = _cfgs(4)
    healthy, degraded = tnu.FailurePlan(4, (4, 4)), tnu.FailurePlan(4, (3, 4))
    chunks = tov.chunk_ranges(4, 1)
    assert chunks == ((0, 1), (1, 2), (2, 3), (3, 4))
    assert tov.sync_collectives(tcfg, healthy, "ntp", bucketed=False) == 24
    assert tov.sync_collectives(tcfg, healthy, "ntp", bucketed=True,
                                chunks=chunks) == 8
    assert tov.sync_collectives(tcfg, degraded, "ntp", bucketed=False) == 72
    assert tov.sync_collectives(tcfg, degraded, "ntp", bucketed=True,
                                chunks=chunks) == 24
    for c in (True, "on", "1"):
        assert tov.coerce_overlap(c) is True
    with pytest.raises(ValueError, match="on/off"):
        tov.coerce_overlap("maybe")


def test_sync_keeps_pad_slots_exact_zero():
    jcfg, tcfg = _cfgs(2)
    plan = tnu.FailurePlan(4, (2, 4))
    grads = ntp_params_from_jax(_packed_grads(jcfg, plan, 9), device="cpu")
    out = tov.make_sync_grads(tcfg, plan, mode="ntp", bucketed=True)(grads)
    wp = tnu.weight_plan(tcfg.k_ff, plan)
    pad = torch.from_numpy((wp.comp_slots < 0).reshape(2, -1))
    for lp in out["layers"]:
        assert lp["A"][pad].abs().max() == 0 and lp["B"][pad].abs().max() == 0


# ----------------------------------------------------- fail/repair ledger

@pytest.mark.parametrize("k,n1,tp", [(4, 4, (3, 4)), (12, 4, (2, 4)),
                                     (6, 3, (2, 3)), (8, 4, (1, 3))])
def test_emulated_all_to_all_matches_reference_twin(k, n1, tp):
    """The port's message-table emulation, its reshard route (through the
    plain reshard_pack) and the reference's numpy twin agree bit for bit on
    every replica's pre- and post-sync tables; pad slots come out zero."""
    wp = tnu.weight_plan(k, tnu.FailurePlan(n1, tp))
    rng = np.random.default_rng(k)
    for stacked in (wp.pre, wp.post):
        for d in range(len(tp)):
            tables = stacked.replica(d)
            x = rng.standard_normal((n1, wp.buf, 3)).astype(np.float32)
            want = jtwin.emulate_tables(x, tables)
            got = ttwin.emulate_tables(torch.from_numpy(x), tables)
            assert np.array_equal(got.numpy(), want)
            assert torch.equal(reshard_ranks(torch.from_numpy(x), tables),
                               got)
            assert stacked.replica(d) is tables

@pytest.mark.parametrize("chain", [
    [(4, 4), (3, 4), (4, 4)],
    [(4, 4), (3, 4), (2, 4), (3, 4), (4, 4)],
    [(4, 4), (2, 3), (4, 4)],
])
def test_transition_ledger_matches_reference(chain):
    jcfg, tcfg = _cfgs(2)
    rng = np.random.default_rng(4)
    n1 = 4
    plans = [(tnu.FailurePlan(n1, c), jnu.FailurePlan(n1, c)) for c in chain]
    canon_j = jnt.init_canonical(jcfg, jax.random.PRNGKey(2))
    jparams = jnt.pack_params(jcfg, canon_j, plans[0][1])
    jopt = jadamw().init(jparams)
    jopt = dict(jopt, m=jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
        * (p != 0), jparams))
    jtrees = [jparams, jopt["m"], jopt["v"]]
    ttrees = [ntp_params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in jtrees]
    for (told, jold), (tnew, jnew) in zip(plans, plans[1:]):
        ttrees, tst = ttransition.transition_trees(tcfg, ttrees, told, tnew)
        jtrees, jst = jtransition.transition_trees(jcfg, jtrees, jold, jnew)
        assert tst.as_dict() == jst.as_dict()
        assert tst.per_pair == {tuple(int(x) for x in k): v
                                for k, v in jst.per_pair.items()}
        for t, j in zip(ttrees, jtrees):
            assert _bit_equal(t, j)
        te = ttransition.expected_transfer(tcfg, told, tnew)
        je = jtransition.expected_transfer(jcfg, jold, jnew)
        assert te.keys() == je.keys()
        assert all(np.array_equal(te[k], je[k]) for k in te)
    same, st = ttransition.transition_trees(tcfg, ttrees, plans[-1][0],
                                            plans[-1][0])
    assert st.as_dict()["bytes_moved"] == 0 and _bit_equal(same[0], jtrees[0])
    assert same[0]["embed"] is not ttrees[0]["embed"]


# -------------------------------------------------------------- entry points

def test_launcher_cpu_smoke(capsys):
    from repro_torch.launch.train import main

    out = main(["--ntp", "--device", "cpu", "--steps", "4", "--fail-at", "2",
                "--seq-len", "16", "--batch", "2", "--overlap", "on",
                "--log-every", "1"])
    text = capsys.readouterr().out
    assert "plan FailurePlan(n1=4, replica_tp=(4, 4))" in text
    assert ("*** step 2: FailureEvent(replica=1, n_gpus=1) -> plan "
            "FailurePlan(n1=4, replica_tp=(3, 4)) mode ntp") in text
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["plan"] == tnu.FailurePlan(4, (3, 4))
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])


def test_unported_features_raise():
    # MoE is ported (tests/test_torch_moe.py): experts are the FFN units
    assert tnt.NTPModelConfig(n_experts=4).k_ff == 4
    with pytest.raises(ValueError, match="top_k"):
        tnt.NTPModelConfig(n_experts=4, top_k=5)
    _, tcfg = _cfgs(2)
    # pp>1 and microbatches are ported: they build steps, and a microbatch
    # count that does not divide the local batch is refused
    staged = tnu.StagedPlan((tnu.FailurePlan(4, (4, 4)),) * 2)
    assert tnt.make_ntp_train_step(tcfg, staged).collectives == 12
    with pytest.raises(ValueError, match="not divisible"):
        tnt.make_ntp_train_step(tcfg, tnu.FailurePlan(4, (4, 4)),
                                microbatches=3)
    with pytest.raises(ValueError, match="does not fit mesh"):
        tnt.make_ntp_train_step(tcfg, tnu.FailurePlan(4, (4, 4)), (2, 8))
    with pytest.raises(ValueError, match="outside"):
        tnt.make_ntp_train_step(tcfg, tnu.FailurePlan(4, (4, 4)),
                                local_batches=[5, 0], local_batch=4)
    assert kmode.resolve_device("cpu") == torch.device("cpu")
