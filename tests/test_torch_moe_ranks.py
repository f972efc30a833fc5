"""NTP-MoE on process groups and the expert-parallel MoE FFN, on gloo with
CPU tensors.

Fast tier (4 processes a spawn):

* a 2×2 `make_test_mesh` run of the MoE session (6 experts top-2, the
  oracle's shapes of tests/dist/ntp_moe_equivalence.py) through fail → TP
  (1, 2) → repair with SGD, overlap off and on: every loss within 1e-5 of
  the port's emulated session and 1e-4 of the JAX dense reference, every
  ledger equal to the emulated one, and each replica's canonical params —
  the ``router`` among them — within 1e-5 of the emulated session's. A
  rank's router gradient holds its own experts' gates only, so a sync
  that did not sum it over ``model`` would fail the router's check. Then,
  on a (1, 4) mesh of the same processes (one expert a process),
  `models.mlp.moe_apply_expert_parallel` against the JAX package's
  `moe_apply_dense_ref` (1e-4) and `moe_apply`'s aux loss (1e-6), for
  reduced llama4-scout and arctic-480b at drop-free capacity, as
  tests/dist/moe_expert_parallel.py.

Slow tier: pp=2 on the 2×2 mesh (the stage-sequential route, microbatches
2, overlap on) and on a pp=2 × (2, 2) staged mesh (8 processes), each
through a stage-1 fail → repair against the emulated pp=2 session, and the
expert-parallel FFN on the reference's 2×4 mesh (8 processes).

Spawned ranks import this module, so JAX is imported inside the tests
only. Every spawn has a deadline and its own file store (`launch.spawn`)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.configs import get_arch, reduced
from repro_torch.core import ntp_train as nt
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.launch.mesh import make_staged_mesh, make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models import mlp as tmlp
from repro_torch.optim import sgd
from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=128,
          n_layers=2, vocab=128, n_experts=6, top_k=2)
LB, SEQ, LR = 4, 24, 0.05
STEPS = 6
CHAIN = {2: FailureEvent(step=2, replica=1), 4: RecoveryEvent(step=4, replica=0)}
PP_CHAIN = {1: FailureEvent(step=1, replica=1, stage=1),
            3: RecoveryEvent(step=3, replica=0, stage=1)}
EP_ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
DEADLINE = 180


def _cfg():
    return nt.NTPModelConfig(**KW)


def _jax_canonical():
    import jax

    from repro.core import ntp_train as jnt

    return jax.tree.map(np.asarray, jnt.init_canonical(
        jnt.NTPModelConfig(**KW), jax.random.PRNGKey(1)))


def _train(session, chain, steps):
    pipe = SyntheticLMPipeline(DataConfig(KW["vocab"], SEQ, 2 * LB, seed=0))
    out = {"loss": [], "ledgers": [], "local_batches": [], "plans": []}
    for i in range(steps):
        if i in chain:
            session.apply(chain[i])
            st = session.last_transition
            out["ledgers"].append((st.as_dict(), {
                tuple(int(x) for x in k): v for k, v in st.per_pair.items()}))
        out["loss"].append(float(session.step(pipe._batch_np(i))["loss"]))
        out["local_batches"].append(list(session.local_batches))
        out["plans"].append(session.plan)
    return out


def _numpy(tree):
    return None if tree is None else tr.tree_map(lambda t: t.numpy(), tree)


def _rank_session(canon_np, ep_cases):
    """One process of the 2×2 mesh: the chain with overlap off and on; the
    collectives a sync makes besides the unit buckets; its replica's
    canonical params; then the expert-parallel FFN of ``ep_cases`` on a
    (1, 4) mesh."""
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    canon = ntp_params_from_jax(canon_np, device="cpu")
    out = {}
    for overlap in (False, True):
        s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                              params=canon, overlap=overlap)
        run = _train(s, CHAIN, STEPS)
        run["replicated"] = s.step_fn.sync_fn.replicated_collectives
        run["canonical"] = _numpy(s.canonical_params(mesh.replica))
        out[overlap] = run
    out["ep"] = _ep_worker(1, 4, ep_cases)
    return out


def test_moe_rank_session_matches_emulated_and_dense_reference():
    import jax
    import jax.numpy as jnp

    from repro.core import ntp_train as jnt
    from repro_torch.convert import ntp_params_from_jax

    canon_np = _jax_canonical()
    ep_cases, ep_wants = _ep_cases()
    ranks = spawn(_rank_session, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np, ep_cases))
    canon = ntp_params_from_jax(canon_np, device="cpu")
    emu = {o: NTPSession.create(_cfg(), (2, 2), local_batch=LB,
                                optimizer=sgd(LR), params=canon, overlap=o,
                                device="cpu") for o in (False, True)}
    want = {o: _train(s, CHAIN, STEPS) for o, s in emu.items()}
    assert [p.replica_tp for p in want[False]["plans"]] == \
        [(2, 2)] * 2 + [(1, 2)] * 2 + [(2, 2)] * 2

    ref_grad = jax.jit(jax.value_and_grad(jnt.make_reference_loss(
        jnt.NTPModelConfig(**KW))))
    ref = jax.tree.map(jnp.asarray, canon_np)
    pipe = SyntheticLMPipeline(DataConfig(KW["vocab"], SEQ, 2 * LB, seed=0))
    ref_losses = []
    for i in range(STEPS):
        mask = jnp.asarray(np.concatenate([
            np.arange(LB) < b for b in want[False]["local_batches"][i]]),
            dtype=jnp.float32)
        rl, g = ref_grad(ref, jnp.asarray(pipe._batch_np(i)), mask)
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        ref_losses.append(float(rl))

    for got in ranks:
        _check_ep(got["ep"], ep_wants)
        for o in (False, True):
            np.testing.assert_allclose(got[o]["loss"], want[o]["loss"],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(got[o]["loss"], ref_losses, rtol=0,
                                       atol=1e-4)
            assert got[o]["ledgers"] == want[o]["ledgers"]
            assert got[o]["local_batches"] == want[o]["local_batches"]
        # per-leaf: 3 top leaves + (ln1, ln2) over data and the router over
        # model and data, a layer; bucketed: 2 chunks' rep buckets + 3 top
        # leaves + one router sum over model a layer
        assert got[False]["replicated"] == 3 + 4 * KW["n_layers"]
        assert got[True]["replicated"] == 2 + 3 + KW["n_layers"]
    for r in (0, 2):          # rank 0 of each replica
        for o in (False, True):
            got = ranks[r][o]["canonical"]
            paths = [p for p, _ in tr.leaves_with_path(got)]
            for p, a, b, c in zip(paths, tr.leaves(got),
                                  jax.tree.leaves(ref),
                                  tr.leaves(emu[o].canonical_params(r // 2))):
                assert np.max(np.abs(a - np.asarray(b))) < 1e-4, p
                assert np.max(np.abs(a - c.numpy())) < 1e-5, p
            router = got["layers"][0]["router"]
            assert np.abs(router - canon_np["layers"][0]["router"]).max() \
                > 1e-4


def _ep_worker(n_data, n_model, cases):
    """One process of an (n_data, n_model) mesh: the expert-parallel FFN of
    each case's params on its global input."""
    mesh = make_test_mesh(n_data, n_model, backend="gloo", device="cpu")
    out = []
    for arch, p_np, x_np in cases:
        cfg = _ep_cfg(arch)
        p = tr.tree_map(torch.from_numpy, p_np)
        y, aux = tmlp.moe_apply_expert_parallel(cfg, p, torch.from_numpy(x_np),
                                                mesh)
        out.append((y.numpy(), float(aux["moe_aux_loss"])))
    return out


def _ep_cfg(arch):
    cfg = reduced(get_arch(arch))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _ep_cases(batch=(8, 16)):
    """Per arch: (arch, the reference's params and input as numpy) and
    (`moe_apply_dense_ref`'s output, `moe_apply`'s aux loss)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import mlp as jmlp
    from repro.models.common import NO_SHARD

    cases, wants = [], []
    for arch in EP_ARCHS:
        jcfg = jreduced(jget_arch(arch))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(_ep_cfg(arch))
        p = jmlp.moe_init(jcfg, jax.random.PRNGKey(0), jnp.float32)
        x = jax.random.normal(jax.random.PRNGKey(1), batch + (jcfg.d_model,),
                              jnp.float32)
        # jitted: the reference's eager first calls cost seconds
        dense = jax.jit(lambda p, x: jmlp.moe_apply_dense_ref(
            jcfg, p, x, NO_SHARD))(p, x)
        _, aux = jax.jit(lambda p, x: jmlp.moe_apply(jcfg, p, x,
                                                     NO_SHARD))(p, x)
        cases.append((arch, jax.tree.map(np.array, p), np.array(x)))
        wants.append((np.asarray(dense), float(aux["moe_aux_loss"])))
    return cases, wants


def _check_ep(got, wants):
    for (y, aux), (want, want_aux) in zip(got, wants):
        assert np.abs(y - want).max() < 1e-4
        assert abs(aux - want_aux) < 1e-6


# ------------------------------------------------------------ slow tier

def _emulated_pp2(canon):
    emu = NTPSession.create(_cfg(), (2, 2), local_batch=LB, optimizer=sgd(LR),
                            params=canon, pp=2, microbatches=2, overlap=True,
                            device="cpu")
    want = _train(emu, PP_CHAIN, 4)
    assert want["plans"][1].stages[1].replica_tp == (1, 2)
    return emu, want


def _pp2_rank_session(canon_np):
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                          params=ntp_params_from_jax(canon_np, device="cpu"),
                          pp=2, microbatches=2, overlap=True)
    out = _train(s, PP_CHAIN, 4)
    out["canonical"] = _numpy(s.canonical_params(mesh.replica))
    return out


@pytest.mark.slow
def test_moe_rank_pp2_on_2d_mesh_matches_emulated_pp2():
    """pp=2 on the 2×2 mesh (the stage-sequential route): losses within
    1e-5 of the emulated pp=2 session, ledgers equal, each replica's
    canonical params (routers too) within 1e-5."""
    from repro_torch.convert import ntp_params_from_jax

    canon_np = _jax_canonical()
    ranks = spawn(_pp2_rank_session, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np,))
    emu, want = _emulated_pp2(ntp_params_from_jax(canon_np, device="cpu"))
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
        assert got["ledgers"] == want["ledgers"]
    for r in (0, 2):          # rank 0 of each replica
        for a, b in zip(tr.leaves(ranks[r]["canonical"]),
                        tr.leaves(emu.canonical_params(r // 2))):
            assert np.abs(a - b.numpy()).max() < 1e-5


def _staged_rank_session(canon_np):
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_staged_mesh(2, 2, 2, backend="gloo", device="cpu")
    canon = ntp_params_from_jax(canon_np, device="cpu")
    s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                          params=canon, pp=2, microbatches=2, overlap=True)
    out = _train(s, PP_CHAIN, 4)
    out["canonical"] = _numpy(s.canonical_params(mesh.replica, device="cpu"))
    return out


@pytest.mark.slow
def test_moe_staged_mesh_matches_emulated_pp2():
    from repro_torch.convert import ntp_params_from_jax

    canon_np = _jax_canonical()
    ranks = spawn(_staged_rank_session, 8, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np,))
    emu, want = _emulated_pp2(ntp_params_from_jax(canon_np, device="cpu"))
    for i, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
        assert got["ledgers"] == want["ledgers"]
        replica = (i // 2) % 2
        for a, b in zip(tr.leaves(got["canonical"]),
                        tr.leaves(emu.canonical_params(replica))):
            assert np.abs(a - b.numpy()).max() < 1e-5


@pytest.mark.slow
def test_moe_expert_parallel_on_2x4_matches_dense_reference():
    cases, wants = _ep_cases()
    for got in spawn(_ep_worker, 8, backend="gloo", device="cpu",
                     deadline_s=DEADLINE, args=(2, 4, cases)):
        _check_ep(got, wants)


# ------------------------------------------------------------- on a card

@pytest.mark.cuda
def test_moe_apply_at_llama4_scout_widths_on_card():
    """`chip_smoke.py` phase 12 (C): `moe_apply` at llama4-scout's full FFN
    widths (d 5120, 16 experts of d_ff 8192, gated SiLU, shared expert) on
    the card against `moe_apply_dense_ref` at drop-free capacity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the full-width FFN (8.6 GB f32) runs "
                    "on the card only")
    cfg = get_arch("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    dev = torch.device("cuda")
    p = tmlp.moe_init(cfg, torch.Generator(device=dev).manual_seed(0),
                      torch.float32)
    x = torch.randn((8, 16, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    got, aux = tmlp.moe_apply(cfg, p, x)
    want = tmlp.moe_apply_dense_ref(cfg, p, x)
    assert float((got - want).abs().max()) < 1e-4
    assert float(aux["moe_aux_loss"]) >= 0
    assert tmlp.dropped_slots(cfg, p, x) == 0
