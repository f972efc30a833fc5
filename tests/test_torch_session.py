"""The port's training session (`repro_torch.runtime.NTPSession`) on the
CPU: through fail→repair against a dense reference trained in lockstep
(loss every step, canonical params of both replicas after), overlap on
against overlap off, the transition ledger against `expected_transfer`,
and the features that are not ported yet raising.

One parity test holds the port's session against the JAX package's
`NTPSession` on a 2×4 fake-device mesh through fail→repair with AdamW and
the overlapped sync, plus the reference's bare step in UNIFORM, NTP and
DP_DROP at TP (3, 4): the JAX side runs in a subprocess started from this
file, because ``XLA_FLAGS`` must be set before jax is imported."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.core import ntp_train as nt
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.optim import AdamWConfig, adamw, sgd
from repro_torch.reshard.transition import expected_transfer
from repro_torch.runtime import (
    ClusterHealth, FailureEvent, NTPSession, RecoveryEvent,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, vocab=128)
LB, SEQ, STEPS = 4, 32, 6
EVENTS = {2: ("fail", 1), 4: ("repair", 0)}   # replica-addressed


def _event(i):
    kind, replica = EVENTS[i]
    cls = FailureEvent if kind == "fail" else RecoveryEvent
    return cls(step=i, replica=replica)


def _canonical(cfg, seed=0):
    return nt.init_canonical(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")


def _unit_bytes(cfg, name, trees=1):
    shape = {"wq": (cfg.d_model, cfg.q_per_kv * cfg.head_dim),
             "wk": (cfg.d_model, cfg.head_dim),
             "wv": (cfg.d_model, cfg.head_dim),
             "wo": (cfg.q_per_kv * cfg.head_dim, cfg.d_model),
             "A": (cfg.d_model, cfg.unit_rows),
             "B": (cfg.unit_rows, cfg.d_model)}[name]
    return int(np.prod(shape)) * 4 * cfg.n_layers * trees


def _expected_bytes(cfg, old, new, trees):
    return sum(
        int(m.sum() - np.trace(m)) * _unit_bytes(cfg, name, trees)
        for name, m in expected_transfer(cfg, old, new).items())


@pytest.mark.parametrize("overlap", [False, True])
def test_session_fail_repair_matches_dense_reference(overlap):
    """SGD through UNIFORM → fail (TP (3, 4), NTP) → repair, in lockstep
    with one dense canonical copy under the same sample masks."""
    cfg = nt.NTPModelConfig(n_layers=4, **KW)
    canon = _canonical(cfg)
    lr = 0.05
    s = NTPSession.create(cfg, (2, 4), mode="uniform", local_batch=LB,
                          optimizer=sgd(lr), params=canon, overlap=overlap,
                          device="cpu")
    ref = tr.tree_map(torch.clone, canon)
    ref_loss = nt.make_reference_loss(cfg)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
    plans = [s.plan]
    for i in range(STEPS):
        if i in EVENTS:
            old = s.plan
            new = s.apply(_event(i))
            plans.append(new)
            assert s.last_transition.bytes_moved == _expected_bytes(
                cfg, old, new, trees=1)
        tokens = pipe._batch_np(i)
        m = s.step(tokens)
        lb = s.local_batches
        mask = torch.tensor(np.concatenate(
            [np.arange(LB) < lb[d] for d in range(2)]), dtype=torch.float32)
        leaves = tr.tree_map(lambda t: t.requires_grad_(True), ref)
        rl = ref_loss(leaves, torch.from_numpy(tokens), mask)
        grads = torch.autograd.grad(rl, tr.leaves(leaves))
        with torch.no_grad():
            ref = tr.tree_map(lambda t: t.detach(), ref)
            for p, g in zip(tr.leaves(ref), grads):
                p.sub_(lr * g)
        assert abs(float(m["loss"]) - float(rl.detach())) < 1e-4, i
    assert [p.replica_tp for p in plans] == [(4, 4), (3, 4), (4, 4)]
    assert s.mode is nt.Mode.NTP
    assert s.step_fn.overlap is overlap
    for r in range(2):
        got = s.canonical_params(r)
        err = max(float((a - b).abs().max())
                  for a, b in zip(tr.leaves(got), tr.leaves(ref)))
        assert err < 1e-4, (r, err)


def test_session_overlap_on_and_off_agree():
    cfg = nt.NTPModelConfig(n_layers=4, **KW)
    canon = _canonical(cfg, seed=1)
    kw = dict(local_batch=LB, optimizer=adamw(AdamWConfig(lr=1e-2)),
              params=canon, device="cpu")
    on = NTPSession.create(cfg, (2, 4), overlap=True, **kw)
    off = NTPSession.create(cfg, (2, 4), overlap=False, **kw)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=1))
    for i in range(STEPS):
        if i in EVENTS:
            on.apply(_event(i))
            off.apply(_event(i))
            assert on.last_transition.as_dict() == \
                off.last_transition.as_dict()
        a = on.step(pipe._batch_np(i))
        b = off.step(pipe._batch_np(i))
        assert abs(float(a["loss"]) - float(b["loss"])) < 1e-5
    assert on.step_fn.collectives == 8 and off.step_fn.collectives == 24
    for r in range(2):
        err = max(float((x - y).abs().max()) for x, y in zip(
            tr.leaves(on.canonical_params(r)),
            tr.leaves(off.canonical_params(r))))
        assert err < 1e-4


def test_session_ledger_with_adamw_moments():
    cfg = nt.NTPModelConfig(n_layers=2, **KW)
    s = NTPSession.create(cfg, (2, 4), local_batch=LB, params=_canonical(cfg),
                          device="cpu")
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=2))
    s.step(pipe._batch_np(0))
    old = s.plan
    new = s.apply(FailureEvent(replica=0, n_gpus=2))
    assert new == FailurePlan(4, (2, 4))
    # params + AdamW m + v ride the same messages
    assert s.last_transition.bytes_moved == _expected_bytes(cfg, old, new, 3)
    assert s.opt_step == 1 and s.opt_state["m"]["layers"][0]["A"].shape == \
        s.params["layers"][0]["A"].shape
    assert s.apply(FailureEvent(domain=1, stage=0)) == FailurePlan(4, (2, 3))
    assert s.health == ClusterHealth(4, (2, 1))
    s.step(pipe._batch_np(1))
    assert s.apply(RecoveryEvent(replica=0, n_gpus=9)) == FailurePlan(4, (3, 4))
    assert [type(e).__name__ for e in s.events] == \
        ["FailureEvent", "FailureEvent", "RecoveryEvent"]


def test_session_refuses_what_is_not_ported():
    """pp>1, microbatches and the global allocator (pp>1 only: at pp=1 it is
    refused as the reference refuses it) are ported, and so is the uniform
    arch backend: `from_arch` builds an ``"arch"`` session in
    `Mode.UNIFORM` (tests/test_torch_arch_session.py holds its steps)."""
    from repro_torch.cluster import GreedyAllocator

    cfg = nt.NTPModelConfig(n_layers=2, **KW)
    with pytest.raises(ValueError, match="pp>1 global repack planner"):
        NTPSession.create(cfg, (2, 4), device="cpu",
                          allocator=GreedyAllocator())
    s = NTPSession.create(cfg, (2, 4), device="cpu", pp=2, spares=1,
                          allocator=GreedyAllocator())
    assert s.plan.healthy and s.last_global_plan.predicted_bytes == 0
    for kw in (dict(pp=2), dict(microbatches=2)):
        assert NTPSession.create(cfg, (2, 4), device="cpu", **kw).pp == \
            kw.get("pp", 1)
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.shapes import ShapeSpec

    arch = NTPSession.from_arch(reduced(get_arch("qwen2-7b")),
                                ShapeSpec("t", 8, 2, "train"), device="cpu")
    assert (arch.backend, arch.mode, arch.plan) == ("arch", nt.Mode.UNIFORM,
                                                    None)
    assert NTPSession.create(cfg, (2, 4), device="cpu").backend == "ntp"
    with pytest.raises(TypeError, match="create"):
        NTPSession()
    with pytest.raises(ValueError, match="packed order"):
        NTPSession.create(cfg, (2, 4), plan=FailurePlan(4, (4, 3)),
                          device="cpu")
    with pytest.raises(ValueError, match="does not fit mesh"):
        NTPSession.create(cfg, (2, 8), plan=FailurePlan(4, (3, 4)),
                          device="cpu")
    s = NTPSession.create(cfg, (2, 4), device="cpu")
    with pytest.raises(RuntimeError, match="no restore point"):
        s.rollback()


# ----------------------------------------------- parity with the JAX session

_JAX_SIDE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import ntp_train as nt
from repro.core.nonuniform import FailurePlan
from repro.data.pipeline import DataConfig, SyntheticLMPipeline
from repro.optim import AdamWConfig, adamw, sgd
from repro.runtime import FailureEvent, NTPSession, RecoveryEvent

part, (KW, N_LAYERS, LB, SEQ, STEPS, EVENTS) = sys.argv[2], eval(sys.argv[3])
cfg = nt.NTPModelConfig(n_layers=N_LAYERS, **KW)
mesh = jax.make_mesh((2, 4), ("data", "model"))
canon = nt.init_canonical(cfg, jax.random.PRNGKey(0))
out = {"canonical/" + str(i): np.asarray(x)
       for i, x in enumerate(jax.tree.leaves(canon))}
pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))

if part == "session":
    s = NTPSession.create(cfg, mesh, local_batch=LB, params=canon,
                          overlap=True, optimizer=adamw(AdamWConfig(lr=1e-2)))
    losses, ledgers = [], []
    for i in range(STEPS):
        if i in EVENTS:
            kind, replica = EVENTS[i]
            cls = FailureEvent if kind == "fail" else RecoveryEvent
            s.apply(cls(step=i, replica=replica))
            ledgers.append(list(s.last_transition.as_dict().values()))
        losses.append(float(s.step(jnp.asarray(pipe._batch_np(i)))["loss"]))
    out["losses"] = np.array(losses)
    out["ledgers"] = np.array(ledgers)
    for r in range(2):
        for i, x in enumerate(jax.tree.leaves(s.canonical_params(r))):
            out[f"canon{r}/{i}"] = np.asarray(x)
else:
    plan = FailurePlan(4, (3, 4))
    for mode in ("uniform", "ntp", "dpdrop"):
        step = nt.make_ntp_train_step(cfg, plan, mesh, mode=mode,
                                      local_batch=LB, optimizer=sgd(0.05))
        p = nt.pack_params(cfg, canon, plan)
        o = sgd(0.05).init(p)
        ls = []
        for i in range(STEPS):
            p, o, m = step(p, o, jnp.asarray(pipe._batch_np(i)))
            ls.append(float(m["loss"]))
        out[f"{mode}/losses"] = np.array(ls)
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{mode}/packed/{i}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""


def _jax_side(tmp_path, part, n_layers, steps):
    """Run the JAX half on 8 fake CPU devices; returns its npz and the
    canonical params it started from, as the port's tree."""
    path = str(tmp_path / f"jax_{part}.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, path, part,
         repr((KW, n_layers, LB, SEQ, steps, EVENTS))],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = np.load(path)
    cfg = nt.NTPModelConfig(n_layers=n_layers, **KW)
    canon = _unflatten(_canonical(cfg), _leaves_of(res, "canonical"))
    return cfg, res, canon


def _leaves_of(res, prefix):
    keys = sorted((k for k in res.files if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [res[k] for k in keys]


def _unflatten(tree, flat):
    paths = [p for p, _ in tr.leaves_with_path(tree)]
    out = tr.tree_map(lambda x: None, tree)
    for p, v in zip(paths, flat):
        tr.set_path(out, p, torch.from_numpy(np.array(v)))
    return out


def test_session_matches_jax_session_on_fake_mesh(tmp_path):
    """Port vs the JAX package's NTPSession (2×4 fake CPU devices) through
    fail→repair with AdamW and the overlapped sync: per-step loss < 1e-4,
    identical transition ledgers, and canonical params within 5e-4 — the
    reference's own AdamW tolerance (tests/dist/ntp_adamw_equivalence.py):
    AdamW's first update g/(|g|+eps) turns the ~1e-8 f32 differences of a
    near-zero gradient element into ~1e-4 parameter differences (grads agree
    to ~4e-7; the SGD session agrees to 1e-4, see above)."""
    cfg, res, canon = _jax_side(tmp_path, "session", 4, STEPS)
    s = NTPSession.create(cfg, (2, 4), local_batch=LB, params=canon,
                          overlap=True, optimizer=adamw(AdamWConfig(lr=1e-2)),
                          device="cpu")
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
    losses, ledgers = [], []
    for i in range(STEPS):
        if i in EVENTS:
            s.apply(_event(i))
            ledgers.append(list(s.last_transition.as_dict().values()))
        losses.append(float(s.step(pipe._batch_np(i))["loss"]))
    np.testing.assert_allclose(losses, res["losses"], rtol=0, atol=1e-4)
    assert np.array_equal(np.array(ledgers), res["ledgers"])
    for rep in range(2):
        got = tr.leaves(s.canonical_params(rep))
        want = _leaves_of(res, f"canon{rep}")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.max(np.abs(a.numpy() - b)) < 5e-4


def test_step_modes_match_jax_step_on_fake_mesh(tmp_path):
    """The bare step in UNIFORM, NTP and DP_DROP at TP (3, 4) against the
    reference's shard_map step on 2×4 fake CPU devices: what the reference
    computes — including the buffers of replicas that do not follow the
    dense reference (UNIFORM's plain psum and DP_DROP's dropped replica add
    buffers of different layouts) — the port computes too: per-step loss
    and every packed buffer within 1e-4 after 4 SGD steps."""
    steps = 4
    cfg, res, canon = _jax_side(tmp_path, "modes", 2, steps)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
    plan = FailurePlan(4, (3, 4))
    for mode in ("uniform", "ntp", "dpdrop"):
        step = nt.make_ntp_train_step(cfg, plan, (2, 4), mode=mode,
                                      local_batch=LB, optimizer=sgd(0.05))
        p = nt.pack_params(cfg, canon, plan)
        o = sgd(0.05).init(p)
        ls = []
        for i in range(steps):
            p, o, m = step(p, o, pipe._batch_np(i))
            ls.append(float(m["loss"]))
        np.testing.assert_allclose(ls, res[f"{mode}/losses"], rtol=0,
                                   atol=1e-4)
        want = _leaves_of(res, f"{mode}/packed")
        assert len(want) == len(tr.leaves(p))
        for a, b in zip(tr.leaves(p), want):
            assert np.max(np.abs(a.numpy() - b)) < 1e-4, mode
