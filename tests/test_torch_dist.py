"""The port's process path (`repro_torch.launch.spawn`, `launch.mesh`,
`core.collectives` and the rank forms of the step, the sync, the
transitions and the session) on gloo with CPU tensors.

Fast tier: one 2×2 run of `NTPSession` on `make_test_mesh` through
fail→repair with SGD, held against the port's emulated session (every loss
within 1e-5, every ledger equal), the JAX package's dense reference
(`repro.core.ntp_train.make_reference_loss` plus SGD, as
`tests/dist/ntp_equivalence.py` trains it: losses and canonical params
within 1e-4) and `expected_transfer`; the Megatron pair against one-process
autograd; a failing rank and a hung run brought down by `spawn`, and
its ranks killed with a parent killed from outside; the
launcher, spawned and under torchrun. Slow tier: the 2×4 chain of `tests/dist/session_transition.py`
with AdamW and `ntp_adamw_equivalence.py`'s check.

The ranks run in spawned processes that import this module, so JAX is
imported inside the tests, never at the top: the ranks do not load it.
Every spawned run has its own deadline."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.core import collectives as C
from repro_torch.core import ntp_train as nt
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.launch.mesh import check_backend, make_test_mesh
from repro_torch.launch.spawn import RankError, spawn
from repro_torch.optim import AdamWConfig, adamw, sgd
from repro_torch.reshard.transition import expected_transfer
from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, n_layers=2, vocab=128)
LB, SEQ, LR = 4, 32, 0.05
CHAIN = {2: FailureEvent(step=2, replica=1), 4: RecoveryEvent(step=4, replica=0)}
STEPS = 6
DEADLINE = 120


def _cfg():
    return nt.NTPModelConfig(**KW)


def _jax_canonical(cfg):
    """The reference's canonical params (numpy) and the port's copy."""
    import jax

    from repro.core import ntp_train as jnt
    from repro_torch.convert import ntp_params_from_jax

    jcfg = jnt.NTPModelConfig(**KW)
    canon = jax.tree.map(np.asarray,
                         jnt.init_canonical(jcfg, jax.random.PRNGKey(0)))
    return canon, ntp_params_from_jax(canon, device="cpu")


def _numpy(tree):
    return None if tree is None else tr.tree_map(lambda t: t.numpy(), tree)


def _train(session, pipe, chain, steps, record):
    """Drive ``session`` through ``chain``; per step, the metrics and the
    collective counts; per event, the ledger and the apply's collectives."""
    out = {"loss": [], "grad_norm": [], "ledgers": [], "counts": [],
           "apply_counts": [], "local_batches": []}
    for i in range(steps):
        if i in chain:
            C.reset_counts()
            session.apply(chain[i])
            out["apply_counts"].append(C.counts())
            st = session.last_transition
            out["ledgers"].append((st.as_dict(), {
                tuple(int(x) for x in k): v for k, v in st.per_pair.items()}))
        C.reset_counts()
        record.clear()
        m = session.step(pipe._batch_np(i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["counts"].append((C.counts(), len(record),
                              session.step_fn.collectives,
                              getattr(session.step_fn.sync_fn,
                                      "replicated_collectives", 0)))
        out["local_batches"].append(list(session.local_batches))
    return out


def _counting_reshard_pack():
    """Count the per-rank route's calls of the `reshard_pack` wrapper (the
    CPU runs its plain version, which no launch counter sees)."""
    from repro_torch.core import reshard as rs

    calls = []
    inner = rs.reshard_pack

    def counted(src, send_idx):
        calls.append(tuple(src.shape))
        return inner(src, send_idx)

    rs.reshard_pack = counted
    return calls


def _rank_fast(canon_np, ckpt):
    """One 2×2 process: pack checks, a pp=2 session on the 2-D mesh, the
    SGD chain, canonical params of its replica, a checkpoint."""
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    cfg = _cfg()
    canon = ntp_params_from_jax(canon_np, device="cpu")
    packs = []
    for plan in (FailurePlan(2, (2, 2)), FailurePlan(2, (1, 2))):
        mine = nt.pack_rank_params(cfg, canon, plan, mesh.replica, mesh.rank)
        full = nt.pack_params(cfg, canon, plan)
        for (path, a), b in zip(tr.leaves_with_path(mine), tr.leaves(full)):
            if tr.leaf_key(path) in nt.UNIT_KEYS:
                b = b.reshape(2, 2, -1, *b.shape[2:])[mesh.replica, mesh.rank]
            packs.append(torch.equal(a, b))
    # pp=2 on this 2-D mesh is the stage-sequential route (every process
    # holds every layer, each under its stage's plan); its runs are
    # tests/test_torch_pp_ranks.py's
    staged = NTPSession.create(cfg, mesh, params=canon, pp=2)
    packs.append(staged.plan.pp == 2 and staged.plan.d == 2
                 and not getattr(staged.step_fn, "submesh", False)
                 and len(staged.params["layers"]) == cfg.n_layers)
    del staged
    s = NTPSession.create(cfg, mesh, local_batch=LB, optimizer=sgd(LR),
                          params=canon)
    record = _counting_reshard_pack()
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
    out = _train(s, pipe, CHAIN, STEPS, record)
    out["packs"] = packs
    out["canonical"] = _numpy(s.canonical_params(mesh.replica))
    s.save(ckpt)
    return out


def test_rank_session_matches_emulated_and_dense_reference(tmp_path):
    """2×2 processes on gloo through fail (TP (1, 2)) → repair with SGD:
    every loss and grad norm within 1e-5 of the emulated session; losses
    and both replicas' canonical params within 1e-4 of the JAX package's
    dense reference; every ledger equal to the emulated one and to
    `expected_transfer`; the transitions one all-to-all each; the sync's
    collectives as `sync_collectives(bucketed=False)` counts them, through
    the `reshard_pack` wrapper on degraded steps only; `pack_rank_params`
    equal to slices of `pack_params`; a checkpoint `repro.checkpoint`
    loads."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import load_checkpoint
    from repro.core import ntp_train as jnt

    cfg = _cfg()
    canon_np, canon = _jax_canonical(cfg)
    ckpt = str(tmp_path / "ck.npz")
    t0 = time.perf_counter()
    ranks = spawn(_rank_fast, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np, ckpt))
    assert time.perf_counter() - t0 < DEADLINE

    emu = NTPSession.create(cfg, (2, 2), local_batch=LB, optimizer=sgd(LR),
                            params=canon, device="cpu")
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
    want = _train(emu, pipe, CHAIN, STEPS, [])

    # the JAX package's dense reference, SGD under the same sample masks
    ref_grad = jax.jit(jax.value_and_grad(jnt.make_reference_loss(
        jnt.NTPModelConfig(**KW))))
    ref = jax.tree.map(jnp.asarray, canon_np)
    ref_losses = []
    for i in range(STEPS):
        mask = jnp.asarray(np.concatenate([
            np.arange(LB) < b for b in want["local_batches"][i]]),
            dtype=jnp.float32)
        rl, g = ref_grad(ref, jnp.asarray(pipe._batch_np(i)), mask)
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        ref_losses.append(float(rl))

    plans = [FailurePlan(2, (2, 2)), FailurePlan(2, (1, 2)),
             FailurePlan(2, (2, 2))]
    for got in ranks:
        assert all(got["packs"])
        assert len(got["packs"]) == 2 * len(tr.leaves(canon)) + 1
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["loss"], ref_losses, rtol=0, atol=1e-4)
        assert got["ledgers"] == want["ledgers"]
        for (stats, _), old, new in zip(got["ledgers"], plans, plans[1:]):
            moved = {f: int(m.sum() - np.trace(m))
                     for f, m in expected_transfer(cfg, old, new).items()}
            assert stats["moved_units"] == sum(moved.values()) * cfg.n_layers
            assert stats["bytes_moved"] == sum(
                n * canon["layers"][0][f][0].numel() * 4 * cfg.n_layers
                for f, n in moved.items())
        # one message route per transition: a single all-to-all (model)
        assert all(c == {("all_to_all", "model"): c[("all_to_all", "model")]}
                   and c[("all_to_all", "model")][0] == 1
                   for c in got["apply_counts"])
        for i, (counts, packs, collectives, rep) in enumerate(got["counts"]):
            degraded = 2 <= i < 4
            a2a = counts.get(("all_to_all", "model"), (0, 0))[0]
            data = counts[("all_reduce", "data")][0]
            # unit sync + replicated leaves + the loss's totals and counts
            assert a2a + data == collectives + rep + 1
            assert collectives == (36 if degraded else 12)
            assert a2a == (24 if degraded else 0)
            # Megatron pair: 2 all-reduces a layer forward, 2 backward; the
            # grad norm's sum over the model group
            assert counts[("all_reduce", "model")][0] == 4 * cfg.n_layers + 1
            assert packs == a2a       # one send-bucket gather a message
    for r in (0, 2):          # rank 0 of each replica
        got = ranks[r]["canonical"]
        for a, b, c in zip(tr.leaves(got), jax.tree.leaves(ref),
                           tr.leaves(emu.canonical_params(r // 2))):
            assert np.max(np.abs(a - np.asarray(b))) < 1e-4
            assert np.max(np.abs(a - c.numpy())) < 1e-5
    assert ranks[1]["canonical"] is not None and ranks[3]["canonical"] is not None
    flat, step = load_checkpoint(ckpt)
    assert step == STEPS
    for path, a in tr.leaves_with_path(ranks[0]["canonical"]):
        assert np.array_equal(np.asarray(flat["params/" + tr.path_key(path)]), a)


def _rank_pair(x_np, a_np, b_np):
    """One of 2 ranks: a two-matrix MLP block with A split by columns and B
    by rows, between the Megatron pair, then with a naive all-reduce whose
    backward all-reduces too. Returns both runs' gradients."""
    import torch.distributed.nn.functional as dfn

    r, group = dist.get_rank(), dist.group.WORLD
    cols = a_np.shape[1] // 2
    out = []
    for naive in (False, True):
        x = torch.tensor(x_np, requires_grad=True)
        a = torch.tensor(a_np[:, r * cols:(r + 1) * cols], requires_grad=True)
        b = torch.tensor(b_np[r * cols:(r + 1) * cols], requires_grad=True)
        if naive:
            z = dfn.all_reduce(torch.tanh(x @ a) @ b, group=group)
        else:
            h = C.copy_to_model(x, group)
            z = C.reduce_from_model(torch.tanh(h @ a) @ b, group)
        out.append([g.numpy() for g in torch.autograd.grad(
            (z ** 2).sum(), (x, a, b))])
    return out


def test_megatron_pair_matches_one_process_autograd():
    """The pair's gradients equal one-process autograd of the whole block;
    an all-reduce whose backward also all-reduces counts the weights'
    gradients n1 = 2 times."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    a = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)
    tx, ta, tb = (torch.tensor(v, requires_grad=True) for v in (x, a, b))
    gx, ga, gb = torch.autograd.grad(
        ((torch.tanh(tx @ ta) @ tb) ** 2).sum(), (tx, ta, tb))
    ranks = spawn(_rank_pair, 2, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(x, a, b))
    for r, (pair, naive) in enumerate(ranks):
        cols = slice(3 * r, 3 * r + 3)
        np.testing.assert_allclose(pair[0], gx.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pair[1], ga.numpy()[:, cols], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pair[2], gb.numpy()[cols], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(naive[1], 2 * ga.numpy()[:, cols],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(naive[2], 2 * gb.numpy()[cols],
                                   rtol=1e-5, atol=1e-5)


def _rank_raises_or_waits(hang: bool):
    if dist.get_rank() == 1 and not hang:
        raise ValueError("rank 1 gives up")
    dist.barrier()         # rank 0 waits here for a rank that never comes
    time.sleep(3600)


@pytest.mark.parametrize("hang", [False, True])
def test_spawn_brings_the_run_down(hang):
    """A rank that raises brings the parent down with its traceback and
    exit code, long before the others' collective would time out; a run
    that hangs is killed at its deadline."""
    t0 = time.perf_counter()
    if hang:
        with pytest.raises(TimeoutError, match="deadline of 4"):
            spawn(_rank_raises_or_waits, 2, backend="gloo", device="cpu",
                  deadline_s=4, args=(True,))
    else:
        with pytest.raises(RankError, match="rank 1 gives up") as e:
            spawn(_rank_raises_or_waits, 2, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(False,))
        assert e.value.rank == 1 and e.value.exitcode == 1
        assert "Traceback" in e.value.detail
    assert time.perf_counter() - t0 < 30


def _rank_marks_and_sleeps(directory: str):
    with open(os.path.join(directory, f"rank{dist.get_rank()}"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(3600)


def test_spawn_ranks_die_with_a_killed_parent(tmp_path):
    """A parent killed by SIGKILL in the middle of a run (as a time limit
    stops it) leaves none of its ranks running."""
    parent = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path[:0] = sys.argv[1:3]; "
         "from repro_torch.launch.spawn import spawn; "
         "from test_torch_dist import _rank_marks_and_sleeps as f; "
         "spawn(f, 2, backend='gloo', device='cpu', deadline_s=120, "
         "args=(sys.argv[3],))",
         os.path.dirname(os.path.abspath(__file__)),
         os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"),
         str(tmp_path)])
    try:
        marks = [tmp_path / f"rank{r}" for r in range(2)]
        t0 = time.monotonic()
        while not all(m.exists() and m.read_text() for m in marks):
            assert parent.poll() is None, "the parent ended on its own"
            assert time.monotonic() - t0 < DEADLINE, "the ranks never ran"
            time.sleep(0.1)
        pids = [int(m.read_text()) for m in marks]
    finally:
        parent.kill()
        parent.wait()
    t0 = time.monotonic()
    while live := [p for p in pids if _state(p) != "Z"]:
        if time.monotonic() - t0 > 10:
            for p in live:
                os.kill(p, signal.SIGKILL)
            pytest.fail(f"ranks {live} outlived the parent")
        time.sleep(0.1)


def _state(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return "Z"


def test_backend_is_explicit():
    with pytest.raises(ValueError, match="use one of"):
        check_backend("mpi", 4, "cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        check_backend("nccl", 4, "cpu")
    assert check_backend("gloo", 4, "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no default process group"):
        make_test_mesh(2, 2, backend="gloo", device="cpu")


def test_launcher_nproc_cpu_smoke(capfd):
    """`launch.train --nproc 4 --mesh 2x2 --backend gloo`: finite losses
    through the failure, the plan printed, rank 0's result returned."""
    from repro_torch.launch.train import main

    out = main(["--ntp", "--device", "cpu", "--nproc", "4", "--mesh", "2x2",
                "--backend", "gloo", "--steps", "4", "--fail-at", "2",
                "--seq-len", "16", "--batch", "2", "--log-every", "1"])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["plan"] == FailurePlan(2, (1, 2))
    text = capfd.readouterr().out         # the ranks print: a child's fd
    assert "-> plan FailurePlan(n1=2, replica_tp=(1, 2)) mode ntp" in text
    assert "processes 4 (mesh data=2 model=2, gloo)" in text


def test_launcher_joins_under_torchrun():
    """Under torchrun (``RANK``/``WORLD_SIZE`` set) the same entry joins the
    job instead of spawning: a (1, 2) mesh, rendezvous on a free port."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--ntp",
         "--device", "cpu", "--nproc", "2", "--mesh", "1x2", "--backend",
         "gloo", "--steps", "2", "--seq-len", "16", "--batch", "2",
         "--log-every", "1"],
        capture_output=True, text=True, timeout=DEADLINE,
        env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "processes 2 (mesh data=1 model=2, gloo)" in r.stdout
    assert r.stdout.count("loss ") == 2


# ---------------------------------------------------------------- slow tier

def _rank_adamw(canon_np, part):
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_test_mesh(2, 4, backend="gloo", device="cpu")
    cfg = _cfg()
    canon = ntp_params_from_jax(canon_np, device="cpu")
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
    if part == "transition":
        s = NTPSession.create(cfg, mesh, local_batch=LB, params=canon,
                              optimizer=adamw(AdamWConfig(lr=1e-2)))
        out = _train(s, pipe, {4: FailureEvent(step=4, replica=1)}, 10, [])
    else:
        s = NTPSession.create(cfg, mesh, plan=FailurePlan(4, (3, 4)),
                              local_batch=LB, params=canon, optimizer=adamw(
                                  AdamWConfig(lr=1e-2, grad_clip=0.5)))
        out = _train(s, pipe, {}, 4, [])
    out["canonical"] = _numpy(s.canonical_params(mesh.replica))
    return out


@pytest.mark.slow
def test_rank_session_adamw_2x4():
    """2×4 processes with AdamW: the chain of
    `tests/dist/session_transition.py` (4 healthy steps, replica 1 fails,
    6 more) against the emulated session (losses 1e-5, ledgers equal,
    canonical params 5e-4), and `ntp_adamw_equivalence.py`'s check at TP
    (3, 4) with a tight clip against canonical AdamW in the JAX package
    (grad norms 1e-5, losses 1e-4, params 5e-4)."""
    import jax
    import jax.numpy as jnp

    from repro.core import ntp_train as jnt
    from repro.optim import AdamWConfig as JCfg, adamw_init, adamw_update

    cfg = _cfg()
    canon_np, canon = _jax_canonical(cfg)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))

    ranks = spawn(_rank_adamw, 8, backend="gloo", device="cpu",
                  deadline_s=600, args=(canon_np, "transition"))
    emu = NTPSession.create(cfg, (2, 4), local_batch=LB, params=canon,
                            optimizer=adamw(AdamWConfig(lr=1e-2)),
                            device="cpu")
    want = _train(emu, pipe, {4: FailureEvent(step=4, replica=1)}, 10, [])
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
        assert got["ledgers"] == want["ledgers"]
    assert np.mean(want["loss"][4:]) < np.mean(want["loss"][:2])
    for a, b in zip(tr.leaves(ranks[0]["canonical"]),
                    tr.leaves(emu.canonical_params(0))):
        assert np.max(np.abs(a - b.numpy())) < 5e-4

    ranks = spawn(_rank_adamw, 8, backend="gloo", device="cpu",
                  deadline_s=600, args=(canon_np, "adamw"))
    ocfg = JCfg(lr=1e-2, grad_clip=0.5)
    ref_grad = jax.jit(jax.value_and_grad(jnt.make_reference_loss(
        jnt.NTPModelConfig(**KW))))
    ref = jax.tree.map(jnp.asarray, canon_np)
    ref_opt = adamw_init(ref, ocfg)
    lb = FailurePlan(4, (3, 4)).local_batch_fraction(LB)
    mask = jnp.asarray(np.concatenate([np.arange(LB) < b for b in lb]),
                       dtype=jnp.float32)
    for i in range(4):
        rl, g = ref_grad(ref, jnp.asarray(pipe._batch_np(i)), mask)
        ref, ref_opt, rm = adamw_update(g, ref_opt, ref, ocfg)
        for got in ranks:
            assert abs(got["loss"][i] - float(rl)) < 1e-4
            assert abs(got["grad_norm"][i] - float(rm["grad_norm"])) < 1e-5
    for r in (0, 4):
        for a, b in zip(tr.leaves(ranks[r]["canonical"]), jax.tree.leaves(ref)):
            assert np.max(np.abs(a - np.asarray(b))) < 5e-4
