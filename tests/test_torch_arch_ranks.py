"""Sharded execution of the uniform arch stack in the port, as a whole, on
the CPU: reduced qwen2-7b and gemma2-9b (post-norms, the tied head,
softcaps, a sliding window of 8 so that its ring cache wraps) on a 2 × 2
mesh of gloo processes (`launch.spawn`, `make_setup(cfg, shape,
RankMesh)` through `NTPSession.from_arch`), against the reference's
`make_setup(cfg, shape, mesh)` on a (2, 2) mesh of 4 fake CPU devices in
a subprocess (``XLA_FLAGS`` must be set before JAX is imported), from the
same `convert.params_from_jax` params (tests/test_torch_arch_train.py's
nudged `reference_state`):

* two AdamW steps at lr 1e-5 (constant): every process's loss and
  grad_norm, its param shards and its ZeRO-1 first-moment shards within
  3e-5 of the reference's;
* a prefill of 14 tokens into a cache of 16 rows: its last logits within
  3e-5, and every process's cache shard equal to the reference's
  addressable shard on device (replica, rank) up to one bf16 rounding
  (both packages compute the K/V in f32 and round them to the bf16
  cache: a value within an f32 rounding of a bf16 midpoint rounds either
  way);
* two greedy decode steps from the reference's cache of each step placed
  on the processes (`sharding.place`): their logits within 3e-5; and the
  same two steps chained on the port's own cache: logits within the bf16
  tolerance 2e-2 and the greedy tokens equal (its cache differs from the
  reference's by those single roundings, which move a logit by up to
  ~5e-5).

The reference's `launch.mesh.make_test_mesh` is ``jax.make_mesh``, whose
axes this JAX makes explicit by default, and the reference's embedding
gather refuses explicit axes; the subprocess builds the same (2, 2)
``("data", "model")`` mesh with automatic axes, as the reference's JAX
made it. The spawned ranks import this module, so JAX is imported inside
the subprocess and the test only."""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import NTPSession
from repro_torch.sharding.specs import local_shard, place
from repro_torch.train import steps

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 3e-5
# a decode chained on each package's own bf16 cache: the caches differ by
# single roundings (see the module docstring), so its logits are held at
# the bf16 tolerance of tests/test_torch_arch_train.py's TOL
BF16_CACHE_TOL = 2e-2
DEADLINE = 120
B, S, T, LR, STEPS = 4, 16, 16, 1e-5, 2
CASES = (("qwen2-7b", {}), ("gemma2-9b", {"window": 8}))

_JAX_SIDE = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_arch, reduced
from repro.configs.shapes import ShapeSpec
from repro.optim import AdamWConfig
from repro.train.steps import make_setup
from test_torch_arch_train import batch_np, const_schedule, reference_state, to_numpy

path, (cases, B, S, T, LR, STEPS) = sys.argv[1], eval(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
where = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
         for d in mesh.devices.flat}

def shards(tree):
    flat, treedef = jax.tree.flatten(tree)
    return {at: to_numpy(treedef.unflatten([
        next(s.data for s in a.addressable_shards if where[s.device.id] == at)
        for a in flat])) for at in where.values()}

out = {}
for aid, kw in cases:
    cfg = dataclasses.replace(reduced(get_arch(aid)), **kw)
    su = make_setup(cfg, ShapeSpec("t", S, B, "train"), mesh,
                    param_dtype=jnp.float32, opt_cfg=AdamWConfig(lr=LR),
                    lr_schedule=const_schedule)
    p, o = reference_state(su)
    r = {"params0": to_numpy(p), "loss": [], "grad_norm": []}
    p, o = jax.device_put(p, su.param_sharding), jax.device_put(o, su.opt_sharding)
    step = su.jit_step()
    for i in range(STEPS):
        data = {k: jnp.asarray(v) for k, v in batch_np(cfg, B, S, seed=i).items()}
        p, o, m = step(p, o, data)
        r["loss"].append(float(m["loss"]))
        r["grad_norm"].append(float(m["grad_norm"]))
    r["params"], r["m"] = to_numpy(p), to_numpy(o["m"])
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, T - STEPS)).astype(np.int32)
    pf = make_setup(cfg, ShapeSpec("p", T, B, "prefill"), mesh,
                    param_dtype=jnp.float32)
    logits, cache = pf.jit_step()(p, {"tokens": jnp.asarray(toks)})
    r.update(tokens=toks, prefill=np.asarray(logits), cache=[to_numpy(cache)],
             cache_shards=shards(cache), decode=[], decode_tokens=[])
    dstep = make_setup(cfg, ShapeSpec("d", T, B, "decode"), mesh,
                       param_dtype=jnp.float32).jit_step()
    for i in range(STEPS):
        tok = np.argmax(np.asarray(logits), -1)[:, None].astype(np.int32)
        logits, cache = dstep(p, cache, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(T - STEPS + i, jnp.int32)})
        r["decode_tokens"].append(tok)
        r["decode"].append(np.asarray(logits))
        r["cache"].append(to_numpy(cache))
    out[aid] = r
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def cache_to_port(jcache, cfg):
    """The reference's cache tree (numpy) as the port's flat dict: one
    leaf per pattern entry (its cycles stacked), ``.t<j>`` for a tail
    layer (given the port's leading layer axis)."""
    one = len(cfg.layer_pattern) == 1
    out = {}
    for g, entry in enumerate(jcache.get("layers", ())):
        for name, leaf in entry.items():
            out[name + ("" if one else f".{g}")] = leaf
    for j, entry in enumerate(jcache.get("tail", ())):
        for name, leaf in entry.items():
            out[f"{name}.t{j}"] = leaf[None]
    return out


def _cfg(aid, kw):
    return dataclasses.replace(reduced(get_arch(aid)), **kw)


def _numpy(tree):
    return tr.tree_map(lambda t: t.detach().float().numpy(), tree)


def _batch(cfg, seed):
    from test_torch_arch_train import batch_np

    return {k: torch.from_numpy(v)
            for k, v in batch_np(cfg, B, S, seed=seed).items()}


def _rank_run(ref):
    """One process of the 2 × 2 mesh through both cases: train, prefill,
    decode (its own cache, then the reference's placed)."""
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    out = {}
    for aid, kw in CASES:
        cfg, r = _cfg(aid, kw), ref[aid]
        s = NTPSession.from_arch(
            cfg, ShapeSpec("t", S, B, "train"), mesh,
            opt_cfg=AdamWConfig(lr=LR), lr_schedule=lambda step: 1.0,
            params=params_from_jax(r["params0"], device="cpu"),
            device="cpu")
        got = {"loss": [], "grad_norm": []}
        for i in range(STEPS):
            m = s.step(_batch(cfg, i))
            got["loss"].append(float(m["loss"]))
            got["grad_norm"].append(float(m["grad_norm"]))
        got["params"], got["m"] = _numpy(s.params), _numpy(s.opt_state["m"])
        pf = steps.make_setup(cfg, ShapeSpec("p", T, B, "prefill"), mesh,
                              param_dtype=torch.float32, device="cpu")
        last, cache = pf.step_fn(s.params,
                                 {"tokens": torch.from_numpy(r["tokens"])})
        got["prefill"], got["cache"] = last.numpy(), _numpy(cache)
        dc = steps.make_setup(cfg, ShapeSpec("d", T, B, "decode"), mesh,
                              param_dtype=torch.float32, device="cpu")
        got["decode"], got["decode_from_ref"] = [], []
        for i in range(STEPS):
            batch = {"tokens": torch.from_numpy(r["decode_tokens"][i]),
                     "pos": torch.tensor(T - STEPS + i)}
            logits, cache = dc.step_fn(s.params, cache, batch)
            got["decode"].append(logits.numpy())
            placed = place({k: torch.from_numpy(v).to(torch.bfloat16)
                            for k, v in cache_to_port(r["cache"][i],
                                                      cfg).items()},
                           dc.cache_specs, mesh)
            got["decode_from_ref"].append(dc.step_fn(s.params, placed,
                                                     batch)[0].numpy())
        got["specs"] = (s.setup.param_specs, s.setup.opt_specs["m"],
                        dc.cache_specs)
        out[aid] = got
    return mesh.replica, mesh.rank, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run (subprocess, 4 fake devices) and the port's
    (4 spawned processes), each process's results by (replica, rank)."""
    path = str(tmp_path_factory.mktemp("arch_ranks") / "jax.pkl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, HERE)),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, path,
         repr((CASES, B, S, T, LR, STEPS))],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ranks = spawn(_rank_run, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(ref,))
    return ref, {(d, k): out for d, k, out in ranks}


def _mesh_at(replica, rank):
    """What `local_shard` reads of process (replica, rank)'s mesh."""
    return type("At", (), dict(n_data=2, n_model=2, replica=replica,
                               rank=rank))()


def _assert_shards(got, full, specs, at, what, tol):
    for (path, g), f, s in zip(tr.leaves_with_path(got), tr.leaves(full),
                               tr.leaves(specs)):
        want = local_shard(torch.as_tensor(f).float(), s, _mesh_at(*at))
        assert tuple(g.shape) == tuple(want.shape), (what, path)
        np.testing.assert_allclose(g, want.numpy(), atol=tol, rtol=0,
                                   err_msg=f"{what} {at} {tr.path_key(path)}")


@pytest.mark.parametrize("aid", [a for a, _ in CASES])
def test_train_steps_match_reference(runs, aid):
    ref, ranks = runs
    r = ref[aid]
    for at, got in ranks.items():
        got = got[aid]
        np.testing.assert_allclose(got["loss"], r["loss"], atol=TOL, rtol=0)
        np.testing.assert_allclose(got["grad_norm"], r["grad_norm"],
                                   atol=TOL, rtol=0)
        pspecs, mspecs, _ = got["specs"]
        _assert_shards(got["params"], params_from_jax(r["params"],
                                                      device="cpu"),
                       pspecs, at, "params", TOL)
        _assert_shards(got["m"], params_from_jax(r["m"], device="cpu"),
                       mspecs, at, "m", TOL)


@pytest.mark.parametrize("aid", [a for a, _ in CASES])
def test_prefill_and_cache_match_reference(runs, aid):
    ref, ranks = runs
    r, cfg = ref[aid], _cfg(aid, dict(CASES)[aid])
    bl = B // 2
    for (d, k), got in ranks.items():
        got = got[aid]
        np.testing.assert_allclose(got["prefill"],
                                   r["prefill"][d * bl:(d + 1) * bl],
                                   atol=TOL, rtol=0)
        want = cache_to_port(r["cache_shards"][(d, k)], cfg)
        assert set(want) == set(got["cache"])
        for name, leaf in got["cache"].items():
            assert leaf.shape == want[name].shape, name
            # one bf16 rounding: at most one unit in the last place
            diff = np.abs(leaf - want[name])
            bad = diff > np.abs(want[name]) * 2.0 ** -7
            assert not bad.any(), (name, leaf[bad], want[name][bad])


@pytest.mark.parametrize("aid", [a for a, _ in CASES])
def test_decode_matches_reference(runs, aid):
    ref, ranks = runs
    r = ref[aid]
    bl = B // 2
    for (d, _), got in ranks.items():
        got = got[aid]
        for i in range(STEPS):
            want = r["decode"][i][d * bl:(d + 1) * bl]
            np.testing.assert_allclose(got["decode_from_ref"][i], want,
                                       atol=TOL, rtol=0, err_msg=f"step {i}")
            np.testing.assert_allclose(got["decode"][i], want,
                                       atol=BF16_CACHE_TOL, rtol=0,
                                       err_msg=f"own cache, step {i}")
            np.testing.assert_array_equal(
                got["decode"][i].argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# a (1, 3) mesh: replicated attention over a sequence-split cache

ODD_T, ODD_S = 12, 10
ODD_CASES = (("qwen2-7b", {}), ("gemma2-9b", {"window": 6}))


def _odd_run(aid, kw, mesh):
    """One device's (``mesh`` None) or one process's train step, prefill
    and two greedy decode steps of the reduced ``aid`` from seed 0."""
    cfg = _cfg(aid, kw)
    s = NTPSession.from_arch(cfg, ShapeSpec("t", S, 2, "train"), mesh,
                             opt_cfg=AdamWConfig(lr=LR),
                             lr_schedule=lambda step: 1.0, device="cpu")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=g,
                         dtype=torch.int32)
    m = s.step({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "logits": []}
    pf = steps.make_setup(cfg, ShapeSpec("p", ODD_T, 2, "prefill"), mesh,
                          param_dtype=torch.float32, device="cpu")
    logits, cache = pf.step_fn(s.params, {"tokens": toks[:, :ODD_S]})
    dc = steps.make_setup(cfg, ShapeSpec("d", ODD_T, 2, "decode"), mesh,
                          param_dtype=torch.float32, device="cpu")
    out["logits"].append(logits.numpy())
    for i in range(STEPS):
        tok = logits.argmax(-1)[:, None].int()
        logits, cache = dc.step_fn(s.params, cache,
                                   {"tokens": tok,
                                    "pos": torch.tensor(ODD_S + i)})
        out["logits"].append(logits.numpy())
    out["seq_split"] = (None if mesh is None else
                        sorted(n for n, sp in dc.cache_specs.items()
                               if tuple(sp)[2] is not None))
    return out


def _odd_rank_run():
    mesh = make_test_mesh(1, 3, backend="gloo", device="cpu")
    return {aid: _odd_run(aid, kw, mesh) for aid, kw in ODD_CASES}


@pytest.fixture(scope="module")
def odd_runs():
    return ({aid: _odd_run(aid, kw, None) for aid, kw in ODD_CASES},
            spawn(_odd_rank_run, 3, backend="gloo", device="cpu",
                  deadline_s=DEADLINE))


@pytest.mark.parametrize("aid", [a for a, _ in ODD_CASES])
def test_replicated_heads_over_a_sequence_split_cache(odd_runs, aid):
    """On a (1, 3) mesh 3 does not divide n_heads·head_dim (256), d_ff or
    the vocabulary, so every weight is replicated, while the cache's 12
    rows (6 in gemma2's ring) split over ``model``: the decode attends
    all heads over each rank's rows and combines the partials. Each
    process's train step, prefill and decode logits equal one device's
    within 3e-5."""
    one, ranks = odd_runs
    want = one[aid]
    for got in (r[aid] for r in ranks):
        assert got["seq_split"], "the cache's rows should split over model"
        assert abs(got["loss"] - want["loss"]) <= TOL
        assert abs(got["grad_norm"] - want["grad_norm"]) <= TOL
        for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0,
                                       err_msg=f"step {i}")
