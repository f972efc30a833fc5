"""The layers of sharded execution of the uniform arch stack in the port,
on the CPU, on the reduced dense attention archs (qwen2-7b, gemma2-9b
with a sliding window of 8, granite-3-2b, minitron-4b, chameleon-34b):

* placement (`sharding.specs.local_shard` by `make_setup(..., RankMesh)`'s
  ``param_specs``, ``opt_specs`` and ``cache_specs``) equals, bit for bit,
  the reference's ``addressable_shards`` on device (replica, rank) of its
  trees placed by its `make_setup(cfg, shape, mesh)` shardings on a (2, 2)
  mesh of 4 fake CPU devices, run in a subprocess (``XLA_FLAGS`` must be
  set before JAX is imported; the mesh is built with automatic axes, as
  tests/test_torch_arch_ranks.py says why): seeded trees of the shapes of
  the params, of a first moment (ZeRO-1 over ``data``) and of a bf16
  cache (sequence over ``model``). One layout differs by construction: where a stacked leaf's
  only unsharded dim is its cycle axis (``bq``), the reference's ZeRO-1
  cuts the cycles over ``data``; the port's per-layer leaf has no such
  dim and keeps that moment whole over ``data``, equal to the reference's
  in every cycle the reference's device holds;
* on a 2 × 2 gloo mesh (`launch.spawn`): `gather` ∘ `place` is the
  identity; `vocab_parallel_cross_entropy` on a padded vocabulary (500 of
  512) equals `cross_entropy`, value and gradient, within 3e-5; every
  gradient of the sharded step (`Setup.grad_fn`, gathered) equals the
  one-device step's within 3e-5 — ``wk``/``wv``/``bk``/``bv`` (qwen2),
  the tied head (gemma2), ``q_norm``/``k_norm`` (chameleon) — and so do
  the loss, the clipped global norm and the updated first moment of one
  AdamW step; a microbatches=2 sharded step's first moment equals the
  one-device plain step's;
* each refusal with its message: MoE, an SSD or RG-LRU block, an
  encoder, a decode batch that takes the context-parallel K/V layout, a
  head split across ranks, something other than a `RankMesh`;
* ``launch.train --arch --nproc 4 --mesh 2x2 --backend gloo`` prints four
  losses within 3e-5 of the one-device launcher's, and the reference's
  spelling ``--devices 4`` needs ``--backend``.

The spawned ranks import this module, so JAX is imported inside the
subprocess only."""
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
from repro_torch.launch.mesh import RankMesh, make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.specs import gather, local_shard, place
from repro_torch.train import steps

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 3e-5
DEADLINE = 120
B, S = 4, 16
ARCHS = (("qwen2-7b", {}), ("gemma2-9b", {"window": 8}),
         ("granite-3-2b", {}), ("minitron-4b", {}), ("chameleon-34b", {}))

_JAX_SIDE = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_arch, reduced
from repro.configs.shapes import ShapeSpec
from repro.train.steps import make_setup

path, (archs, B, S) = sys.argv[1], eval(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
where = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
         for d in mesh.devices.flat}

def held(path, a, s):
    # a shard's data; a shard of a layer-stacked leaf cut along its cycle
    # axis comes back at full cycle length, NaN in the cycles not held
    data = np.asarray(s.data.astype(jnp.float32))
    stacked = any(getattr(k, "key", None) == "layers" for k in path)
    if stacked and data.shape[0] < a.shape[0]:
        full = np.full((a.shape[0],) + data.shape[1:], np.nan, np.float32)
        full[s.index[0]] = data
        return full
    return data

def placed(tree, shardings):
    arrays = jax.device_put(tree, shardings)
    flat, treedef = jax.tree_util.tree_flatten_with_path(arrays)
    full = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return full, {at: treedef.unflatten([
        next(held(path, a, s) for s in a.addressable_shards
             if where[s.device.id] == at)
        for path, a in flat]) for at in where.values()}

def noise(shapes, seed, dtype):
    # seeded values of the tree's shapes (numpy: nothing to compile)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape, np.float32).astype(dtype),
        shapes)

out = {}
for aid, kw in archs:
    cfg = dataclasses.replace(reduced(get_arch(aid)), **kw)
    su = make_setup(cfg, ShapeSpec("t", S, B, "train"), mesh,
                    param_dtype=jnp.float32)
    shapes = jax.eval_shape(su.model.init, jax.random.PRNGKey(0))
    dc = make_setup(cfg, ShapeSpec("d", S, B, "decode"), mesh,
                    param_dtype=jnp.float32)
    cache = jax.eval_shape(lambda: dc.model.init_cache(B, S, jnp.bfloat16))
    out[aid] = {"params": placed(noise(shapes, 0, np.float32), su.param_sharding),
                "m": placed(noise(shapes, 1, np.float32), su.opt_sharding["m"]),
                "cache": placed(noise(cache, 2, jnp.bfloat16), dc.cache_sharding)}
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(aid, kw):
    return dataclasses.replace(reduced(get_arch(aid)), **kw)


def _at(replica, rank):
    """Process (replica, rank)'s `RankMesh` on a 2 × 2 mesh, without
    process groups (specs and placement read only its coordinates)."""
    return RankMesh(2, 2, replica, rank, None, None, torch.device("cpu"),
                    "gloo")


def _has_data(spec):
    return any(e is not None and "data" in (e if isinstance(e, tuple) else
                                            (e,)) for e in tuple(spec))


def cache_to_port(jcache, cfg):
    from test_torch_arch_ranks import cache_to_port as convert

    return convert(jcache, cfg)


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("arch_mesh") / "jax.pkl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, HERE)),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, path,
                        repr((ARCHS, B, S))],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("aid", [a for a, _ in ARCHS])
def test_placement_equals_reference_shards(reference_shards, aid):
    cfg, ref = _cfg(aid, dict(ARCHS)[aid]), reference_shards[aid]
    for replica in range(2):
        for rank in range(2):
            at = _at(replica, rank)
            su = steps.make_setup(cfg, ShapeSpec("t", S, B, "train"), at,
                                  param_dtype=torch.float32, device="cpu")
            dc = steps.make_setup(cfg, ShapeSpec("d", S, B, "decode"), at,
                                  param_dtype=torch.float32, device="cpu")
            trees = (
                ("params", params_from_jax, su.param_specs),
                ("m", params_from_jax, su.opt_specs["m"]),
                ("cache", lambda t, device: {
                    k: torch.from_numpy(v)
                    for k, v in cache_to_port(t, cfg).items()},
                 dc.cache_specs))
            for name, convert, specs in trees:
                full, shards = ref[name]
                full = convert(full, device="cpu")
                want = convert(shards[(replica, rank)], device="cpu")
                for (path, f), s, w in zip(tr.leaves_with_path(full),
                                           tr.leaves(specs),
                                           tr.leaves(want)):
                    got = local_shard(f, s, at)
                    if bool(torch.isnan(w).all()):
                        # the reference's ZeRO-1 cut this leaf's stacked
                        # cycle axis over data (``bq``: its only unsharded
                        # dim); the port's per-layer leaf keeps its moment
                        # whole over data
                        assert name == "m" and not _has_data(s), path
                        continue
                    assert torch.equal(got, w), (name, replica, rank,
                                                 tr.path_key(path), s)


# ---------------------------------------------------------------------------
# on a 2 x 2 gloo mesh

def _cross_entropy_case(mesh):
    """(loss error, gradient error) of the vocab-parallel loss on a padded
    vocabulary against `cross_entropy` on the whole logits."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((2, 8, 512), generator=g) * 4
    targets = torch.randint(0, 500, (2, 8), generator=g)
    full = logits.clone().requires_grad_()
    want = steps.cross_entropy(full, targets, 500)
    want.backward()
    vl = 512 // mesh.n_model
    mine = logits[..., mesh.rank * vl:(mesh.rank + 1) * vl].clone() \
        .requires_grad_()
    got = steps.vocab_parallel_cross_entropy(mine, targets, 500, mesh)
    got.backward()
    return (abs(float(got) - float(want)),
            float((mine.grad - full.grad[..., mesh.rank * vl:(mesh.rank + 1)
                                         * vl]).abs().max()))


def _grads_case(mesh, aid, kw):
    """The sharded step's loss, gathered gradients, grad norm and first
    moment against the one-device step's, from the same seeded weights:
    the largest difference of each."""
    cfg = _cfg(aid, kw)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt = AdamWConfig(lr=1e-5)
    one = steps.make_setup(cfg, ShapeSpec("t", S, B, "train"),
                           param_dtype=torch.float32, opt_cfg=opt,
                           lr_schedule=lambda s: 1.0, device="cpu")
    su = steps.make_setup(cfg, ShapeSpec("t", S, B, "train"), mesh,
                          param_dtype=torch.float32, opt_cfg=opt,
                          lr_schedule=lambda s: 1.0, device="cpu")
    full = one.model.init(torch.Generator().manual_seed(0))
    for p in tr.leaves(full):          # norms and biases off their init
        if p.ndim == 1:
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    local = su.place(full)
    (_, ce1), g1 = one.grad_fn(full, batch)
    (_, ce2), g2 = su.grad_fn(local, batch)
    g2 = gather(g2, su.param_specs, mesh)
    errs = {tr.path_key(p): float((a - b).abs().max())
            for (p, a), b in zip(tr.leaves_with_path(g1), tr.leaves(g2))}
    p1, o1, m1 = one.step_fn(full, one.init_opt_state(full), batch)
    p2, o2, m2 = su.step_fn(local, su.init_opt_state(local), batch)
    mom = gather(o2["m"], su.opt_specs["m"], mesh)
    return {"loss": abs(float(ce1) - float(ce2)),
            "step_loss": abs(float(m1["loss"]) - float(m2["loss"])),
            "grad_norm": abs(float(m1["grad_norm"]) - float(m2["grad_norm"])),
            "m": max(float((a - b).abs().max())
                     for a, b in zip(tr.leaves(o1["m"]), tr.leaves(mom))),
            "grads": errs,
            "nonzero": all(bool((x != 0).any()) for x in tr.leaves(g2))}


def _microbatch_case(mesh):
    """The largest difference of a microbatches=2 sharded step's first
    moment (its clipped gradients) from the one-device plain step's."""
    cfg = _cfg("qwen2-7b", {})
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    setups = [steps.make_setup(cfg, ShapeSpec("t", S, B, "train"), where,
                               param_dtype=torch.float32, device="cpu",
                               microbatches=m)
              for where, m in ((None, 1), (mesh, 2))]
    full = setups[0].model.init(torch.Generator().manual_seed(0))
    moments = []
    for su in setups:
        p = su.place(full)
        _, o, _ = su.step_fn(p, su.init_opt_state(p), batch)
        moments.append(o["m"] if su.mesh is None
                       else gather(o["m"], su.opt_specs["m"], mesh))
    return max(float((a - b).abs().max())
               for a, b in zip(*map(tr.leaves, moments)))


def _round_trip_case(mesh):
    """`gather` of `place` of a seeded tree is the tree (params by their
    specs, a first moment by its ZeRO-1 specs)."""
    cfg = _cfg("qwen2-7b", {})
    su = steps.make_setup(cfg, ShapeSpec("t", S, B, "train"), mesh,
                          param_dtype=torch.float32, device="cpu")
    full = su.model.param_shapes()
    g = torch.Generator().manual_seed(9)
    full = tr.tree_map(lambda t: torch.randn(t.shape, generator=g), full)
    ok = []
    for specs in (su.param_specs, su.opt_specs["m"]):
        back = gather(place(full, specs, mesh), specs, mesh)
        ok.append(all(torch.equal(a, b)
                      for a, b in zip(tr.leaves(full), tr.leaves(back))))
    return ok


def _rank_checks():
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    return {"ce": _cross_entropy_case(mesh),
            "round_trip": _round_trip_case(mesh),
            "microbatches": _microbatch_case(mesh),
            "grads": {aid: _grads_case(mesh, aid, kw) for aid, kw in ARCHS}}


@pytest.fixture(scope="module")
def rank_checks():
    return spawn(_rank_checks, 4, backend="gloo", device="cpu",
                 deadline_s=DEADLINE)


def test_gather_inverts_place(rank_checks):
    assert all(r["round_trip"] == [True, True] for r in rank_checks)


def test_vocab_parallel_cross_entropy_on_a_padded_vocab(rank_checks):
    for r in rank_checks:
        loss_err, grad_err = r["ce"]
        assert loss_err <= TOL and grad_err <= TOL, r["ce"]


def test_sharded_microbatches_equal_the_plain_step(rank_checks):
    assert all(r["microbatches"] <= TOL for r in rank_checks), \
        [r["microbatches"] for r in rank_checks]


@pytest.mark.parametrize("aid", [a for a, _ in ARCHS])
def test_sharded_gradients_equal_one_device(rank_checks, aid):
    for r in rank_checks:
        got = r["grads"][aid]
        bad = {k: v for k, v in got["grads"].items() if v > TOL}
        assert not bad, bad
        assert got["nonzero"]
        for key in ("loss", "step_loss", "grad_norm", "m"):
            assert got[key] <= TOL, (key, got[key])


# ---------------------------------------------------------------------------
# refusals

@pytest.mark.parametrize("aid,kind,match", [
    ("arctic-480b", "train", "MoE on the mesh"),
    ("mamba2-780m", "train", "Mamba-2 and RG-LRU on the mesh"),
    ("recurrentgemma-9b", "prefill", "Mamba-2 and RG-LRU on the mesh"),
    ("whisper-small", "train", "whisper's encoder and cross bank"),
])
def test_families_outside_the_slice_are_refused(aid, kind, match):
    with pytest.raises(NotImplementedError, match=match):
        steps.make_setup(reduced(get_arch(aid)), ShapeSpec("t", S, B, kind),
                         _at(0, 0), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        steps.check_sharded_arch(reduced(get_arch(aid)))


def test_context_parallel_cache_and_split_heads_are_refused():
    cfg = _cfg("qwen2-7b", {})
    with pytest.raises(NotImplementedError,
                       match="the context-parallel K/V layout"):
        steps.make_setup(cfg, ShapeSpec("d", S, 3, "decode"), _at(0, 0),
                         device="cpu")
    with pytest.raises(ValueError, match="does not split over data=2"):
        steps.make_setup(cfg, ShapeSpec("t", S, 3, "train"), _at(0, 0),
                         device="cpu")
    # 6 heads of 64 over 4 ranks: 384 divides by 4, 6 does not
    odd = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2)
    at4 = RankMesh(1, 4, 0, 0, None, None, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match=r"384 divides by n_model = 4 but "
                                         r"n_heads = 6"):
        steps.make_setup(odd, ShapeSpec("t", S, B, "train"), at4,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="RankMesh"):
        steps.make_setup(cfg, ShapeSpec("t", S, B, "train"),
                         {"data": 2, "model": 2}, device="cpu")


# ---------------------------------------------------------------------------
# the launcher

def test_launcher_on_a_mesh_matches_one_device(capsys):
    base = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu", "--steps",
            "4", "--seq-len", "16", "--log-every", "1"]
    one = train_main(base)
    capsys.readouterr()
    sharded = train_main(base + ["--nproc", "4", "--mesh", "2x2",
                                 "--backend", "gloo"])
    np.testing.assert_allclose(sharded["losses"], one["losses"], atol=TOL,
                               rtol=0)
    assert len(sharded["losses"]) == 4


@pytest.mark.parametrize("argv,msg", [
    (["--devices", "4"], "needs --backend gloo or --backend nccl"),
    (["--nproc", "4", "--mesh", "2x2"], "--nproc needs --backend"),
    (["--nproc", "4", "--mesh", "2x2", "--backend", "gloo", "--arch",
      "mamba2-780m"], "Mamba-2 and RG-LRU on the mesh"),
    (["--dry-run", "--shape", "train_1k"], "invalid choice: 'train_1k'"),
])
def test_launcher_mesh_refusals(argv, msg, capsys):
    argv = (["--arch", "qwen2-7b"] if "--arch" not in argv else []) + argv
    with pytest.raises(SystemExit):
        train_main(argv + ["--reduced", "--device", "cpu"])
    assert msg in capsys.readouterr().err
