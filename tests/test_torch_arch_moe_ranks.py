"""MoE on the mesh and split heads in the port, as a whole, on the CPU:
`make_setup(cfg, shape, RankMesh)` of

* reduced llama4-scout (4 experts top-1, the shared expert; cut to one
  chunked layer and one global one, chunks of 8 so that the chunked ring
  cache wraps) and reduced arctic-480b (4 experts top-2, the dense
  residual FFN) on a 2 × 2 mesh of gloo processes, each process holding
  2 experts (`models.mlp.moe_apply_expert_parallel`), at the configs'
  capacity factor 1.25, where slots drop;
* reduced qwen2-7b with 6 heads of 64 over 2 KV heads on a (1, 4) mesh:
  384 columns split 96 a rank, so every rank's columns cut a head
  (`models.attention.local_heads`), ``bq`` included;

against the reference's `make_setup(cfg, shape, mesh)` on (2, 2) and (1,
4) meshes of 4 fake CPU devices in a subprocess a case (``XLA_FLAGS``
must be set before JAX is imported; the meshes built with automatic
axes, as tests/test_torch_arch_ranks.py says why), from the same
`convert.params_from_jax` params (tests/test_torch_arch_train.py's nudged
`reference_state`):

* the router's (clipped) gradient of the first step, read off each
  process's ZeRO-1 slice of the first moment (the MoE aux loss's
  statistics are averaged over the mesh: at ``n_data = 2`` a wrong adjoint
  is off by 2×; top-1 llama4's router gradient is the aux loss's alone),
  within 3e-5;
* two AdamW steps at lr 1e-5 (constant): loss, grad_norm, param shards,
  and the ZeRO-1 first-moment shards, each equal to the reference's
  addressable shard on device (replica, rank), within 3e-5;
* a prefill of 14 tokens into a cache of 16 rows (split over ``model``):
  its last logits within 3e-5 and every cache shard equal to the
  reference's up to one bf16 rounding; two greedy decode steps from the
  reference's cache of each step within 3e-5, and chained on the port's
  own cache within 2e-2 with the greedy tokens equal;
* slots dropped in the MoE train steps (counted by `mlp.record_drops`);
* the dry-run (`launch.dryrun.count_step` on a fake mesh, meta tensors)
  predicts every (op, group)'s calls and bytes each process executed in
  the train steps, the prefill and the first decode step, the all-to-alls
  and the split heads' reduce-scatter included.

And each autograd collective of `core.collectives` that the two routes
add, its backward against the gradient of the same function on one
process, and the sharded draw of the weights (`Setup.init_params`)
against the whole draw placed, on a 2 × 2 gloo mesh; and AdamW's update
in blocks of a leaf against the whole-leaf update.

The spawned processes import this module, so JAX is imported inside the
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
from repro_torch.core import collectives as C
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (close_fake_mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.spawn import spawn
from repro_torch.models.mlp import record_drops
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.specs import local_shard, place
from repro_torch.train import steps

from test_torch_arch_ranks import BF16_CACHE_TOL, cache_to_port

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 3e-5
DEADLINE = 120
B, S, T, LR, STEPS = 4, 16, 16, 1e-5, 2
# name: (arch, mesh (data, model), config overrides)
CASES = {
    "llama4": ("llama4-scout-17b-a16e", (2, 2),
               {"n_layers": 2, "layer_pattern": ("attn_chunked", "attn"),
                "chunk_size": 8}),
    "arctic": ("arctic-480b", (2, 2), {}),
    "split_heads": ("qwen2-7b", (1, 4), {"n_heads": 6, "n_kv_heads": 2}),
}
MOE = ("llama4", "arctic")
KINDS = {"train": f"train:{B}x{S}",
         "prefill": f"prefill:{B}x{T - STEPS}+{STEPS}",
         "decode": f"decode:{B}x{T - STEPS}+{STEPS}"}

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
out = {}
for name, (aid, shape, kw) in cases.items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    where = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}

    def shards(tree):
        flat, treedef = jax.tree.flatten(tree)
        return {at: to_numpy(treedef.unflatten([
            next(s.data for s in a.addressable_shards
                 if where[s.device.id] == at) for a in flat]))
            for at in where.values()}

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
        if i == 0:
            r["m0_shards"] = shards(o["m"])
    r["params"], r["m_shards"] = to_numpy(p), shards(o["m"])
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
    out[name] = r
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(name):
    aid, _, kw = CASES[name]
    return dataclasses.replace(reduced(get_arch(aid)), **kw)


def _numpy(tree):
    """A copy of ``tree`` as numpy (AdamW updates its state in place)."""
    return tr.tree_map(lambda t: np.array(t.detach().float()), tree)


def _batch(cfg, seed):
    from test_torch_arch_train import batch_np

    return {k: torch.from_numpy(v)
            for k, v in batch_np(cfg, B, S, seed=seed).items()}


def _case_run(name, r, mesh):
    """One process's run of case ``name`` against the reference's run
    ``r``: the steps (collectives counted, drops recorded, the first
    moment after the first), prefill and decode."""
    cfg = _cfg(name)
    kw = dict(param_dtype=torch.float32, device="cpu")
    su = steps.make_setup(cfg, ShapeSpec("t", S, B, "train"), mesh,
                          opt_cfg=AdamWConfig(lr=LR),
                          lr_schedule=lambda step: 1.0, **kw)
    params = su.place(params_from_jax(r["params0"], device="cpu"))
    opt = su.init_opt_state(params)
    got = {"loss": [], "grad_norm": [], "counts": [], "drops": []}
    for i in range(STEPS):
        C.reset_counts()
        with record_drops() as drops:
            params, opt, m = su.step_fn(params, opt, _batch(cfg, i))
        got["counts"].append(C.counts())
        got["drops"].append(sum(drops))
        got["loss"].append(float(m["loss"]))
        got["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            got["m0"] = _numpy(opt["m"])
    got["params"], got["m"] = _numpy(params), _numpy(opt["m"])
    pf = steps.make_setup(cfg, ShapeSpec("p", T, B, "prefill"), mesh, **kw)
    C.reset_counts()
    last, cache = pf.step_fn(params, {"tokens": torch.from_numpy(r["tokens"])})
    got["prefill_counts"] = C.counts()
    got["prefill"], got["cache"] = last.numpy(), _numpy(cache)
    dc = steps.make_setup(cfg, ShapeSpec("d", T, B, "decode"), mesh, **kw)
    got["decode"], got["decode_from_ref"], got["same_rows"] = [], [], []
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(r["decode_tokens"][i]),
                 "pos": torch.tensor(T - STEPS + i)}
        C.reset_counts()
        logits, cache = dc.step_fn(params, cache, batch)
        if i == 0:
            got["decode_counts"] = C.counts()
        got["decode"].append(logits.numpy())
        placed, after = (
            place({k: torch.from_numpy(v).to(torch.bfloat16)
                   for k, v in cache_to_port(r["cache"][j], cfg).items()},
                  dc.cache_specs, mesh) for j in (i, i + 1))
        logits, placed = dc.step_fn(params, placed, batch)
        got["decode_from_ref"].append(logits.numpy())
        # the batch rows whose fresh K/V this process rounded into its
        # cache shard as the reference rounded them
        got["same_rows"].append(torch.stack([
            (placed[n] == after[n]).transpose(0, 1).reshape(
                placed[n].shape[1], -1).all(-1) for n in placed]).all(0)
            .numpy())
    got["specs"] = (su.param_specs, su.opt_specs["m"])
    got["seq_split"] = sorted(n for n, sp in dc.cache_specs.items()
                              if tuple(sp)[2] is not None)
    return (mesh.replica, mesh.rank), got


def _rank_run(ref):
    """One process of the 4: every case on its mesh."""
    meshes, out = {}, {}
    for name, (_, shape, _) in CASES.items():
        if shape not in meshes:
            meshes[shape] = make_test_mesh(*shape, backend="gloo",
                                           device="cpu")
        at, out[name] = _case_run(name, ref[name], meshes[shape])
        out[name]["at"] = at
    return out


def _predicted(name, kind, at):
    mesh = make_production_mesh(replica=at[0], rank=at[1],
                                shape=CASES[name][1])
    try:
        return dryrun.count_step(_cfg(name), dryrun.parse_shape(KINDS[kind]),
                                 mesh, param_dtype=torch.float32)["calls"]
    finally:
        close_fake_mesh()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a subprocess a case, 4 fake devices each, run
    side by side) and the port's (4 spawned processes), each case's
    results by (replica, rank); and the dry-run's predicted collectives,
    counted here while the reference runs, by (case, kind, (replica,
    rank))."""
    tmp = tmp_path_factory.mktemp("arch_moe_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, HERE)),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / f"{name}.pkl"),
         repr(({name: case}, B, S, T, LR, STEPS))],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env) for name, case in CASES.items()}
    try:
        predicted = {(name, kind, at): _predicted(name, kind, at)
                     for name, (_, shape, _) in CASES.items()
                     for kind in KINDS
                     for at in np.ndindex(*shape)}
        errs = {name: proc.communicate(timeout=600)[1]
                for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = {}
    for name, proc in procs.items():
        assert proc.returncode == 0, errs[name][-3000:]
        with open(tmp / f"{name}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    ranks = spawn(_rank_run, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(ref,))
    return ref, {name: {r[name]["at"]: r[name] for r in ranks}
                 for name in CASES}, predicted


def _mesh_at(shape, replica, rank):
    """What `local_shard` reads of process (replica, rank)'s mesh."""
    return type("At", (), dict(n_data=shape[0], n_model=shape[1],
                               replica=replica, rank=rank))()


def _assert_shards(got, full, specs, mesh, what):
    for (path, g), f, s in zip(tr.leaves_with_path(got), tr.leaves(full),
                               tr.leaves(specs)):
        want = local_shard(torch.as_tensor(f).float(), s, mesh)
        assert tuple(g.shape) == tuple(want.shape), (what, path)
        np.testing.assert_allclose(g, want.numpy(), atol=TOL, rtol=0,
                                   err_msg=f"{what} {tr.path_key(path)}")


@pytest.mark.parametrize("name", MOE)
def test_router_gradient_matches_reference(runs, name):
    """At n_data = 2 with the configs' router_aux_coef (0.01): the first
    step's router gradient, its ZeRO-1 slice of ``m / (1 - b1)`` on each
    process, equals the reference's GSPMD gradient of the global loss."""
    ref, ranks, _ = runs
    b1 = AdamWConfig().b1
    for at, got in ranks[name].items():
        want = params_from_jax(ref[name]["m0_shards"][at], device="cpu")
        for i, (g, w) in enumerate(zip(got["m0"]["layers"],
                                       want["layers"])):
            g, w = g["ffn"]["router"], w["ffn"]["router"].numpy()
            np.testing.assert_allclose(g / (1 - b1), w / (1 - b1),
                                       atol=TOL, rtol=0,
                                       err_msg=f"{at} layer {i}")
            assert np.abs(w / (1 - b1)).max() > 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_reference(runs, name):
    ref, ranks, _ = runs
    r, shape = ref[name], CASES[name][1]
    for (d, k), got in ranks[name].items():
        np.testing.assert_allclose(got["loss"], r["loss"], atol=TOL, rtol=0)
        np.testing.assert_allclose(got["grad_norm"], r["grad_norm"],
                                   atol=TOL, rtol=0)
        pspecs, mspecs = got["specs"]
        _assert_shards(got["params"], params_from_jax(r["params"],
                                                      device="cpu"),
                       pspecs, _mesh_at(shape, d, k), f"params {(d, k)}")
        # ZeRO-1: the port's first-moment slice is the reference's
        # addressable shard on device (d, k), expert shards included
        want = params_from_jax(r["m_shards"][(d, k)], device="cpu")
        for (path, g), w in zip(tr.leaves_with_path(got["m"]),
                                tr.leaves(want)):
            assert g.shape == tuple(w.shape), (path, g.shape, w.shape)
            np.testing.assert_allclose(g, w.numpy(), atol=TOL, rtol=0,
                                       err_msg=f"m {(d, k)} "
                                       f"{tr.path_key(path)}")
        assert any("data" in tuple(s) for s in tr.leaves(mspecs)) == \
            (shape[0] > 1)


@pytest.mark.parametrize("name", MOE)
def test_moe_steps_drop_slots(runs, name):
    """The parity above holds where capacity per (process, expert) drops
    slots: the steps dropped some on some process."""
    _, ranks, _ = runs
    assert sum(sum(got["drops"]) for got in ranks[name].values()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_cache_match_reference(runs, name):
    ref, ranks, _ = runs
    r, cfg, shape = ref[name], _cfg(name), CASES[name][1]
    bl = B // shape[0]
    for (d, k), got in ranks[name].items():
        assert got["seq_split"], "the cache's rows should split over model"
        np.testing.assert_allclose(got["prefill"],
                                   r["prefill"][d * bl:(d + 1) * bl],
                                   atol=TOL, rtol=0)
        want = cache_to_port(r["cache_shards"][(d, k)], cfg)
        assert set(want) == set(got["cache"])
        for leaf_name, leaf in got["cache"].items():
            assert leaf.shape == want[leaf_name].shape, leaf_name
            # one bf16 rounding each of f32 values within TOL: at most
            # TOL and one unit in the last place apart
            diff = np.abs(leaf - want[leaf_name])
            bad = diff > np.abs(want[leaf_name]) * 2.0 ** -7 + TOL
            assert not bad.any(), (leaf_name, leaf[bad], want[leaf_name][bad])


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_reference(runs, name):
    """Each decode step from the reference's cache: within 3e-5 on the
    batch rows whose fresh K/V every process of the replica rounded into
    the bf16 cache as the reference did; a row where one element rounded
    the other way (f32 values a few ulps apart, near a bf16 midpoint)
    moves its logits by up to ~5e-5, and is held at the bf16 cache
    tolerance, as the chained decode is, with its greedy token equal."""
    ref, ranks, _ = runs
    r, shape = ref[name], CASES[name][1]
    bl = B // shape[0]
    exact = 0
    for d in range(shape[0]):
        procs = [got for (dd, _), got in ranks[name].items() if dd == d]
        for i in range(STEPS):
            want = r["decode"][i][d * bl:(d + 1) * bl]
            same = np.all([got["same_rows"][i] for got in procs], axis=0)
            exact += int(same.sum())
            for got in procs:
                np.testing.assert_allclose(got["decode_from_ref"][i][same],
                                           want[same], atol=TOL, rtol=0,
                                           err_msg=f"step {i}")
                np.testing.assert_allclose(got["decode_from_ref"][i], want,
                                           atol=BF16_CACHE_TOL, rtol=0,
                                           err_msg=f"step {i}")
                np.testing.assert_allclose(got["decode"][i], want,
                                           atol=BF16_CACHE_TOL, rtol=0,
                                           err_msg=f"own cache, step {i}")
                for logits in (got["decode"][i], got["decode_from_ref"][i]):
                    np.testing.assert_array_equal(logits.argmax(-1),
                                                  want.argmax(-1))
    assert exact >= B * STEPS // 2, exact


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(CASES))
def test_predicted_collectives_equal_executed(runs, name, kind):
    _, ranks, predicted = runs
    for at, got in ranks[name].items():
        want = predicted[name, kind, at]
        executed = (got["counts"] if kind == "train"
                    else [got[f"{kind}_counts"]])
        for i, ex in enumerate(executed):
            assert want == ex, (name, kind, at, i)
        if name in MOE:
            assert want[("all_to_all", "model")][0] > 0
    if name == "split_heads" and kind == "train":
        assert want[("reduce_scatter", "model")][0] > 0


def test_split_heads_layout():
    """Each rank's columns, the heads they touch and the KV heads those
    read, for 6 heads of 64 over 2 KV heads on 4 ranks (96 columns a
    rank: every rank cuts a head); H not a multiple of KVH is refused as
    wrong input."""
    from repro_torch.models.attention import local_heads

    cfg = _cfg("split_heads")
    assert [tuple(local_heads(cfg, 4, r)) for r in range(4)] == [
        (0, 96, 0, 2, 0, 1), (96, 192, 1, 3, 0, 1),
        (192, 288, 3, 5, 1, 2), (288, 384, 4, 6, 1, 2)]
    with pytest.raises(ValueError, match="do not group"):
        local_heads(dataclasses.replace(cfg, n_kv_heads=4), 4, 0)


# ---------------------------------------------------------------------------
# the autograd collectives, each against one process's gradient

N_ROWS, WIDTH = 4, 3


def _seeded(i, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(i),
                       dtype=torch.float64)


def _collective_checks():
    """One process of a 2 × 2 mesh: each autograd collective's forward and
    its backward on seeded inputs, as the gradients of ``x`` (this
    process's input) to hold against one process's."""
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    me, n = mesh.rank, mesh.n_model
    base = mesh.replica * n
    out = {"at": (mesh.replica, mesh.rank)}

    # all_to_all: ragged splits, rows from peer j to peer i
    counts = [[1 + (i + j) % 2 for j in range(n)] for i in range(n)]
    x = _seeded(base + me, sum(counts[me]), WIDTH).requires_grad_()
    y = C.all_to_all(x, counts[me], [counts[j][me] for j in range(n)],
                     mesh.model)
    (y * _seeded(100 + base + me, *y.shape)).sum().backward()
    out["all_to_all"] = (y.detach().numpy(), x.grad.numpy())

    # gather_into_region: every rank's partial use of the gathered rows
    x = _seeded(base + me, N_ROWS, WIDTH).requires_grad_()
    y = C.gather_into_region(x, mesh.model, dim=-1)
    (y * _seeded(200 + base + me, *y.shape)).sum().backward()
    out["gather_into_region"] = (y.detach().numpy(), x.grad.numpy())

    # gather_from_model: one loss of the gathered rows, the same on every
    # rank
    x = _seeded(base + me, N_ROWS, WIDTH).requires_grad_()
    y = C.gather_from_model(x, mesh.model, me)
    (y.square() * _seeded(300 + mesh.replica, *y.shape)).sum().backward()
    out["gather_from_model"] = (y.detach().numpy(), x.grad.numpy())

    # mesh_mean under the sharded step: a replicated weight enters the
    # region, its gradient is summed over model and averaged over data
    w = _seeded(400, WIDTH).requires_grad_()
    x = C.copy_to_model(w, mesh.model) * _seeded(base + me, WIDTH)
    y = C.mesh_mean(x, mesh)
    (y.square() * _seeded(500, WIDTH)).sum().backward()
    g = C.psum(w.grad, mesh.data) / mesh.n_data
    out["mesh_mean"] = (y.detach().numpy(), g.numpy())
    out["reduce_scatter"] = C.reduce_scatter_units(
        _seeded(base + me, 2 * n, WIDTH), mesh.model).numpy()

    # the sharded draw: each leaf cut as it is drawn, equal to the whole
    # draw placed
    su = steps.make_setup(_cfg("llama4"), ShapeSpec("t", S, B, "train"), mesh,
                          param_dtype=torch.float32, device="cpu")
    got = su.init_params(torch.Generator().manual_seed(0))
    want = su.place(su.model.init(torch.Generator().manual_seed(0)))
    out["init_shards"] = [
        (tr.path_key(p), bool(torch.equal(a, b)), a.is_contiguous())
        for (p, a), b in zip(tr.leaves_with_path(got), tr.leaves(want))]
    return out


@pytest.fixture(scope="module")
def collective_checks():
    return {r["at"]: r for r in spawn(_collective_checks, 4, backend="gloo",
                                      device="cpu", deadline_s=DEADLINE)}


def _one_process(name, replica):
    """The same functions of every process's input on one process: each
    process's output and its input's gradient, by rank of ``replica``."""
    n = 2
    base = replica * n
    if name == "all_to_all":
        counts = [[1 + (i + j) % 2 for j in range(n)] for i in range(n)]
        xs = [_seeded(base + i, sum(counts[i]), WIDTH).requires_grad_()
              for i in range(n)]
        parts = [list(x.split(c)) for x, c in zip(xs, counts)]
        ys = [torch.cat([parts[j][i] for j in range(n)]) for i in range(n)]
        weights = [_seeded(100 + base + i, *y.shape) for i, y in
                   enumerate(ys)]
    elif name == "gather_into_region":
        xs = [_seeded(base + i, N_ROWS, WIDTH).requires_grad_()
              for i in range(n)]
        ys = [torch.cat(xs, -1)] * n
        weights = [_seeded(200 + base + i, *ys[0].shape) for i in range(n)]
    else:
        xs = [_seeded(base + i, N_ROWS, WIDTH).requires_grad_()
              for i in range(n)]
        y = torch.cat(xs)
        y.square().mul(_seeded(300 + replica, *y.shape)).sum().backward()
        return [(y.detach().numpy(), x.grad.numpy()) for x in xs]
    sum((y * w).sum() for y, w in zip(ys, weights)).backward()
    return [(y.detach().numpy(), x.grad.numpy()) for y, x in zip(ys, xs)]


@pytest.mark.parametrize("name", ["all_to_all", "gather_into_region",
                                  "gather_from_model"])
def test_autograd_collective_matches_one_process(collective_checks, name):
    for (d, k), got in collective_checks.items():
        want_y, want_g = _one_process(name, d)[k]
        np.testing.assert_array_equal(got[name][0], want_y)
        np.testing.assert_allclose(got[name][1], want_g, rtol=1e-12,
                                   atol=1e-12)


def test_mesh_mean_gives_the_global_gradient(collective_checks):
    """The loss of the mean over all 4 processes, differentiated on one
    process, equals what the sharded step makes of `mesh_mean`'s backward
    (summed over model by the Megatron pair, averaged over data); an
    identity backward would come out 2 (= n_data) times too small."""
    w = _seeded(400, WIDTH).requires_grad_()
    y = sum(w * _seeded(i, WIDTH) for i in range(4)) / 4
    (y.square() * _seeded(500, WIDTH)).sum().backward()
    for got in collective_checks.values():
        np.testing.assert_allclose(got["mesh_mean"][0], y.detach().numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(got["mesh_mean"][1], w.grad.numpy(),
                                   rtol=1e-12)


def test_reduce_scatter_sums_and_keeps_this_ranks_slice(collective_checks):
    for (d, k), got in collective_checks.items():
        full = sum(_seeded(d * 2 + i, 4, WIDTH) for i in range(2))
        np.testing.assert_allclose(got["reduce_scatter"],
                                   full[2 * k:2 * k + 2].numpy(), rtol=1e-12)


def test_sharded_draw_equals_the_placed_whole_draw(collective_checks):
    """`Setup.init_params` on a mesh (`Model.init_shards`: the seed's
    draws, each leaf cut to the process's shard as it is drawn) equals
    `place` of the whole draw, leaf for leaf, bit for bit."""
    for got in collective_checks.values():
        assert got["init_shards"] and all(
            same and contiguous for _, same, contiguous
            in got["init_shards"]), got["init_shards"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_blocks_equals_the_whole_leaf_update(monkeypatch, dtype):
    """`optim.adamw_update` updates a leaf in blocks of its first dimension
    (which bounds a step's temporaries on the largest shards of a mesh
    process): three steps in blocks of 7 elements, 0-d and 1-d leaves and
    bf16 params with an f32 master included, equal the whole-leaf update
    bit for bit."""
    import importlib

    adamw = importlib.import_module("repro_torch.optim.adamw")

    def run(block):
        monkeypatch.setattr(adamw, "BLOCK", block)
        g = torch.Generator().manual_seed(0)
        shapes = {"a": (37, 5), "b": (3, 4, 6), "c": (), "d": (11,)}
        params = {k: torch.randn(s, generator=g).to(dtype)
                  for k, s in shapes.items()}
        cfg = AdamWConfig(lr=1e-2)
        state = adamw.adamw_init(params, cfg)
        for _ in range(3):
            grads = {k: torch.randn(s, generator=g).to(dtype)
                     for k, s in shapes.items()}
            params, state, _ = adamw.adamw_update(grads, state, params, cfg)
        return params, state

    (p_whole, s_whole), (p_blocks, s_blocks) = run(1 << 30), run(7)
    assert ("master" in s_whole) == (dtype != torch.float32)
    for name in ("params", "m", "v", "master"):
        whole = p_whole if name == "params" else s_whole.get(name, {})
        blocks = p_blocks if name == "params" else s_blocks.get(name, {})
        for k in whole:
            assert torch.equal(whole[k], blocks[k]), (name, k)
