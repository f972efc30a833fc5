"""`launch.dryrun` of the port on the CPU: one process plays a process of a
mesh on meta tensors over the fake process groups
(`launch.mesh.make_production_mesh`), and its counts are held to a real
run:

* predicted equals executed: the dry-run's (calls, bytes) for every (op,
  group) of reduced qwen2-7b and gemma2-9b (a sliding window of 8, so
  its ring cache wraps) on a (2, 2) mesh — train, prefill and one decode
  step, for each of the four processes — equal `core.collectives.counts()`
  of a real 2 × 2 gloo run of the same steps on the CPU (`launch.spawn`);
* the meta FLOPs equal `FlopCounterMode`'s on the same step with real CPU
  tensors, on each process and on one device;
* the per-device dot FLOPs within 5 % of the reference's `analyze_hlo`
  (its dot instructions, trip counts multiplied) for the same arch, shape
  and (2, 2) mesh on 4 fake JAX devices in a subprocess (the mesh built
  with automatic axes, as tests/test_torch_arch_ranks.py builds it);
* at the production mesh: gemma2-9b ``train_4k`` is ``ok`` on 256 chips,
  and so is qwen2-7b's, whose 28 heads split over 16 ranks; mamba2-780m
  gives ``ok: False`` naming its ROADMAP 7g row; ``long_500k`` is skipped
  with the arch's ``long_decode_note``; ``launch.train --dry-run`` prints
  a record. (The MoE route's collectives are held to a run in
  tests/test_torch_arch_moe_ranks.py.)

The spawned processes import this module, so JAX is imported only inside
the subprocess."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch, reduced
from repro_torch.core import collectives as C
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (close_fake_mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.spawn import spawn
from repro_torch.models.transformer import build_model
from repro_torch.train.steps import make_setup

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
B, S, P, N = 4, 16, 12, 4
CASES = (("qwen2-7b", {}), ("gemma2-9b", {"window": 8}))
SHAPES = {"train": f"train:{B}x{S}", "prefill": f"prefill:{B}x{P}+{N}",
          "decode": f"decode:{B}x{P}+{N}"}
AT = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _cfg(aid, kw):
    return dataclasses.replace(reduced(get_arch(aid)), **kw)


def _setup(cfg, kind, mesh, **kw):
    return make_setup(cfg, dryrun.parse_shape(SHAPES[kind]), mesh,
                      param_dtype=torch.float32, **kw)


def _executed():
    """One process of a 2 × 2 gloo mesh on the CPU: each case's train step
    (its FLOPs counted), prefill and first decode step, each step's
    collectives counted."""
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    g = torch.Generator().manual_seed(5)
    out = {}
    for aid, kw in CASES:
        cfg = _cfg(aid, kw)
        full = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        su = _setup(cfg, "train", mesh, device="cpu")
        params = su.place(full)
        opt = su.init_opt_state(params)
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                  dtype=torch.int32)
                 for k in ("tokens", "targets")}
        C.reset_counts()
        with FlopCounterMode(display=False) as fc:
            params, opt, _ = su.step_fn(params, opt, batch)
        got = {"train": C.counts(), "flops": fc.get_total_flops()}
        pf = _setup(cfg, "prefill", mesh, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                             dtype=torch.int32)
        C.reset_counts()
        last, cache = pf.step_fn(params, {"tokens": toks})
        got["prefill"] = C.counts()
        dc = _setup(cfg, "decode", mesh, device="cpu")
        tok = C.all_gather_units(last.argmax(-1)[:, None].int(), mesh.data)
        C.reset_counts()
        dc.step_fn(params, cache, {"tokens": tok.reshape(B, 1), "pos": P})
        got["decode"] = C.counts()
        out[aid] = got
    return (mesh.replica, mesh.rank), out


@pytest.fixture(scope="module")
def executed():
    ranks = spawn(_executed, 4, backend="gloo", device="cpu", deadline_s=120)
    return dict(ranks)


def _predicted(cfg, kind, at):
    mesh = make_production_mesh(replica=at[0], rank=at[1], shape=(2, 2))
    try:
        return dryrun.count_step(cfg, dryrun.parse_shape(SHAPES[kind]), mesh,
                                 param_dtype=torch.float32)
    finally:
        close_fake_mesh()


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("aid,kw", CASES)
def test_predicted_collectives_equal_executed(executed, aid, kw, kind):
    cfg = _cfg(aid, kw)
    for at in AT:
        got = _predicted(cfg, kind, at)["calls"]
        assert got == executed[at][aid][kind], (aid, kind, at)
        assert got, "the step ran no collective"


@pytest.mark.parametrize("aid,kw", CASES)
def test_meta_flops_equal_real_flops(executed, aid, kw):
    """Meta FLOPs equal FlopCounterMode's on real CPU tensors: each
    process of the mesh, and the one-device step."""
    cfg = _cfg(aid, kw)
    for at in AT:
        meta = _predicted(cfg, "train", at)
        assert meta["aten_flops"] == meta["flops"] == \
            executed[at][aid]["flops"], at
    meta = dryrun.count_step(cfg, dryrun.parse_shape(SHAPES["train"]), None,
                             param_dtype=torch.float32)
    su = _setup(cfg, "train", None, device="cpu")
    params = su.place(su.model.init(torch.Generator().manual_seed(0)))
    batch = {k: torch.zeros((B, S), dtype=torch.int32)
             for k in ("tokens", "targets")}
    with FlopCounterMode(display=False) as fc:
        su.step_fn(params, su.init_opt_state(params), batch)
    assert meta["flops"] == fc.get_total_flops() > 0


_JAX_SIDE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_arch, reduced
from repro.configs.shapes import ShapeSpec
from repro.launch.hlo_analysis import HloCostModel
from repro.train.steps import make_setup

class DotOnly(HloCostModel):
    # the dot instructions' FLOPs alone (fusion bodies and loops walked,
    # trip counts multiplied): what FlopCounterMode counts of the port
    def _instr_cost(self, comp, ins, count_bytes):
        c = super()._instr_cost(comp, ins, count_bytes)
        if ins.op not in ("dot", "fusion", "while", "conditional", "call"):
            c.flops = 0.0
        return c

cases, B, S = eval(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for aid, kw in cases:
    cfg = dataclasses.replace(reduced(get_arch(aid)), **kw)
    su = make_setup(cfg, ShapeSpec("t", S, B, "train"), mesh,
                    param_dtype=jnp.float32)
    with mesh:
        txt = su.jit_step().lower(*su.abstract_args()).compile().as_text()
    out[aid] = DotOnly(txt).cost().flops
print(repr(out))
"""


def test_dot_flops_within_5_percent_of_the_reference_hlo():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE,
                        repr((CASES, B, S))], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = eval(r.stdout.strip().splitlines()[-1])
    for aid, kw in CASES:
        ours = _predicted(_cfg(aid, kw), "train", (0, 0))["flops"]
        print(f"{aid} train {B}x{S} on (2, 2), per device: the port "
              f"{ours:,.0f} FLOPs, the reference's HLO dots {ref[aid]:,.0f}")
        assert abs(ours - ref[aid]) <= 0.05 * ref[aid], (aid, ours, ref[aid])


def test_production_record_of_gemma2():
    rec = dryrun.run_one("gemma2-9b", "train_4k")
    assert rec["ok"] and rec["chips"] == 256 and rec["mesh"] == "pod16x16"
    assert rec["hlo_flops_per_device"] > 0 and rec["collectives"]
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert {"argument_bytes", "output_bytes", "temp_bytes"} <= \
        set(rec["memory"])
    assert not dist.is_initialized()


def test_sweep_records_refusals_and_skips(tmp_path):
    """The sweep writes every record and exits 1 on a refusal, as the
    reference's: qwen2-7b's train_4k is ok (its 28 heads split over 16
    ranks), mamba2-780m's names its 7g row as a part not ported;
    long_500k is skipped with the arch's note."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-7b,mamba2-780m", "--shape",
                     "train_4k,long_500k", "--out", str(tmp_path)])
    assert e.value.code == 1

    def rec(arch, shape):
        with open(tmp_path / f"{arch}__{shape}__pod16x16.json") as f:
            return json.load(f)

    ok = rec("qwen2-7b", "train_4k")
    assert ok["ok"] and ok["chips"] == 256 and \
        ("reduce_scatter", "model") in {(c["op"], c["group"])
                                        for c in ok["calls"]}
    r = rec("mamba2-780m", "train_4k")
    assert r["ok"] is False and r["error"].startswith(
        "NotImplementedError") and \
        "7g: Mamba-2 and RG-LRU on the mesh" in r["error"], r
    skipped = rec("qwen2-7b", "long_500k")
    assert skipped["skipped"] and \
        skipped["reason"] == get_arch("qwen2-7b").long_decode_note
    assert not dist.is_initialized()


def test_fake_mesh_places_one_process():
    mesh = make_production_mesh(replica=3, rank=5)
    try:
        assert (mesh.global_rank, mesh.device.type, mesh.backend) == \
            (53, "meta", "fake")
        assert dist.get_world_size() == 256
        assert dist.get_world_size(mesh.model) == \
            dist.get_world_size(mesh.data) == 16
        mesh = make_production_mesh(True)
        assert dist.get_world_size(mesh.data) == 32
    finally:
        close_fake_mesh()
    with pytest.raises(ValueError, match="outside the"):
        make_production_mesh(replica=16)


def test_train_launcher_dry_run_prints_a_record(capsys):
    from repro_torch.launch.train import main as train_main

    rec = train_main(["--arch", "granite-3-2b", "--dry-run", "--shape",
                      "decode_32k"])
    out = capsys.readouterr().out
    assert rec["ok"] and rec["chips"] == 256 and rec["kind"] == "decode"
    assert "'hlo_flops_per_device'" in out and "'ok': True" in out
