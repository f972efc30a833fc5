"""`launch.dryrun_ntp` of the port on the CPU: the report keeps the
reference's keys (`repro/launch/dryrun_ntp.py`); at ``--mesh 2x2
--degraded-tp 1`` each rank run issues the all-to-alls the plan's
sequential sync needs (`core.overlap.sync_collectives`: reshard → sum →
reshard, two of its three collectives a unit leaf are all-to-alls), and
its (calls, bytes) for every (op, group) equal a real 2 × 2 gloo run of
the same step on the CPU (`launch.spawn`). Under NTP every replica's
ranks reshard (into the sync layout and out of it), the healthy
replica's too; a healthy plan issues no all-to-all."""
import json

import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.core import ntp_train as nt
from repro_torch.core import overlap as ov
from repro_torch.launch import dryrun_ntp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.optim import sgd
from repro_torch.runtime import ClusterHealth, Mode, plan_from_health

KW = dict(d_model=512, seq=128, local_batch=1)
# the reference's report keys (repro/launch/dryrun_ntp.py::run and ::main)
RUN_KEYS = {"replica_tp", "mode", "flops_per_device", "compute_s",
            "all_to_all", "all_reduce", "reshard_s", "allreduce_s",
            "collectives", "memory_temp_bytes"}
OVERHEAD_KEYS = {"reshard_s", "allreduce_increase_s", "reshard_vs_compute",
                 "note"}


def _plan(replica_tp, n1):
    fplan = plan_from_health(ClusterHealth(
        domain_size=n1, failed=tuple(n1 - t for t in replica_tp)))
    return fplan, Mode.UNIFORM if fplan.healthy else Mode.NTP


def _executed(replica_tp):
    """One process of a 2 × 2 gloo mesh on the CPU: one NTP step of the
    prototype under the plan, its collectives counted."""
    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    cfg = dryrun_ntp.build_cfg(KW["d_model"])
    fplan, mode = _plan(replica_tp, 2)
    step = nt.make_rank_train_step(cfg, fplan, mesh, mode=mode,
                                   local_batch=KW["local_batch"],
                                   optimizer=sgd(1e-2))
    canon = nt.init_canonical(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    params = nt.pack_rank_params(cfg, canon, fplan, mesh.replica, mesh.rank)
    tokens = torch.randint(0, cfg.vocab, (2, KW["seq"] + 1),
                           generator=torch.Generator().manual_seed(1))
    C.reset_counts()
    step(params, sgd(1e-2).init(params), tokens)
    return (mesh.replica, mesh.rank), C.counts()


def test_report_keeps_the_reference_keys(tmp_path):
    out = tmp_path / "ntp.json"
    dryrun_ntp.main(["--mesh", "2x4", "--degraded-tp", "3", "--d-model",
                     "512", "--seq", "128", "--out", str(out)])
    report = json.loads(out.read_text())
    assert set(report) == {"healthy", "degraded", "overhead"}
    assert set(report["overhead"]) == OVERHEAD_KEYS
    for run in ("healthy", "degraded"):
        assert RUN_KEYS <= set(report[run])
    assert report["healthy"]["reshard_s"] == 0
    assert report["degraded"]["reshard_s"] > 0
    assert report["degraded"]["mode"] == "ntp"
    # rank 0 of a healthy replica and every live rank of the degraded one
    assert [(r["replica"], r["rank"]) for r in report["degraded"]["ranks"]] \
        == [(1, 0), (0, 0), (0, 1), (0, 2)]


@pytest.fixture(scope="module")
def degraded():
    replica_tp = [1, 2]
    got = dict(spawn(_executed, 4, backend="gloo", device="cpu",
                     deadline_s=120, args=(replica_tp,)))
    return replica_tp, got, dryrun_ntp.run(replica_tp, mesh_shape=(2, 2),
                                           **KW)


def test_all_to_alls_follow_the_plans_sync(degraded):
    replica_tp, _, rec = degraded
    cfg = dryrun_ntp.build_cfg(KW["d_model"])
    fplan, mode = _plan(replica_tp, 2)
    sync = ov.sync_collectives(cfg, fplan, mode, bucketed=False)
    units = cfg.n_layers * len(nt.UNIT_KEYS)
    assert sync == 3 * units
    # under NTP every replica reshards into and out of the sync layout
    for r in rec["ranks"]:
        assert r["collectives"]["all-to-all"]["count"] == 2 * sync // 3, r
    assert rec["all_to_all"]["count"] == 2 * sync // 3
    healthy = dryrun_ntp.run([2, 2], mesh_shape=(2, 2), **KW)
    assert "all-to-all" not in healthy["collectives"]


def test_predicted_calls_equal_a_gloo_run(degraded):
    _, executed, rec = degraded
    cfg = dryrun_ntp.build_cfg(KW["d_model"])
    fplan, mode = _plan([1, 2], 2)
    for r in rec["ranks"]:
        at = (r["replica"], r["rank"])
        predicted = dryrun_ntp.rank_step(cfg, fplan, mode, *at,
                                         local_batch=KW["local_batch"],
                                         seq=KW["seq"], mesh_shape=(2, 2))
        assert predicted["calls"] == executed[at], at
        assert ("all_to_all", "model") in executed[at]
