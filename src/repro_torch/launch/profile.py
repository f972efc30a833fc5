"""Profiler with two modes — port of `repro/launch/profile.py`.

Dry-run (default): one (arch × shape) step of one rank of the production
mesh on meta tensors (`launch.dryrun`), counted by
`launch.op_analysis`; prints the totals and the top byte/FLOP
contributors (``aten op:function``), the 'profile' behind §Perf
hypotheses.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch gemma2-9b --shape train_4k

Measured (``--measure``): the SAME pp=2 plan through the emulated
`NTPSession` (one process, the stage-sequential route) on the card AND
through a staged mesh of gloo processes (`launch.mesh.make_staged_mesh`
started by `launch.spawn`, the hand-off over send/recv); prints each
step's time from CUDA events (the host clock on the CPU) after the
reference's two warm-up steps, the measured and the analytic bubble
factor ``(m+pp-1)/m``, each session's `measure_sync` probe, the
pipeline's ticks and the hand-off byte table. ``--trace-dir`` wraps the
timed steps in `torch.profiler` (the emulated session's, and global rank
0's) and writes Chrome traces; ``--telemetry`` records the parent's
``session.step`` spans as JSONL.

On one card every process of the staged mesh shares the device and gloo
carries its collectives through host memory, so the staged mesh's step
is set by gloo: the "bubble factor" there is the gloo-to-one-card ratio,
not the pipeline bubble. The true one waits for one card a process over
NCCL (ROADMAP backlog (a2)).

  PYTHONPATH=src python -m repro_torch.launch.profile --measure --steps 5 --trace-dir /tmp/ntp-trace
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Optional


def _dryrun(args):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import count_step, parse_shape
    from repro_torch.launch.mesh import close_fake_mesh, make_production_mesh
    from repro_torch.launch.op_analysis import top_contributors

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    try:
        tot = count_step(get_arch(args.arch), parse_shape(args.shape), mesh,
                         param_dtype=torch.bfloat16)
    finally:
        close_fake_mesh()
    print(f"total: {tot['flops']/1e12:.2f} TF, {tot['bytes']/1e12:.2f} TB, "
          f"coll {tot['collective_moved_bytes']/1e12:.2f} TB moved")
    print(f"{'aten_op:function':60s} {'GB':>10s} {'TF':>8s} {'count':>7s}")
    for row in top_contributors(tot, args.top):
        print(f"{row['key'][:60]:60s} {row['bytes']/1e9:10.1f} "
              f"{row['flops']/1e12:8.2f} {row['count']:7.0f}")


def default_cfg(pp: int):
    """The reference's `--measure` model: tiny widths, two layers a
    stage."""
    from repro_torch.runtime import NTPModelConfig

    return NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16,
                          d_ff=256, unit_rows=64, n_layers=2 * pp, vocab=128)


def _batch(cfg, seq: int, rows: int, i: int):
    """Step ``i``'s global batch (the same for both sessions)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

    return SyntheticLMPipeline(DataConfig(cfg.vocab, seq, rows,
                                          seed=0))._batch_np(i)


class _Clock:
    """One step's milliseconds: CUDA events on the card (after the
    step's work is queued, the end event is waited on), the host clock on
    the CPU."""

    def __init__(self, device):
        import torch

        self.torch, self.cuda = torch, device.type == "cuda"

    def __call__(self, fn):
        if self.cuda:
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in "se"]
            ev[0].record()
            r = fn()
            ev[1].record()
            ev[1].synchronize()
            return r, ev[0].elapsed_time(ev[1])
        t0 = time.perf_counter()
        r = fn()
        return r, (time.perf_counter() - t0) * 1e3


def _profiler(trace_dir: Optional[str], name: str, device):
    """A `torch.profiler.profile` over CPU (and CUDA on the card) whose
    Chrome trace goes to ``trace_dir/name.json``; a null context without
    ``trace_dir``."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)

    def done(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))

    return torch.profiler.profile(activities=acts, on_trace_ready=done)


def _run(session, cfg, seq, rows, steps, warmup, events, clock, trace_dir,
         name, device):
    """Every step of one session: ``events`` applied before their steps,
    ``warmup`` steps, then ``steps`` timed ones (under the profiler with a
    ``trace_dir``). Each step's record: loss, ms, plan, local batches,
    ticks and hand-off table, collective counts and kernel launches."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.kernels import mode

    out = {"steps": [], "events": []}
    prof = None
    for i in range(warmup + steps):
        if i in events:
            old = session.plan
            C.reset_counts()
            _, ms = clock(lambda: session.apply(events[i]))
            if device.type == "cuda":
                # gloo stages a transition's CUDA tensors through pinned
                # host blocks it keeps cached; the processes share the host
                torch._C._host_emptyCache()
            out["events"].append({
                "step": i, "old": old, "new": session.plan, "ms": ms,
                "ledger": session.last_transition.as_dict(),
                "per_pair": dict(session.last_transition.per_pair),
                "counts": C.counts()})
        if i == warmup:
            prof = _profiler(trace_dir, name, device)
            prof.__enter__()
        batch = _batch(cfg, seq, rows, i)
        C.reset_counts()
        before = mode.launches()
        m, ms = clock(lambda: session.step(batch))
        after = mode.launches()
        out["steps"].append({
            "loss": float(m["loss"]), "ms": ms, "timed": i >= warmup,
            "plan": session.plan, "local_batches": tuple(session.local_batches),
            "ticks": m.get("pipeline_ticks"), "handoff": m.get("handoff"),
            "counts": C.counts(),
            "launches": {k: after[k] - before[k] for k in after}})
    if prof is not None:
        prof.__exit__(None, None, None)
        if hasattr(prof, "key_averages"):
            out["top"] = _top_device_ops(prof)
    out["sync"] = session.measure_sync(_batch(cfg, seq, rows, warmup + steps))
    return out


def _top_device_ops(prof, n: int = 5):
    """The ``n`` ops with the most self device time (ms), from a finished
    profiler (none on the CPU)."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0:
            rows.append((e.key, t / 1e3))
    rows.sort(key=lambda r: -r[1])
    return rows[:n]


def _measure_rank(cfg, run: Dict, finish: Optional[Callable],
                  finish_args) -> Dict:
    """One (stage, replica, rank) process of the staged mesh: its stage's
    share of the seed-0 weights, `_run` through the same plan, steps and
    events as the emulated session; then ``finish(session, mesh,
    *finish_args)`` when given (a caller's own checks)."""
    import torch

    from repro_torch.core import ntp_train as nt
    from repro_torch.launch.mesh import make_staged_mesh
    from repro_torch.runtime import NTPSession
    from repro_torch.optim import sgd

    mesh = make_staged_mesh(run["pp"], run["n_data"], run["n_model"],
                            backend="gloo", device=run["device"])
    dev = mesh.device
    if dev.type == "cuda" and run["memory_share"]:
        torch.cuda.set_per_process_memory_fraction(
            run["memory_share"][mesh.stage], dev)
        torch.cuda.reset_peak_memory_stats(dev)
    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev, pp=run["pp"], stage=mesh.stage)
    s = NTPSession.create(cfg, mesh, local_batch=run["batch"],
                          optimizer=sgd(run["lr"]), params=canon,
                          pp=run["pp"], microbatches=run["microbatches"],
                          overlap=run["overlap"])
    del canon
    trace = run["trace_dir"] if mesh.global_rank == 0 else None
    out = _run(s, cfg, run["seq"], run["n_data"] * run["batch"], run["steps"],
               run["warmup"], run["events"], _Clock(dev), trace,
               "staged_rank0", dev)
    out["rank"] = (mesh.stage, mesh.replica, mesh.rank)
    out["collectives"] = (s.step_fn.collectives,
                          s.step_fn.replicated_collectives)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9,
                      torch.cuda.max_memory_reserved(dev) / 1e9) \
        if dev.type == "cuda" else (0.0, 0.0)
    if finish is not None:
        out["finish"] = finish(s, mesh, *finish_args)
    return out




def measure(*, steps: int = 5, pp: int = 2, microbatches: int = 4,
            batch: int = 8, seq_len: int = 32, overlap: bool = False,
            trace_dir: Optional[str] = None, n_data: int = 2,
            n_model: int = 4, cfg=None, device=None, lr: float = 0.05,
            warmup: int = 2, events: Optional[Dict] = None,
            memory_share=None, after_emulated: Optional[Callable] = None,
            finish: Optional[Callable] = None, finish_args=(),
            report: Callable = print) -> Dict:
    """The ``--measure`` mode: the pp=``pp`` plan through the emulated
    session on ``device`` (CUDA unless ``device="cpu"``), then through a
    staged mesh of ``pp · n_data · n_model`` gloo processes on the same
    device, each with the seed-0 weights, SGD at ``lr``, local batch
    ``batch`` of ``seq_len`` tokens, ``microbatches`` and ``overlap``;
    ``warmup`` steps then ``steps`` timed ones, ``events`` (step index →
    lifecycle event) applied before their steps in both. Prints what the
    reference's prints (through ``report``) and returns the records:
    ``emulated`` (one `_run`), ``staged`` (one per process, in global rank
    order), ``t_emu``/``t_sub`` (per-step medians of the timed steps, the
    staged step the slowest process's), ``bubble``, ``analytic`` and
    ``trace_dir``.

    ``cfg`` (default `default_cfg`), ``n_data``/``n_model``, ``events``,
    ``memory_share`` (each stage's cap on the card's memory, by stage),
    ``after_emulated(session)`` (called in this process before the spawn)
    and ``finish(session, mesh, *finish_args)`` (a module-level function
    each process runs at its end) let a caller run a smaller mesh or check
    more."""
    import torch

    from repro_torch.core import ntp_train as nt
    from repro_torch.kernels.mode import resolve_device
    from repro_torch.launch.spawn import spawn
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    dev = resolve_device(device)
    cfg = cfg or default_cfg(pp)
    events = dict(events or {})
    clock = _Clock(dev)
    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    emu = NTPSession.create(cfg, (n_data, n_model), local_batch=batch,
                            optimizer=sgd(lr), params=canon, pp=pp,
                            microbatches=microbatches, overlap=overlap,
                            device=dev)
    del canon
    report(f"emulation: pp={pp} on a ({n_data}, {n_model}) mesh, "
           "stage-sequential, on one device")
    t0 = time.perf_counter()
    e = _run(emu, cfg, seq_len, n_data * batch, steps, warmup, events,
             clock, trace_dir, "emulated", dev)
    for i, st in enumerate(e["steps"]):
        report(f"  emu step {i}{'' if st['timed'] else ' (warm-up)'}: "
               f"{st['ms']:8.1f} ms  loss {st['loss']:.4f}")
    report(f"  ({time.perf_counter() - t0:.1f} s)")
    if after_emulated is not None:
        after_emulated(emu)
    del emu
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n = pp * n_data * n_model
    report(f"submesh:   pp={pp} on a ({pp}, {n_data}, {n_model}) staged mesh "
           f"of {n} gloo processes, send/recv hand-off")
    run = dict(pp=pp, n_data=n_data, n_model=n_model, device=dev.type,
               memory_share=memory_share, batch=batch, lr=lr,
               microbatches=microbatches, overlap=overlap, seq=seq_len,
               steps=steps, warmup=warmup, events=events,
               trace_dir=trace_dir)
    t0 = time.perf_counter()
    ranks = spawn(_measure_rank, n, backend="gloo", device=dev.type,
                  deadline_s=900,
                  args=(cfg, run, finish, tuple(finish_args)))
    wall = time.perf_counter() - t0
    sub = [max(r["steps"][i]["ms"] for r in ranks)
           for i in range(warmup + steps)]
    for i, ms in enumerate(sub):
        st = ranks[0]["steps"][i]
        report(f"  sub step {i}{'' if st['timed'] else ' (warm-up)'}: "
               f"{ms:8.1f} ms  loss {st['loss']:.4f} (slowest process)")
    report(f"  ({wall:.1f} s: spawned, run and joined)")

    def median(ms):
        timed = [m for m, st in zip(ms, e["steps"]) if st["timed"]]
        return statistics.median(timed) if timed else float("nan")

    t_emu = median([st["ms"] for st in e["steps"]])
    t_sub = median(sub)
    analytic = (microbatches + pp - 1) / microbatches
    sync_s = max(r["sync"]["sync_s"] for r in ranks)
    for name, s, sec in (("emu", e["sync"], e["sync"]["sync_s"]),
                         ("sub", ranks[0]["sync"], sync_s)):
        report(f"  {name} sync probe (overlap {s['overlap']}): "
               f"{sec * 1e3:.1f} ms, {s['collectives']} collectives")
    report(f"per-step median: emulation {t_emu:.1f} ms, "
           f"submesh {t_sub:.1f} ms")
    bubble = t_sub / t_emu
    report(f"bubble factor: measured {bubble:.3f} vs analytic "
           f"(m+pp-1)/m = {analytic:.3f} "
           f"(rel err {abs(bubble - analytic) / analytic:.3f}; on one card "
           "the staged mesh runs on gloo: this is the gloo-to-one-device "
           "ratio, not the pipeline bubble)")
    last = ranks[0]["steps"][-1]
    report(f"pipeline ticks/step: {last['ticks']}")
    report("cross-stage hand-off (bytes, from the send/recv transfer "
           "shapes):")
    for k, v in (last["handoff"] or {}).items():
        report(f"  {k:20s} {v}")
    if trace_dir:
        report(f"profiler traces written to {trace_dir}")
    return {"emulated": e, "staged": ranks, "t_emu": t_emu, "t_sub": t_sub,
            "bubble": bubble, "analytic": analytic, "wall_s": wall,
            "trace_dir": trace_dir}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="time the emulated vs staged-mesh pp step instead "
                         "of the dry-run's op analysis")
    ap.add_argument("--trace-dir", default=None,
                    help="with --measure: torch.profiler Chrome traces")
    ap.add_argument("--telemetry", default=None, metavar="OUT.jsonl",
                    help="with --measure: record session.step spans etc. as "
                         "JSONL (repro_torch.telemetry)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8,
                    help="with --measure: per-replica batch")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--overlap", choices=["on", "off"], default="off",
                    help="with --measure: overlapped bucketed gradient sync "
                         "(core/overlap) in both sessions")
    args = ap.parse_args(argv)
    if args.telemetry and not args.measure:
        ap.error("--telemetry needs --measure (dry-run has no timed steps)")
    if args.measure:
        if args.telemetry:
            from repro_torch import telemetry

            telemetry.configure(jsonl=args.telemetry)
        measure(steps=args.steps, pp=args.pp, microbatches=args.microbatches,
                batch=args.batch, seq_len=args.seq_len,
                overlap=args.overlap == "on", trace_dir=args.trace_dir)
        if args.telemetry:
            telemetry.shutdown()
            print(f"telemetry stream written to {args.telemetry}")
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required unless --measure is set")
    _dryrun(args)


if __name__ == "__main__":
    main()
