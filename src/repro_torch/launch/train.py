"""Training launcher of the port: the NTP prototype through `NTPSession`,
with an injected mid-run GPU failure or a replayed failure trace (port of
the ``--ntp`` path of `repro/launch/train.py`: ``_run_ntp`` and
``_run_ntp_trace``).

Examples:

  # on the GPU: 2 emulated replicas x TP 4, fail one GPU before step 3
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --steps 8 \\
      --fail-at 3 --overlap on

  # the same on the CPU, with the plain versions of the kernels
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --steps 4 --fail-at 2 --seq-len 16

  # replay a mixed failure trace (fail -> boost -> repair, stragglers,
  # degraded links, SDC quarantine and rollback) under NTP-PW, with
  # canonical checkpoints and a telemetry stream
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --steps 12 --trace 200 --trace-seed 136 \\
      --trace-mix straggler=2,link=2,sdc=1 --power-policy ntp_pw \\
      --ckpt /tmp/ckpt.npz --ckpt-every 4 --telemetry /tmp/run.jsonl

The (data, model) mesh is emulated on one device: ``--devices N`` sets the
emulated ranks, as a (2, N/2) mesh. The uniform arch-stack launcher
(``--arch``), pipeline stages and the global allocator wait for their
slices (ROADMAP).
"""
import argparse
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntp", action="store_true",
                    help="train the NTP prototype via the runtime session "
                         "(the only launcher path ported so far)")
    ap.add_argument("--overlap", choices=["on", "off"], default="off",
                    help="overlapped, bucketed gradient sync")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a GPU failure before this step")
    ap.add_argument("--fail-replica", type=int, default=1,
                    help="DP replica whose scale-up domain loses a GPU")
    ap.add_argument("--fail-gpus", type=int, default=1,
                    help="GPUs lost in the failure event")
    ap.add_argument("--trace", type=float, default=None, metavar="RATE_MULT",
                    help="replay a Llama3-calibrated fail/repair trace at "
                         "this failure-rate multiplier")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="trace sampler seed (default 0)")
    ap.add_argument("--trace-mix", default=None, metavar="KIND=RATE[,...]",
                    help="mix degradation kinds into the sampled trace: "
                         "comma list of straggler=R, link=R, sdc=R onset "
                         "rates as multiples of the binary failure rate; "
                         "needs --trace")
    ap.add_argument("--quarantine", choices=["on", "off"], default="on",
                    help="SDC policy (default on): quarantine the suspect "
                         "replica and roll back to the canonical snapshot; "
                         "off = ledger the suspicion and keep training")
    ap.add_argument("--steps-per-hour", type=float, default=1.0,
                    help="training steps per simulated trace hour")
    ap.add_argument("--power-policy", choices=["ntp", "ntp_pw"], default=None,
                    help="per-transition NTP vs NTP-PW decision hook "
                         "(default: ntp when --trace is given)")
    ap.add_argument("--spares", type=int, default=0,
                    help="spare scale-up domains absorbing the worst "
                         "failures")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None,
                    help="canonical checkpoint path (written at the end)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also write it every N steps")
    ap.add_argument("--telemetry", default=None, metavar="OUT.jsonl",
                    help="record the run's telemetry stream (spans, "
                         "counters, gauges) as JSONL")
    ap.add_argument("--devices", type=int, default=0,
                    help="emulated ranks of the (2, n/2) mesh (default 8)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    args = ap.parse_args(argv)
    if not args.ntp:
        ap.error("only --ntp is ported: the uniform arch-stack launcher "
                 "(--arch) waits for its slice (ROADMAP Queue 1, 'uniform "
                 "arch launcher')")
    if args.trace is not None and args.fail_at is not None:
        ap.error("--trace and --fail-at are mutually exclusive")
    args.trace_mix_kwargs = {}
    if args.trace_mix is not None:
        if args.trace is None:
            ap.error("--trace-mix needs --trace (the mix rates scale the "
                     "same sampled trace)")
        from repro_torch.core.failure_model import parse_trace_mix

        try:
            args.trace_mix_kwargs = parse_trace_mix(args.trace_mix)
        except ValueError as e:
            ap.error(f"--trace-mix: {e}")
    if args.telemetry:
        from repro_torch import telemetry

        telemetry.configure(jsonl=args.telemetry)
        try:
            return _run_ntp(args)
        finally:
            telemetry.shutdown()
    return _run_ntp(args)


def _run_ntp(args) -> dict:
    """NTP prototype through the runtime session, with an optional injected
    mid-training failure (--fail-at) or a trace-driven lifecycle (--trace).
    Returns the per-step losses and the final plan (and, for a trace, the
    runner's summary)."""
    import torch

    from repro_torch import tree as tr
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels.mode import resolve_device
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.runtime import (
        FailureEvent, NTPModelConfig, NTPSession, power_policy,
    )

    dev = resolve_device(args.device)
    n_dev = args.devices or 8
    if n_dev < 2 or n_dev % 2:
        raise SystemExit(f"--devices {n_dev}: need an even count >= 2")
    if args.fail_at is not None and not 0 <= args.fail_replica < 2:
        raise SystemExit(
            f"--fail-replica {args.fail_replica} out of range for 2 DP replicas"
        )
    n1 = n_dev // 2
    cfg = NTPModelConfig(
        d_model=256, n_kv_groups=2 * n1, q_per_kv=2, head_dim=32,
        d_ff=max(512, 128 * n1), unit_rows=128, n_layers=2, vocab=2048,
    )
    policy_name = args.power_policy or ("ntp" if args.trace is not None
                                        else None)
    session = NTPSession.create(
        cfg, (2, n1), local_batch=args.batch,
        optimizer=adamw(AdamWConfig(lr=args.lr)),
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        overlap=args.overlap, device=dev,
        power_policy=power_policy(policy_name) if policy_name else None,
        spares=args.spares, quarantine=args.quarantine == "on",
    )
    n_par = sum(p.numel() for p in tr.leaves(session.canonical_params()))
    print(f"ntp prototype: {n_par/1e6:.1f}M params  mesh data=2 model={n1}  "
          f"plan {session.plan}"
          + (f"  overlap {args.overlap}" if args.overlap == "on" else "")
          + (f"  policy {policy_name}" if policy_name else "")
          + (f"  spares {args.spares}" if args.spares else "")
          + f"  device {dev}")

    pipe = SyntheticLMPipeline(
        DataConfig(cfg.vocab, args.seq_len, 2 * args.batch, seed=args.seed)
    )
    if args.trace is not None:
        return _run_ntp_trace(args, session, pipe)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        if args.fail_at is not None and i == args.fail_at:
            plan = session.apply(
                FailureEvent(step=i, replica=args.fail_replica,
                             n_gpus=args.fail_gpus)
            )
            print(f"*** step {i}: FailureEvent(replica={args.fail_replica}, "
                  f"n_gpus={args.fail_gpus}) "
                  f"-> plan {plan} mode {session.mode.value}")
        metrics = session.step(pipe._batch_np(i))
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(
                f"step {i:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"({(time.time()-t0):.1f}s)", flush=True,
            )
        if args.ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            session.save(args.ckpt)
            print(f"  saved canonical checkpoint -> {args.ckpt}")
    if args.ckpt:
        session.save(args.ckpt)
        print(f"final canonical checkpoint -> {args.ckpt}")
    return {"losses": losses, "plan": session.plan}


def _run_ntp_trace(args, session, pipe) -> dict:
    """Replay a sampled failure/recovery trace against the live session via
    the lifecycle orchestrator. The runner goes in chunks that end at every
    log step and every checkpoint step."""
    from collections import Counter

    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.runtime import TraceRunner, event_kind, schedule_from_trace

    d, n1 = session.plan.d, session.plan.n1
    trace_cfg = FailureTraceConfig(
        n_gpus=d * n1, domain_size=n1,
        days=args.steps / args.steps_per_hour / 24.0,
        rate_multiplier=args.trace, seed=args.trace_seed,
        **args.trace_mix_kwargs,
    )
    schedule = schedule_from_trace(
        trace_cfg, steps=args.steps, steps_per_hour=args.steps_per_hour,
    )
    kinds = Counter(event_kind(s.event) for s in schedule)
    print(f"trace: {len(schedule)} events over {args.steps} steps "
          f"({', '.join(f'{k}={n}' for k, n in sorted(kinds.items()))})")

    t0 = time.time()

    def on_event(ev, plan):
        print(f"*** step {ev.step}: {event_kind(ev)} domain {ev.domain} -> "
              f"plan {plan}  local_batches {session.local_batches}")

    runner = TraceRunner(session, schedule, on_event=on_event)
    log_every = max(args.log_every, 1)
    ckpt_every = args.ckpt_every if args.ckpt else 0
    marks = sorted({s for s in range(log_every, args.steps, log_every)}
                   | {s for s in range(ckpt_every, args.steps, ckpt_every)
                      if ckpt_every} | {args.steps})
    done = 0
    for stop in marks:
        hist = runner.run(lambda i: pipe._batch_np(i), stop - done)
        done = stop
        if stop % log_every == 0 or stop == args.steps:
            h = hist[-1]
            extra = (f"  boost {h['power_boost']:.2f}  rel_iter "
                     f"{h['rel_iter_time']:.3f}" if "power_boost" in h else "")
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}  tp {h['replica_tp']}{extra}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if ckpt_every and stop % ckpt_every == 0 and stop < args.steps:
            session.save(args.ckpt)
            print(f"  saved canonical checkpoint -> {args.ckpt}")
    s = runner.summary()
    by_kind = ", ".join(f"{k}={v}" for k, v in sorted(
        s["events_by_kind"].items()))
    roll = f", rollbacks {s['rollbacks']}" if s.get("rollbacks") else ""
    print(f"lifecycle: {by_kind or 'no events'}{roll}, "
          f"goodput {s['goodput']:.3f}, final plan {s['final_plan']}")
    if args.ckpt:
        session.save(args.ckpt)
        print(f"final canonical checkpoint -> {args.ckpt}")
    return {"losses": [h["loss"] for h in runner.history],
            "plan": session.plan, "summary": s}


if __name__ == "__main__":
    main()
