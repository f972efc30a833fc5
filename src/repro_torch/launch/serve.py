"""Serving launcher of the port: continuous-batching NTP inference on the
GPU (port of `repro/launch/serve.py`).

Examples:

  # full-size qwen2-7b (f32, random seeded weights) on one H100
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --full

  # full-size mamba2-780m: SSD-head state resharded through fail→repair
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --full

  # smoke scale on the CPU, with the plain versions of the kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 8

  # MoE at smoke scale: arctic-480b (dense residual FFN), llama4-scout
  # (chunked attention with ring caches, the shared expert)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \
      --device cpu --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --device cpu --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --device cpu --requests 8

  # the serving lifecycle: replay a Llama3-calibrated trace with
  # stragglers, degraded links and SDC suspicions (quarantine drains the
  # suspect replica), recording the telemetry stream; fold it with
  # python -m repro_torch.launch.telemetry_report /tmp/s.jsonl
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --trace 2e2 --trace-mix straggler=1,link=1,sdc=1 --telemetry /tmp/s.jsonl

  # gemma2-9b (post-norms, softcaps, sliding/global) at smoke scale
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --device cpu --replicas 2 --requests 16 --trace 2e2

  # recurrentgemma-9b (RG-LRU blocks and sliding-window MQA, admitted token
  # by token) at smoke scale on the CPU, and at full size on the card
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --device cpu --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --full --requests 12 --prompt-len 8 \
      --max-new 8 --max-len 64

whisper-small is served through `ServeSession` with each `Request`'s
``enc_input``; this launcher builds none, so the engine refuses it, as
the reference's launcher does.
"""
import argparse
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b",
                    help="arch config id (served at reduced/smoke scale "
                         "unless --full)")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-size config")
    ap.add_argument("--policy", choices=["drop", "ntp", "ntp_pw"],
                    default="ntp_pw")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--tp", type=int, default=4,
                    help="scale-up domain width (ranks per replica)")
    ap.add_argument("--slots", type=int, default=8,
                    help="cache slots per replica (continuous batching)")
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--arrival-every", type=float, default=1.0,
                    help="mean ticks between request arrivals")
    ap.add_argument("--slo", type=float, default=0.0, metavar="TICKS",
                    help="per-request completion deadline: arrival + SLO "
                         "ticks (0 = no SLO; admission rejects hopeless "
                         "requests up front)")
    ap.add_argument("--trace", type=float, default=None, metavar="RATE_MULT",
                    help="replay a Llama3-calibrated fail/repair trace at "
                         "this failure-rate multiplier (~2e2 suits the tiny "
                         "default cluster: hardware repairs take 72-120 "
                         "ticks, so much hotter rates drown the replica)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--trace-mix", default=None, metavar="KIND=RATE[,...]",
                    help="mix degradation kinds into the sampled trace: "
                         "comma list of straggler=R, link=R, sdc=R onset "
                         "rates as multiples of the binary failure rate "
                         "(e.g. straggler=0.5,sdc=0.1); needs --trace")
    ap.add_argument("--quarantine", choices=["on", "off"], default="on",
                    help="SDC policy (default on): drain the suspect "
                         "replica (in-flight requests finish, no new "
                         "admits) until the clear; off = reprice only")
    ap.add_argument("--ticks-per-hour", type=float, default=1.0,
                    help="serving wall ticks per simulated trace hour")
    ap.add_argument("--max-ticks", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for parity with repro.launch.serve: on "
                         "the GPU the port always packs reshard send buckets "
                         "with its reshard_pack kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--telemetry", default=None, metavar="OUT.jsonl",
                    help="record the run's telemetry stream (admission, "
                         "preemptions, TTFT/TPOT, transition spans) as "
                         "JSONL; fold it offline with python -m "
                         "repro_torch.launch.telemetry_report OUT.jsonl")
    args = ap.parse_args(argv)
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
    if args.quarantine == "off" and args.trace is None:
        ap.error("--quarantine shapes the trace-driven SDC response; it "
                 "needs --trace")
    if args.telemetry:
        from repro_torch import telemetry

        telemetry.configure(jsonl=args.telemetry)
        try:
            return _serve(args)
        finally:
            telemetry.shutdown()
    return _serve(args)


def _serve(args) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.runtime import event_kind, schedule_from_trace
    from repro_torch.serve import Request, Router, ServeSession

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)

    session = ServeSession.create(
        cfg, replicas=args.replicas, n1=args.tp, slots=args.slots,
        max_len=args.max_len, prefill_len=args.prefill_len,
        policy=args.policy, seed=args.seed, device=args.device,
        quarantine=args.quarantine == "on",
    )
    router = Router(session)
    n_par = sum(p.numel() for p in _leaves(session.params))
    print(f"serve: arch={cfg.arch_id} params={n_par/1e6:.1f}M "
          f"replicas={args.replicas}×TP{args.tp} slots={args.slots} "
          f"policy={args.policy} device={session.device}")

    schedule = []
    if args.trace is not None:
        trace_cfg = FailureTraceConfig(
            n_gpus=args.replicas * args.tp, domain_size=args.tp,
            days=args.max_ticks / args.ticks_per_hour / 24.0,
            rate_multiplier=args.trace, seed=args.trace_seed,
            **args.trace_mix_kwargs,
        )
        schedule = schedule_from_trace(
            trace_cfg, steps=args.max_ticks, steps_per_hour=args.ticks_per_hour
        )
        from collections import Counter

        kinds = Counter(event_kind(s.event) for s in schedule)
        print(f"trace: {len(schedule)} events "
              f"({', '.join(f'{k}={n}' for k, n in sorted(kinds.items()))})")

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(
        rng.exponential(args.arrival_every, args.requests)
    ).astype(int)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(1, cfg.vocab_size,
                                size=max(1, args.prompt_len)).astype(np.int32),
            max_new=args.max_new,
            deadline=(float(arrivals[i]) + args.slo) if args.slo else None,
        )
        for i in range(args.requests)
    ]

    t0 = time.time()
    next_req = 0
    tick = 0
    while tick < args.max_ticks:
        while schedule and schedule[0].step <= tick:
            ev = schedule.pop(0).event
            router.apply(ev)
            print(f"*** tick {tick}: {event_kind(ev)} domain {ev.domain} -> "
                  f"tp {session.replica_tp} "
                  f"speeds {[round(e.rel_speed, 3) for e in session.engines]}")
        while next_req < len(reqs) and arrivals[next_req] <= tick:
            router.submit(reqs[next_req])
            next_req += 1
        router.step()
        tick += 1
        if tick % args.log_every == 0:
            g = router.goodput()
            print(f"tick {tick:5d}  done {g['completed']:4d}/{args.requests}"
                  f"  queue {len(router.queue):3d}"
                  f"  tok/tick {g['tokens_per_tick']:.2f}"
                  f"  ({time.time()-t0:.1f}s)", flush=True)
        if (next_req == len(reqs) and not router.queue
                and all(e.n_active == 0 for e in session.engines)):
            break
    if session.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0

    g = router.goodput()
    tokens = sum(e.stats["tokens"] for e in session.engines)
    print(f"served {g['completed']}/{args.requests} requests in {tick} ticks "
          f"({wall:.1f}s wall, {tokens / wall:.1f} tokens/s): goodput "
          f"{g['tokens_per_tick']:.2f} tok/tick, SLO attainment "
          f"{g['slo_attainment']:.3f}, {g['rejected']} rejected, "
          f"{g['preemptions']} preemptions")
    for r, e in enumerate(session.engines):
        print(f"  replica {r}: tp {e.tp} tokens {e.stats['tokens']} "
              f"reshards {e.stats['reshards']} "
              f"({e.stats['reshard_bytes']/1e3:.1f} kB moved)")
    return g


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
