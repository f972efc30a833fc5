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

Trace replay (``--trace``, ``--trace-mix`` and the flags that shape it),
telemetry and the Pallas compile switch wait for their slices.
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
    ap.add_argument("--max-ticks", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for parity with repro.launch.serve: on "
                         "the GPU the port always packs reshard send buckets "
                         "with its reshard_pack kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.serve import Request, Router, ServeSession

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)

    session = ServeSession.create(
        cfg, replicas=args.replicas, n1=args.tp, slots=args.slots,
        max_len=args.max_len, prefill_len=args.prefill_len,
        policy=args.policy, seed=args.seed, device=args.device,
    )
    router = Router(session)
    n_par = sum(p.numel() for p in _leaves(session.params))
    print(f"serve: arch={cfg.arch_id} params={n_par/1e6:.1f}M "
          f"replicas={args.replicas}×TP{args.tp} slots={args.slots} "
          f"policy={args.policy} device={session.device}")

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
