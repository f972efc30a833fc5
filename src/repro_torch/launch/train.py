"""Training launcher of the port: the NTP prototype through `NTPSession`,
with an injected mid-run GPU failure (port of the ``--ntp`` path of
`repro/launch/train.py`, ``_run_ntp``).

Examples:

  # on the GPU: 2 emulated replicas x TP 4, fail one GPU before step 3
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --steps 8 \\
      --fail-at 3 --overlap on

  # the same on the CPU, with the plain versions of the kernels
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --steps 4 --fail-at 2 --seq-len 16

The (data, model) mesh is emulated on one device: ``--devices N`` sets the
emulated ranks, as a (2, N/2) mesh. The uniform arch-stack launcher
(``--arch``), pipeline stages, trace replay, power policies, spares and the
allocator, checkpoints and telemetry wait for their slices (ROADMAP).
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
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--devices", type=int, default=0,
                    help="emulated ranks of the (2, n/2) mesh (default 8)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    args = ap.parse_args(argv)
    if not args.ntp:
        ap.error("only --ntp is ported: the uniform arch-stack launcher "
                 "(--arch) waits for its slice (ROADMAP Queue 1, 'uniform "
                 "arch launcher')")
    return _run_ntp(args)


def _run_ntp(args) -> dict:
    """NTP prototype through the runtime session, with an optional injected
    mid-training failure (--fail-at). Returns the per-step losses and the
    final plan."""
    import torch

    from repro_torch import tree as tr
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels.mode import resolve_device
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.runtime import FailureEvent, NTPModelConfig, NTPSession

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
    session = NTPSession.create(
        cfg, (2, n1), local_batch=args.batch,
        optimizer=adamw(AdamWConfig(lr=args.lr)),
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        overlap=args.overlap, device=dev,
    )
    n_par = sum(p.numel() for p in tr.leaves(session.canonical_params()))
    print(f"ntp prototype: {n_par/1e6:.1f}M params  mesh data=2 model={n1}  "
          f"plan {session.plan}"
          + (f"  overlap {args.overlap}" if args.overlap == "on" else "")
          + f"  device {dev}")

    pipe = SyntheticLMPipeline(
        DataConfig(cfg.vocab, args.seq_len, 2 * args.batch, seed=args.seed)
    )
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
    return {"losses": losses, "plan": session.plan}


if __name__ == "__main__":
    main()
