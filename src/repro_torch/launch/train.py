"""Training launcher of the port (port of `repro/launch/train.py`): an
arch config's uniform training (``--arch``, through
`NTPSession.from_arch`), or the NTP prototype through `NTPSession.create`,
with an injected mid-run GPU failure or a replayed failure trace
(``--ntp``: ``_run_ntp`` and ``_run_ntp_trace``).

Examples:

  # on the GPU: train reduced qwen2-7b on the synthetic Markov stream
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --steps 20 --seq-len 128 --batch 8

  # the same on the CPU, 2 steps of 16 tokens, with a checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --device cpu --steps 2 --seq-len 16 --ckpt /tmp/arch.npz

  # sharded: a (2, 2) mesh of 4 processes on gloo (CPU tensors here;
  # --device cuda puts all four on one card); --devices 4 --backend gloo
  # is the reference's spelling of the same mesh
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --device cpu --nproc 4 --mesh 2x2 --backend gloo \\
      --steps 4 --seq-len 16

  # on the GPU: 2 emulated replicas x TP 4, fail one GPU before step 3
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --steps 8 \\
      --fail-at 3 --overlap on

  # the same on the CPU, with the plain versions of the kernels
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --steps 4 --fail-at 2 --seq-len 16

  # two pipeline stages, 2 microbatches: the failure degrades stage 1 only
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --pp 2 --microbatches 2 --steps 4 --fail-at 2 --fail-stage 1 \\
      --seq-len 16 --batch 2

  # ranks as processes: 2 replicas x TP 2 in 4 spawned processes on gloo
  # (CPU tensors here; --device cuda puts all four on one card), or the
  # same under torchrun (RANK / WORLD_SIZE in the environment)
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --nproc 4 --mesh 2x2 --backend gloo --steps 6 --fail-at 3

  # two pipeline stages of (1, 2) processes each (a staged mesh: each
  # process holds its stage's layers, activations handed between stages);
  # the failure degrades stage 1 only
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \
      --nproc 4 --pp 2 --mesh 1x2 --backend gloo --microbatches 2 \
      --steps 4 --fail-at 2 --fail-replica 0 --fail-stage 1 --seq-len 16 \
      --batch 2

  # the same processes through a mixed trace, overlapped sync, NTP-PW,
  # checkpoints and telemetry (rank 0 writes the files)
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --nproc 4 --mesh 2x2 --backend gloo --overlap on --steps 12 \\
      --trace 200 --trace-seed 136 --trace-mix straggler=2,link=2,sdc=1 \\
      --power-policy ntp_pw --ckpt /tmp/ckpt.npz --telemetry /tmp/run.jsonl

  # two pipeline stages with a spare domain: the global allocator lets the
  # spare stand in for the failed GPU of stage 1 (the plan stays pristine)
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --pp 2 --spares 1 --allocator greedy --steps 4 --fail-at 2 \\
      --fail-stage 1 --seq-len 16 --batch 2

  # the same on a staged mesh of 4 processes (each process plans on its
  # replicated ledger; every process reaches the same verdict)
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --nproc 4 --pp 2 --mesh 1x2 --backend gloo --spares 1 \\
      --allocator greedy --steps 4 --fail-at 2 --fail-replica 0 \\
      --fail-stage 1 --seq-len 16 --batch 2

  # replay a mixed failure trace (fail -> boost -> repair, stragglers,
  # degraded links, SDC quarantine and rollback) under NTP-PW, with
  # canonical checkpoints and a telemetry stream
  PYTHONPATH=src python -m repro_torch.launch.train --ntp --device cpu \\
      --steps 12 --trace 200 --trace-seed 136 \\
      --trace-mix straggler=2,link=2,sdc=1 --power-policy ntp_pw \\
      --ckpt /tmp/ckpt.npz --ckpt-every 4 --telemetry /tmp/run.jsonl

The (data, model) mesh is emulated on one device: ``--devices N`` sets the
emulated ranks, as a (2, N/2) mesh; ``--pp`` splits the layers into
pipeline stages, every rank playing each stage in turn. ``--nproc N --mesh
DxN1 --backend {gloo,nccl}`` runs each (replica, rank) as a process of one
process group instead (`launch.spawn`; every other flag as above;
``--mesh``, not ``--devices``, sizes it); with ``--pp P`` it is a staged
mesh of ``N = P * D * N1`` processes, ``--mesh`` sizing each stage. Global
rank 0 prints and writes the telemetry stream, the other ranks record into
memory. ``--allocator greedy`` (``--pp`` > 1) makes every replan the global
repack planner's (`repro_torch.cluster`), which is what lets ``--spares``
work at ``--pp`` > 1; each event prints its verdict.

``--arch`` trains with `make_setup`'s step (AdamW, the warmup-cosine
schedule, f32 weights drawn from ``--seed``; each batch of an enc-dec arch
gets zero frame embeddings as its ``enc_input``, as the reference's
launcher gives it) and writes ``--ckpt`` as {"params", "opt"} in the
port's one-device layout (one entry per layer). On one device by default;
``--nproc N --mesh DxN1 --backend {gloo,nccl}`` (or the reference's
``--devices N``, a (2, N/2) mesh, with ``--backend``) shards it over a
(data, model) mesh of processes (the dense attention archs; every process
draws the same weights from ``--seed`` and keeps its shards; global rank
0 prints and writes the gathered checkpoint). ``--dry-run`` prints
`launch.dryrun.run_one`'s record of ``--arch`` × ``--shape`` at the
production mesh (``--multi-pod``: 2 × 16 × 16), one rank's step counted
on meta tensors, as the reference's prints its compiled record.
"""
import argparse
import time

from repro_torch.configs.shapes import SHAPES


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch config id (required unless --ntp)")
    ap.add_argument("--ntp", action="store_true",
                    help="train the NTP prototype via the runtime session")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant of the arch family")
    ap.add_argument("--dry-run", action="store_true",
                    help="count one step at the production mesh on meta "
                         "tensors (launch.dryrun) and print the record")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES),
                    help="with --dry-run: the input shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --dry-run: the 2 x 16 x 16 mesh")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (stage-partitioned layers, "
                         "per-(replica, stage) health; a failure degrades "
                         "only its stage)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="microbatch chunks per step (must divide --batch; "
                         "1F1B chunks with --ntp, gradient accumulation "
                         "with --arch)")
    ap.add_argument("--overlap", choices=["on", "off"], default="off",
                    help="overlapped, bucketed gradient sync")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a GPU failure before this step")
    ap.add_argument("--fail-replica", type=int, default=1,
                    help="DP replica whose scale-up domain loses a GPU")
    ap.add_argument("--fail-stage", type=int, default=None,
                    help="pipeline stage the failure lands on (--pp > 1; "
                         "default: the replica's worst stage)")
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
    ap.add_argument("--allocator", choices=["greedy", "off"], default="off",
                    help="global repack planner for --pp > 1 "
                         "(repro_torch.cluster): spares assignable to any "
                         "stage, cost-priced cross-stage swaps; 'off' keeps "
                         "stage-local packing")
    ap.add_argument("--spares", type=int, default=0,
                    help="spare scale-up domains absorbing the worst "
                         "failures (--pp > 1 needs --allocator greedy)")
    ap.add_argument("--allocator-horizon", type=int, default=200,
                    help="amortization horizon (steps) a priced move must "
                         "pay for itself within (--allocator greedy)")
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
                    help="emulated ranks of the (2, n/2) mesh (default 8); "
                         "with --arch, N processes of a (2, N/2) mesh "
                         "(needs --backend)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--nproc", type=int, default=0,
                    help="run the ranks (with --arch: the shards of a "
                         "(data, model) mesh) as N processes of one process "
                         "group (spawned, or joined under torchrun)")
    ap.add_argument("--mesh", default=None, metavar="DxN1",
                    help="the (data, model) mesh of each stage of the "
                         "--nproc processes (default 2x(N/pp/2))")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="process-group backend of --nproc (required with "
                         "it): nccl needs one card per process, gloo shares "
                         "one card or runs on the CPU")
    args = ap.parse_args(argv)
    if args.arch is None and not args.ntp:
        ap.error("--arch is required unless --ntp is given")
    if args.ntp and args.dry_run:
        ap.error("--ntp has no --dry-run path")
    if not args.ntp:
        return _run_arch(ap, args)
    if args.trace is not None and args.fail_at is not None:
        ap.error("--trace and --fail-at are mutually exclusive")
    from repro_torch.configs.shapes import SUPPORTED_PP

    if args.pp not in SUPPORTED_PP:
        ap.error(f"--pp {args.pp} not in supported ladder {SUPPORTED_PP}")
    if args.fail_stage is not None and args.pp == 1:
        ap.error("--fail-stage needs --pp > 1")
    if args.allocator != "off" and args.pp == 1:
        ap.error("--allocator is the pp>1 global repack planner; pp=1 "
                 "sessions already pack globally (--spares works directly)")
    if args.spares and args.pp > 1 and args.allocator == "off":
        ap.error("spares with --pp > 1 need the global allocator: pass "
                 "--allocator greedy")
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
    if args.nproc:
        return _run_ranks(ap, args)
    if args.mesh or args.backend:
        ap.error("--mesh and --backend need --nproc")
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
    from repro_torch.runtime import NTPSession, power_policy

    dev = resolve_device(args.device)
    n_dev = args.devices or 8
    if n_dev < 2 or n_dev % 2:
        raise SystemExit(f"--devices {n_dev}: need an even count >= 2")
    if args.fail_at is not None and not 0 <= args.fail_replica < 2:
        raise SystemExit(
            f"--fail-replica {args.fail_replica} out of range for 2 DP replicas"
        )
    n1 = n_dev // 2
    cfg = _model(args, n1)
    policy_name = args.power_policy or ("ntp" if args.trace is not None
                                        else None)
    session = NTPSession.create(
        cfg, (2, n1), local_batch=args.batch, allocator=_allocator(args),
        optimizer=adamw(AdamWConfig(lr=args.lr)),
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        overlap=args.overlap, device=dev,
        power_policy=power_policy(policy_name) if policy_name else None,
        spares=args.spares, quarantine=args.quarantine == "on",
        pp=args.pp, microbatches=args.microbatches,
    )
    n_par = sum(p.numel() for p in tr.leaves(session.canonical_params()))
    print(f"ntp prototype: {n_par/1e6:.1f}M params  mesh data=2 model={n1}  "
          + (f"pp={args.pp} stages {session.stage_boundaries}  "
             if args.pp > 1 else "")
          + f"plan {session.plan}"
          + (f"  overlap {args.overlap}" if args.overlap == "on" else "")
          + (f"  policy {policy_name}" if policy_name else "")
          + _spares_note(args)
          + f"  device {dev}")

    pipe = SyntheticLMPipeline(
        DataConfig(cfg.vocab, args.seq_len, 2 * args.batch, seed=args.seed)
    )
    if args.trace is not None:
        return _run_ntp_trace(args, session, pipe)
    return _train_loop(args, session, pipe, print)


def _run_arch(ap, args) -> dict:
    """``--arch``: uniform training of an arch config through
    `NTPSession.from_arch` on one device. Returns the per-step losses and
    the final params and optimizer state."""
    if args.dry_run:
        from repro_torch.launch.dryrun import run_one

        rec = run_one(args.arch, args.shape, args.multi_pod)
        print(rec)
        return rec
    if args.devices:
        if args.nproc or args.mesh:
            ap.error("--devices N is the reference's spelling of --nproc N "
                     "--mesh 2x(N/2): give one of them")
        if args.devices < 2 or args.devices % 2:
            ap.error(f"--devices {args.devices}: need an even count >= 2")
        if args.backend is None:
            ap.error(f"--devices {args.devices} (sharded arch-stack "
                     f"execution on a (2, {args.devices // 2}) mesh of "
                     f"{args.devices} processes) needs --backend gloo or "
                     "--backend nccl")
        args.nproc, args.mesh = args.devices, f"2x{args.devices // 2}"
    ntp_only = [flag for flag, on in (
        ("--trace", args.trace is not None),
        ("--fail-at", args.fail_at is not None),
        ("--power-policy", args.power_policy), ("--pp", args.pp != 1),
        ("--fail-stage", args.fail_stage is not None),
        ("--overlap", args.overlap == "on"),
        ("--quarantine", args.quarantine == "off"),
        ("--allocator", args.allocator != "off"), ("--spares", args.spares),
        ) if on]
    if ntp_only:
        ap.error(f"{', '.join(ntp_only)} "
                 f"{'needs' if len(ntp_only) == 1 else 'need'} --ntp "
                 "(lifecycle and pipeline training are NTP-backend-only)")
    if args.nproc:
        return _run_arch_ranks(ap, args)
    if args.mesh or args.backend:
        ap.error("--mesh and --backend need --nproc")
    if args.telemetry:
        from repro_torch import telemetry

        telemetry.configure(jsonl=args.telemetry)
        try:
            return _arch_loop(args)
        finally:
            telemetry.shutdown()
    return _arch_loop(args)


def _arch_cfg(args):
    from repro_torch.configs import get_arch, reduced

    cfg = get_arch(args.arch)
    return reduced(cfg) if args.reduced else cfg


def _run_arch_ranks(ap, args) -> dict:
    """``--arch --nproc``: check the flags and the config, then run
    `_arch_rank_main` in every process (spawned, or this one under
    torchrun); returns rank 0's losses (this process's under torchrun)."""
    from repro_torch.launch.spawn import spawn
    from repro_torch.train.steps import check_sharded_arch

    if args.backend is None:
        ap.error("--nproc needs --backend gloo or --backend nccl")
    try:
        d, n1 = (int(x) for x in (args.mesh or f"2x{args.nproc // 2}")
                 .lower().split("x"))
    except ValueError:
        ap.error(f"--mesh {args.mesh}: expected DxN1, e.g. 2x2")
    if d < 1 or n1 < 1 or d * n1 != args.nproc:
        ap.error(f"--mesh {d}x{n1} is not --nproc {args.nproc} processes")
    if args.batch % (d * args.microbatches):
        ap.error(f"--batch {args.batch} does not split over data={d} in "
                 f"{args.microbatches} microbatches")
    try:
        check_sharded_arch(_arch_cfg(args))
    except NotImplementedError as e:
        ap.error(f"--arch {args.arch} on a mesh: {e}")
    args.mesh_shape = (d, n1)
    device = args.device or "cuda"
    out = spawn(_arch_rank_main, args.nproc, backend=args.backend,
                device=device, deadline_s=RANKS_DEADLINE_S,
                args=(args, device))
    return out[0]


def _arch_rank_main(args, device) -> dict:
    """One (replica, rank) process of ``--arch --nproc``: global rank 0
    prints and writes the telemetry stream and the checkpoint."""
    from repro_torch import telemetry
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(*args.mesh_shape, backend=args.backend,
                          device=device)
    rank0 = mesh.global_rank == 0
    if args.telemetry:
        if rank0:
            telemetry.configure(jsonl=args.telemetry)
        else:
            telemetry.configure(memory=True)
    try:
        out = _arch_loop(args, mesh,
                         print if rank0 else (lambda *a, **k: None))
    finally:
        if args.telemetry:
            telemetry.shutdown()
    return {"losses": out["losses"]}


def _arch_loop(args, mesh=None, log=print) -> dict:
    import torch

    from repro_torch import tree as tr
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels.mode import resolve_device
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import NTPSession
    from repro_torch.sharding.specs import gather

    dev = resolve_device(args.device) if mesh is None else mesh.device
    cfg = _arch_cfg(args)
    session = NTPSession.from_arch(
        cfg, ShapeSpec("cli", args.seq_len, args.batch, "train"), mesh,
        opt_cfg=AdamWConfig(lr=args.lr), device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        microbatches=args.microbatches,
    )
    su = session.setup
    if mesh is None:
        n_par = sum(p.numel() for p in tr.leaves(session.params))
        log(f"arch={cfg.arch_id} params={n_par/1e6:.1f}M device={dev}")
    else:
        n_par = sum(p.numel() for p in tr.leaves(su.model.param_shapes()))
        log(f"arch={cfg.arch_id} params={n_par/1e6:.1f}M devices="
            f"{args.nproc} (mesh data={mesh.n_data} model={mesh.n_model}, "
            f"{mesh.backend}) device={dev}")

    pipe = SyntheticLMPipeline(
        DataConfig(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed),
        device=dev)

    def save(step):
        tree = {"params": session.params, "opt": session.opt_state}
        if mesh is not None:     # every process gathers; rank 0 writes
            opt = session.opt_state
            tree = {"params": gather(session.params, su.param_specs, mesh),
                    "opt": dict({k: gather(opt[k], su.opt_specs[k], mesh)
                                 for k in opt if k != "step"},
                                step=opt["step"])}
            if mesh.global_rank:
                return
        save_checkpoint(args.ckpt, tree, step=step)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = pipe.batch(i)
        if cfg.encoder is not None:
            batch["enc_input"] = torch.zeros(
                (args.batch, cfg.encoder.enc_seq, cfg.d_model), device=dev)
        metrics = session.step(batch)
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            log(f"step {i:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
            log(f"  saved checkpoint -> {args.ckpt}")
    if args.ckpt:
        save(args.steps)
        log(f"final checkpoint -> {args.ckpt}")
    return {"losses": losses, "params": session.params,
            "opt": session.opt_state}


def _train_loop(args, session, pipe, log) -> dict:
    """Steps with the optional injected failure, log lines through
    ``log``, checkpoints; returns the per-step losses and the final plan."""
    from repro_torch.runtime import FailureEvent

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        if args.fail_at is not None and i == args.fail_at:
            plan = session.apply(
                FailureEvent(step=i, replica=args.fail_replica,
                             n_gpus=args.fail_gpus, stage=args.fail_stage)
            )
            stage_s = (f"stage={args.fail_stage}, "
                       if args.fail_stage is not None else "")
            log(f"*** step {i}: FailureEvent(replica={args.fail_replica}, "
                f"{stage_s}n_gpus={args.fail_gpus}) "
                f"-> plan {plan} mode {session.mode.value}")
            _log_verdict(session, log)
        metrics = session.step(pipe._batch_np(i))
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            srel = metrics.get("stage_rel_iter_time")
            log(
                f"step {i:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                + (f"stage_rel {tuple(round(r, 3) for r in srel)}  "
                   if srel is not None else "")
                + f"({(time.time()-t0):.1f}s)", flush=True,
            )
        if args.ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            session.save(args.ckpt)
            log(f"  saved canonical checkpoint -> {args.ckpt}")
    if args.ckpt:
        session.save(args.ckpt)
        log(f"final canonical checkpoint -> {args.ckpt}")
    return {"losses": losses, "plan": session.plan}


def _allocator(args):
    """``--allocator``: a fresh `GreedyAllocator` with ``--allocator-horizon``,
    or None."""
    from repro_torch.cluster import make_allocator

    return make_allocator(args.allocator, horizon_steps=args.allocator_horizon)


def _spares_note(args) -> str:
    if args.allocator != "off" or args.spares:
        return f"  allocator {args.allocator} spares {args.spares}"
    return ""


def _log_verdict(session, log) -> None:
    """One line of the allocator's verdict on the latest event (none
    without an allocator)."""
    gp = session.last_global_plan
    if gp is None:
        return
    s = gp.summary()
    log(f"    allocator: spares at {gp.spare_sites} swaps {gp.swaps} "
        f"stage_tp {s['stage_tp']} predicted {gp.predicted_bytes} B "
        f"(goodput {gp.goodput:.3f} vs stage-local "
        f"{gp.baseline_goodput:.3f})")


def _model(args, n1: int):
    from repro_torch.runtime import NTPModelConfig

    return NTPModelConfig(
        d_model=256, n_kv_groups=2 * n1, q_per_kv=2, head_dim=32,
        d_ff=max(512, 128 * n1), unit_rows=128,
        n_layers=max(2, 2 * args.pp), vocab=2048,
    )


# a run of the ranks as processes is killed after this long
RANKS_DEADLINE_S = 3600.0


def _run_ranks(ap, args) -> dict:
    """``--nproc``: check the flags, then run `_rank_main` in every process
    (spawned, or this one under torchrun); returns rank 0's result (this
    process's own under torchrun)."""
    from repro_torch.launch.spawn import spawn

    if args.backend is None:
        ap.error("--nproc needs --backend gloo or --backend nccl")
    per_stage = args.nproc // args.pp
    try:
        d, n1 = (int(x) for x in (args.mesh or f"2x{per_stage // 2}")
                 .lower().split("x"))
    except ValueError:
        ap.error(f"--mesh {args.mesh}: expected DxN1, e.g. 2x2")
    if d < 1 or n1 < 1 or args.pp * d * n1 != args.nproc:
        ap.error(f"--mesh {d}x{n1} with --pp {args.pp} is not --nproc "
                 f"{args.nproc} processes (--mesh sizes each stage: "
                 f"--nproc / pp = {args.nproc / args.pp:g} a stage)")
    if args.fail_at is not None and not 0 <= args.fail_replica < d:
        ap.error(f"--fail-replica {args.fail_replica} out of range for {d} "
                 "replicas")
    if args.devices:
        ap.error("--devices sizes the emulated mesh; --mesh DxN1 sizes a "
                 "--nproc run")
    args.mesh_shape = (d, n1)
    device = args.device or "cuda"
    out = spawn(_rank_main, args.nproc, backend=args.backend, device=device,
                deadline_s=RANKS_DEADLINE_S, args=(args, device))
    return out[0]


def _rank_main(args, device) -> dict:
    """One (replica, rank) process of ``--nproc`` (one (stage, replica,
    rank) with ``--pp`` > 1): the mesh, the session and the steps (or the
    trace); global rank 0 prints and writes the telemetry stream, the
    other ranks record into memory."""
    import torch

    from repro_torch import telemetry
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.launch.mesh import make_staged_mesh, make_test_mesh
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.runtime import NTPSession, power_policy

    d, n1 = args.mesh_shape
    if args.pp > 1:
        mesh = make_staged_mesh(args.pp, d, n1, backend=args.backend,
                                device=device)
    else:
        mesh = make_test_mesh(d, n1, backend=args.backend, device=device)
    rank0 = mesh.global_rank == 0
    log = print if rank0 else (lambda *a, **k: None)
    if args.telemetry:
        if rank0:
            telemetry.configure(jsonl=args.telemetry)
        else:
            telemetry.configure(memory=True)
    try:
        policy_name = args.power_policy or ("ntp" if args.trace is not None
                                            else None)
        session = NTPSession.create(
            _model(args, n1), mesh, local_batch=args.batch,
            optimizer=adamw(AdamWConfig(lr=args.lr)),
            generator=torch.Generator(
                device=mesh.device).manual_seed(args.seed),
            overlap=args.overlap,
            power_policy=power_policy(policy_name) if policy_name else None,
            spares=args.spares, quarantine=args.quarantine == "on",
            pp=args.pp, microbatches=args.microbatches,
            allocator=_allocator(args),
        )
        log(f"ntp prototype: processes {args.nproc} (mesh "
            + (f"stage={args.pp} " if args.pp > 1 else "")
            + f"data={d} model={n1}, {args.backend})  "
            + (f"pp={args.pp} stages {session.stage_boundaries}  "
               if args.pp > 1 else "")
            + f"plan {session.plan}"
            + (f"  overlap {args.overlap}" if args.overlap == "on" else "")
            + (f"  policy {policy_name}" if policy_name else "")
            + _spares_note(args)
            + f"  device {mesh.device}", flush=True)
        pipe = SyntheticLMPipeline(
            DataConfig(session.cfg.vocab, args.seq_len, d * args.batch,
                       seed=args.seed))
        if args.trace is not None:
            return _run_ntp_trace(args, session, pipe, log)
        return _train_loop(args, session, pipe, log)
    finally:
        if args.telemetry:
            telemetry.shutdown()


def _run_ntp_trace(args, session, pipe, log=print) -> dict:
    """Replay a sampled failure/recovery trace against the live session via
    the lifecycle orchestrator, printing through ``log``. The runner goes in
    chunks that end at every log step and every checkpoint step."""
    from collections import Counter

    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.runtime import TraceRunner, event_kind, schedule_from_trace

    d, n1, pp = session.plan.d, session.plan.n1, session.pp
    trace_cfg = FailureTraceConfig(
        n_gpus=d * pp * n1, domain_size=n1,
        days=args.steps / args.steps_per_hour / 24.0,
        rate_multiplier=args.trace, seed=args.trace_seed,
        **args.trace_mix_kwargs,
    )
    schedule = schedule_from_trace(
        trace_cfg, steps=args.steps, steps_per_hour=args.steps_per_hour,
        pp=pp,
    )
    kinds = Counter(event_kind(s.event) for s in schedule)
    log(f"trace: {len(schedule)} events over {args.steps} steps "
          f"({', '.join(f'{k}={n}' for k, n in sorted(kinds.items()))})")

    t0 = time.time()

    def on_event(ev, plan):
        site = (f"stage {ev.stage} domain {ev.domain}"
                if ev.stage is not None else f"domain {ev.domain}")
        log(f"*** step {ev.step}: {event_kind(ev)} {site} -> "
              f"plan {plan}  local_batches {session.local_batches}")
        _log_verdict(session, log)

    runner = TraceRunner(session, schedule, on_event=on_event)
    log_every = max(args.log_every, 1)
    ckpt_every = args.ckpt_every if args.ckpt else 0
    marks = set(range(log_every, args.steps, log_every)) | {args.steps}
    if ckpt_every:
        marks |= set(range(ckpt_every, args.steps, ckpt_every))
    marks = sorted(marks)
    done = 0
    for stop in marks:
        hist = runner.run(lambda i: pipe._batch_np(i), stop - done)
        done = stop
        if stop % log_every == 0 or stop == args.steps:
            h = hist[-1]
            extra = (f"  boost {h['power_boost']:.2f}  rel_iter "
                     f"{h['rel_iter_time']:.3f}" if "power_boost" in h else "")
            log(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}  tp {h['replica_tp']}{extra}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if ckpt_every and stop % ckpt_every == 0 and stop < args.steps:
            session.save(args.ckpt)
            log(f"  saved canonical checkpoint -> {args.ckpt}")
    s = runner.summary()
    by_kind = ", ".join(f"{k}={v}" for k, v in sorted(
        s["events_by_kind"].items()))
    roll = f", rollbacks {s['rollbacks']}" if s.get("rollbacks") else ""
    log(f"lifecycle: {by_kind or 'no events'}{roll}, "
          f"goodput {s['goodput']:.3f}, final plan {s['final_plan']}")
    if args.ckpt:
        session.save(args.ckpt)
        log(f"final canonical checkpoint -> {args.ckpt}")
    return {"losses": [h["loss"] for h in runner.history],
            "plan": session.plan, "summary": s}


if __name__ == "__main__":
    main()
