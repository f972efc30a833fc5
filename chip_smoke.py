#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
1. print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`
   (one nvcc per source, in parallel) and print the build time;
3. time the host's cost of each step of one rmsnorm wrapper call, on the
   previous release's launch path and on this one, and of the whole call
   with telemetry off and with a Recorder active (the `kernels.dispatch`
   counter, in turns); hold each kernel
   against its plain PyTorch version on the card, in f32 and bf16, at the
   serving paths' shapes (qwen2-7b's and mamba2-780m's norm rows, KV-head
   and SSD-head reshard rows), the training path's gradient-bucket shapes
   and largest reshard (one layer's MLP bucket), and, for ssd_scan (f32,
   5e-4), the reference's test shapes, a ragged shape (hp 6, ds 12), d_state
   256 at chunk 256 and the Mamba-2 prefill shape (4 x 48 heads, S=2048,
   hp 64, ds 128, chunk 256; the final state also against the model's plain
   `_ssd_chunked`; the four CUDA kernels a call issues, each with its device
   ms); time kernel, plain version, one library call where one exists and
   the least time the card could take (bound; for ssd_scan C·Bᵀ counted
   once per B/C row). The bucket rows open with the host µs of one
   bucket_pack / bucket_unpack call (`python3 chip_smoke.py
   --bucket-host-cost-against DIR` times it beside the wrappers of the
   checkout at DIR, in turns, and exits). rmsnorm, flash_attention,
   reshard_pack, bucket_pack and bucket_unpack are timed in turns with their library calls (F.rms_norm;
   F.scaled_dot_product_attention; src[idx] and index_select; torch.cat;
   split + .contiguous()), 5 rounds, medians: the call ms (back-to-back
   wrapper calls) and the device ms (the same calls in a CUDA graph,
   replayed); ssd_scan's device ms comes from a CUDA graph too.
   flash_attention is timed at the serving prefill (q (1,28,32,128), kv 4,
   causal) and at S=4096 causal and sliding 1024, f32 and bf16, then held
   at a ragged S=100 for every head_dim (32, 64, 128, 256) x mask kind,
   and with a softcap (sliding, 50) for every head_dim, in f32 and bf16;
4. serve full-size qwen2-7b (f32, weights drawn from a seeded generator on
   the card) through `ServeSession` + `Router` with replicas=1, n1=4,
   slots=8, max_len=96, prefill_len=32: 24 requests (prompt 24, max_new
   16) through fail, fail, repair, repair mid-decode (TP 4→3→2→3→4, with
   preemptions). Every token stream must equal an uninterrupted session's
   on the same weights; every kernel must have launched on this path; a
   two-layer full-width model must agree with the plain versions on the
   CPU on a small input; a decode tick is timed (CUDA events) and profiled
   (torch.profiler: device time per kernel, idle share); the served model
   is then freed;
5. full-size mamba2-780m (48 layers, f32, seeded weights on the card): a
   two-layer full-width model against the CPU's plain versions on a
   512-token prompt (5e-4, the reference's tolerance between the chunked
   and the sequential scan); a batched prefill of 4 x 2048 tokens through
   `Model.prefill` (48 counted ssd_scan launches) and 32 greedy decode
   steps; the prefill's last logits and h cache against the same prompts
   fed token by token through the recurrent path (each within 1e-3 of its
   largest magnitude); layer 0's scan on the prefill's inputs, the kernel
   and the reference's plain `_ssd_chunked` each against the sequential
   recurrence, as the yardstick of the chunked form's f32 error; prefill
   and decode timed and profiled, peak memory; then the same serving run
   as phase 4 (24 of 24
   token streams identical through TP 4→3→2→3→4, reshard_pack launched on
   the ssm_head reshards, bytes equal to moved heads x head bytes), and
   the launcher twin `repro_torch.launch.serve_decode --arch mamba2-780m
   --full --batch 4 --prompt-len 2048 --new 32`;
6. train the NTP prototype at qwen2-7b's widths (d_model 3584, 4 kv-groups
   of 7 query heads, head_dim 128, d_ff 18944, vocab 152064; depth cut to
   4 layers) on 2 emulated DP replicas x TP 4, local batch 4, sequence 256,
   SGD: steps 0-2 healthy (UNIFORM), a FailureEvent before step 3 (TP
   (3, 4), NTP), a RecoveryEvent before step 6 (healthy), 9 steps. Two
   sessions, overlap on and off, run in lockstep with a dense one-copy
   reference on the card: every step's loss within 1e-4 of the reference
   and 1e-5 between the sessions, both replicas' canonical params within
   1e-4 of the reference at the end (1e-4 between the sessions), the
   transition ledger equal to `expected_transfer`, and bucket_pack,
   bucket_unpack and reshard_pack launched on this path. Step times (CUDA
   events), transition time and bytes, peak memory, and a torch.profiler
   view of one degraded step of each session, with the reshard_pack
   calls it made by shape, are printed;
7. replay a mixed failure trace against the same model (one session, TP 4
   x 2 replicas, overlap on, `power_policy("ntp_pw")`, quarantine on):
   `schedule_from_trace` over 16 steps (a failure and its repair, a link
   degrade and its repair, an SDC suspicion that rolls back to the step-0
   snapshot, a straggler and its clear; `TRACE`, pinned by
   tests/test_torch_lifecycle.py) through `TraceRunner(verify=True,
   atol=1e-4)` with the dense reference on the card: every step's loss and
   the canonical params at every transition, the rollback and the end
   within 1e-4; every transition's ledger equal to `expected_transfer` and
   to its `session.transition` span; per-step plans, local batches and
   `PowerDecision`s equal to the same schedule run through the port on the
   CPU; reshard_pack, bucket_pack and bucket_unpack launched; at step 8 a
   canonical checkpoint (about 7 GB, under `build/`) saved and restored
   into a fresh session under the live plan, bit-identical. Printed: step
   ms per regime (healthy, degraded at TP (3, 4), repriced, quarantined),
   each event's apply ms and bytes, snapshot and rollback ms, the
   snapshot's host bytes, the goodput gauges, `TraceRunner.summary()`,
   peak memory; then the schedule again with verify off, timed, with the
   host syncs outside the transitions (at most one per `drain_every`
   steps, the metrics drain);
8. run the training launcher at its defaults on the card: `--ntp --steps 8
   --fail-at 3 --overlap on`, then phase 7's trace with `--power-policy
   ntp_pw --ckpt ... --ckpt-every 4 --telemetry ... --steps 12`: the
   checkpoint loads and every telemetry event is on the schema;
9. print the kernels table as one JSON line (launches summed over the
   serving, Mamba-2, training and trace paths, each counted from zero just
   before it), then the device line.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
PEAK = {"float32": 67e12, "bfloat16": 989e12}   # FLOP/s: f32 CUDA cores, bf16 dense tensor cores
TOL = {"float32": 3e-5, "bfloat16": 2e-2}        # tests/test_kernels.py::_tol


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back launches
    (CUDA events, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, dtype_name):
    t_bytes = n_bytes / MEM_BW
    t_ops = n_ops / PEAK[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, F, dev):
    """Phase 3. Returns {name: table row at the main path's shape}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    g = torch.Generator(device=dev).manual_seed(1234)
    rows = {}

    def report(name, shape, dt, err, ms, plain, lib, bound, tol=None):
        tol = TOL[dt] if tol is None else tol
        print(f"  {name:16s} {shape:34s} {dt:8s} max_abs_err {err:.3e} "
              f"(tol {tol:g})  kernel_ms {ms:.5f}  plain_ms {plain:.5f}  "
              f"library_ms {'null' if lib is None else f'{lib:.5f}'}  "
              f"bound_ms {bound[0]:.6f} ({bound[1]})", flush=True)
        check(err <= tol, f"{name} {shape} {dt}: max_abs_err {err} > {tol}")

    host_cost(torch, dev, g)

    # ---- rmsnorm: qwen2-7b's decode (8) and prefill (32) rows at d=3584
    # with 1+w; Mamba-2's gated norm (d_inner 3072, w) and its ln1 /
    # final_norm (d_model 1536, 1+w) at the rows of a token-by-token
    # admission step (1), a decode tick (8) and the 4 x 2048 prefill (8192)
    cases = [(n, 3584, True) for n in (8, 32)] + [
        (n, d, p1) for d, p1 in ((3072, False), (1536, True))
        for n in (1, 8, 8192)]
    for n, d, plus_one in cases:
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            x = torch.randn((n, d), generator=g, device=dev).to(dt)
            w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dt)
            got = rmsnorm(x, w, plus_one=plus_one)
            torch.cuda.synchronize()
            want = ref.rmsnorm_ref(x, w, plus_one=plus_one)
            err = (got.float() - want.float()).abs().max().item()
            plain = time_ms(lambda: ref.rmsnorm_ref(x, w, plus_one=plus_one),
                            200)
            w1 = 1.0 + w if plus_one else w
            t = in_turns(torch, lambda: rmsnorm(x, w, plus_one=plus_one),
                         {"F.rms_norm": lambda: F.rms_norm(x, (d,), w1, 1e-6)},
                         reps=200, calls=20)
            b = bound_ms((2 * n * d + d) * x.element_size(), 4 * n * d, dn)
            report_turns("rmsnorm", f"x({n},{d}) {'1+w' if plus_one else 'w'}",
                         dn, err, TOL[dn], t, plain, b)
            if (n, d) == (8, 3584) and dt == torch.float32:
                rows["rmsnorm"] = table_row(err, t, plain, b)

    flash_rows(torch, F, dev, g, rows)
    torch.cuda.empty_cache()

    reshard_rows(torch, dev, g, rows)
    bucket_rows(torch, dev, g, rows)
    ssd_rows(torch, dev, g, rows, report)
    return rows


def flash_rows(torch, F, dev, g, rows):
    """flash_attention at qwen2-7b's heads (q (1,28,S,128), k/v (1,4,S,128)):
    the serving path's prefill (S=32, causal) and a long prompt (S=4096,
    causal and sliding 1024), f32 and bf16, timed in turns with
    `F.scaled_dot_product_attention` (GQA by `enable_gqa`; the sliding mask
    passed as a boolean mask); then correctness-only rows at a ragged S=100
    for every head_dim x mask kind (window 40, chunk 48), and a
    gemma2-style softcap row (sliding, softcap 50) for every head_dim, each
    in f32 and bf16 against the plain version at the reference's
    tolerances."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    for s, kind, window in ((32, "causal", 4096), (4096, "causal", 4096),
                            (4096, "sliding", 1024)):
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            b_, h, kvh, d = 1, 28, 4, 128
            q = torch.randn((b_, h, s, d), generator=g, device=dev).to(dt)
            k = torch.randn((b_, kvh, s, d), generator=g, device=dev).to(dt)
            v = torch.randn((b_, kvh, s, d), generator=g, device=dev).to(dt)
            kw = dict(kind=kind, window=window)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            del want, got
            short = s <= 32
            plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                            10 if short else 1)
            qp = torch.arange(s, device=dev)
            mask = qp[None, :] <= qp[:, None]
            if kind == "sliding":
                mask &= qp[None, :] > qp[:, None] - window
            attn_mask = None if kind == "causal" else mask
            t = in_turns(torch, lambda: flash_attention(q, k, v, **kw),
                         {"SDPA": lambda: F.scaled_dot_product_attention(
                             q, k, v, attn_mask=attn_mask,
                             is_causal=kind == "causal", enable_gqa=True)},
                         reps=50 if short else 5, calls=20 if short else 3)
            pairs = int(mask.sum().item())
            n_bytes = (2 * b_ * h * s * d + 2 * b_ * kvh * s * d) * q.element_size()
            bd = bound_ms(n_bytes, 4 * d * pairs * b_ * h, dn)
            report_turns("flash_attention",
                         f"q({b_},{h},{s},{d}) kv{kvh} {kind}", dn, err,
                         TOL[dn], t, plain, bd)
            if s == 32 and dt == torch.float32:
                rows["flash_attention"] = table_row(err, t, plain, bd)
            del q, k, v, mask, attn_mask
            torch.cuda.empty_cache()

    s, window, chunk = 100, 40, 48
    cases = [(d, kind, None) for d in (32, 64, 128, 256)
             for kind in ("causal", "sliding", "chunked", "bidir")]
    cases += [(d, "sliding", 50.0) for d in (32, 64, 128, 256)]
    for d, kind, cap in cases:
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            h, kvh = (28, 4) if d == 128 else (8, 2)
            sc = 4.0 if cap else 1.0
            q = (torch.randn((2, h, s, d), generator=g, device=dev) * sc).to(dt)
            k = (torch.randn((2, kvh, s, d), generator=g, device=dev) * sc).to(dt)
            v = torch.randn((2, kvh, s, d), generator=g, device=dev).to(dt)
            kw = dict(kind=kind, window=window, chunk=chunk, softcap=cap)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.flash_attention_ref(q, k, v, **kw)
                   .float()).abs().max().item()
            print(f"  flash_attention  q(2,{h},{s},{d}) kv{kvh} {kind:8s} "
                  f"softcap {cap}  {dn:8s} max_abs_err {err:.3e} "
                  f"(tol {TOL[dn]:g})", flush=True)
            check(err <= TOL[dn], f"flash_attention d={d} {kind} softcap "
                  f"{cap} {dn}: max_abs_err {err} > {TOL[dn]}")


def reshard_rows(torch, dev, g, rows):
    """reshard_pack at the TP 4->3 transition with full-size unit rows:
    qwen2-7b's KV-head reshard (one unit row = 2·L·slots·T·hd elems),
    mamba2-780m's ssm_head reshard of h and conv, fused (one unit row = one
    SSD head's L·slots·hp·ds h and hp·L·slots·(K-1) conv elems), and the
    training path's largest call: the degraded replica's pre-sync reshard
    of one layer's MLP gradient bucket (A and B, 2 x 3584·128 elems per
    unit) under the (3, 4) plan, 4 ranks x 51 unit rows. Each runs as the
    main path runs it, one launch over every rank of the replica
    (`reshard_pack_ranks`), and the two serving ones also as the one-rank
    call from the rank that sends the most rows. Bit-exact against the
    plain version; timed in turns against advanced indexing (`src[idx]`,
    the plain version's own call, with the index already int64) and
    `index_select` (flat indices precomputed)."""
    from repro_torch.core import nonuniform as nu
    from repro_torch.core import shard_mapping as sm
    from repro_torch.kernels import ref
    from repro_torch.kernels.reshard_pack import reshard_pack, reshard_pack_ranks
    from repro_torch.reshard import planner

    nh = 48
    ssm_plan = planner.transition_plan(planner.sync_key(nh, 4, 4),
                                       planner.sync_key(nh, 4, 3), nh, nh)
    train = nu.weight_plan(18944 // 128, nu.FailurePlan(4, (3, 4))).pre.replica(1)
    cases = [("kv_head", sm.reshard_tables(sm.sync_layout(4, 4, 4),
                                           sm.sync_layout(4, 4, 3), 4),
              2 * 28 * 8 * 96 * 128, (torch.float32, torch.bfloat16), True),
             ("ssm_head", ssm_plan.tables,
              48 * 8 * 64 * 128 + 64 * 48 * 8 * 3, (torch.float32,), True),
             ("train MLP bucket", train, 2 * 3584 * 128, (torch.float32,),
              False)]
    for label, tables, elems, dtypes, one_rank in cases:
        n, up1 = tables.n, tables.buf + 1
        send = tables.send_idx
        rank = max(range(n), key=lambda r: int((send[r] != tables.pad).sum()))
        for dt in dtypes:
            dn = str(dt).split(".")[1]
            xp = torch.randn((n, up1, elems), generator=g, device=dev).to(dt)
            xp[:, -1] = 0
            idx = torch.as_tensor(send, device=dev)
            row_bytes = elems * xp.element_size()
            calls = [(f"{label} all {n} ranks", xp, idx, reshard_pack_ranks,
                      ref.reshard_pack_ranks_ref, range(n))]
            if one_rank:
                calls.append((f"{label} rank {rank}", xp[rank], idx[rank],
                              reshard_pack, ref.reshard_pack_ref, [rank]))
            for name, src, ix, kern, plain_fn, ranks in calls:
                got = kern(src, ix)
                torch.cuda.synchronize()
                want = plain_fn(src, ix)
                check(torch.equal(got, want),
                      f"reshard_pack {name} {dn} is not bit-exact")
                del got, want
                plain = time_ms(lambda: plain_fn(src, ix), 10)
                lidx = ix.long()
                if src.ndim == 3:
                    rk = torch.arange(n, device=dev)[:, None, None]
                    flat = (lidx + rk * up1).flatten()
                    index = lambda: src[rk, lidx]            # noqa: E731
                    select = lambda: torch.index_select(     # noqa: E731
                        src.view(-1, elems), 0, flat).view(*ix.shape, elems)
                else:
                    flat = lidx.flatten()
                    index = lambda: src[lidx]                # noqa: E731
                    select = lambda: torch.index_select(     # noqa: E731
                        src, 0, flat).view(*ix.shape, elems)
                t = in_turns(torch, lambda: kern(src, ix),
                             {"src[idx]": index, "index_select": select},
                             reps=10, calls=4)
                n_read = sum(len({int(u) for u in send[r].flatten()
                                  if u != tables.pad}) for r in ranks)
                bd = bound_ms((n_read + ix.numel()) * row_bytes
                              + ix.numel() * 4, 0, dn)
                report_turns("reshard_pack",
                             f"{name} src{tuple(src.shape)} idx{tuple(ix.shape)}",
                             dn, 0.0, 0.0, t, plain, bd)
                if label == "kv_head" and src.ndim == 3 and dt == torch.float32:
                    rows["reshard_pack"] = table_row(0.0, t, plain, bd)
                torch.cuda.empty_cache()
            del xp, idx, calls, src, ix
            torch.cuda.empty_cache()


def host_cost(torch, dev, g):
    """Host microseconds of each step of one `rmsnorm` wrapper call at the
    qwen2-7b decode shape (x (8, 3584) f32, 1+w), on the launch path of the
    previous release (`old`: a set of devices per call, `torch.cuda.device`
    entered and left, a `torch.cuda.Stream` built for its handle, the
    launch arguments converted per call, the library called through
    `ctypes.CDLL`, which releases and retakes the GIL) and on this one
    (`new`: integer device indices, the device entered only when it is not
    current, the raw stream handle, the fixed arguments passed by the
    address of a cached struct, `ctypes.PyDLL`). Both launch the same
    kernel through the same 6-argument C function (the old one took 9
    arguments). Each step runs 1000 times back to back on the host clock,
    less the cost of an empty call; medians of 5."""
    import ctypes

    from repro_torch.kernels import build, mode
    from repro_torch.kernels import rmsnorm as rm

    x = torch.randn((8, 3584), generator=g, device=dev)
    w = torch.randn((3584,), generator=g, device=dev) * 0.1
    y = torch.empty_like(x)
    idx = x.get_device()
    new_fn = build.function("rmsnorm", "rmsnorm_launch", rm._ARGS)
    old_fn = ctypes.CDLL(str(build._lib_path("rmsnorm"))).rmsnorm_launch
    old_fn.argtypes, old_fn.restype = rm._ARGS, ctypes.c_int
    key = (x.dtype, w.dtype, 3584, True, 1e-6, True)
    params = rm._addresses.get(key) or rm._params_address(key)
    old_params = rm.Params(3584, 1e-6, 1, 0, *rm.launch_config(3584, 4, True))
    stream = torch._C._cuda_getCurrentRawStream(idx)
    xp, wp, yp = x.data_ptr(), w.data_ptr(), y.data_ptr()

    def old_on_cpu(*tensors):
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError("several devices")
        return devices.pop().type == "cpu"

    def old_check(err):
        if err != 0:
            raise RuntimeError(err)

    def new_check():
        err = 0
        if err:
            build.fail(err, "rmsnorm")

    def old_count():
        # the counter before the kernels.dispatch check was added
        mode._launches["rmsnorm"] += 1

    def old_context():
        with torch.cuda.device(x.device):
            pass

    def old_launch():
        return old_fn(xp, wp, yp, 8, ctypes.addressof(old_params), stream)

    def old_rmsnorm(x, w, *, eps=1e-6, plus_one=False, block_rows=None):
        if x.ndim != 2 or w.shape != (x.shape[1],):
            raise ValueError("shape")
        n, d = x.shape
        br = n if block_rows is None else min(block_rows, n)
        if br < 1 or n % br != 0:
            raise ValueError("rows")
        if old_on_cpu(x, w):
            raise ValueError("cpu")
        if x.dtype not in rm._DTYPES or w.dtype != x.dtype:
            raise ValueError("dtype")
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("contiguous")
        y = torch.empty_like(x)
        p = rm.Params(d, eps, int(plus_one), rm._DTYPES[x.dtype],
                      *rm.launch_config(d, x.element_size(), True))
        with torch.cuda.device(x.device):
            err = old_fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n,
                         ctypes.addressof(p),
                         torch.cuda.current_stream(x.device).cuda_stream)
        old_check(err)
        old_count()
        return y

    def checks():
        return (x.ndim != 2 or w.shape != (x.shape[1],), x.shape,
                x.is_contiguous() and w.is_contiguous())

    steps = [
        ("shape checks", checks, checks),
        ("device check", lambda: old_on_cpu(x, w),
         lambda: mode.on_cpu(x, w, kernel="rmsnorm")),
        ("empty_like", lambda: torch.empty_like(x), lambda: torch.empty_like(x)),
        ("launch arguments", lambda: (
            x.dtype not in rm._DTYPES, x.data_ptr(), w.data_ptr(),
            y.data_ptr(), rm.Params(3584, 1e-6, 1, 0, 4, 256, 4)),
         lambda: (x.data_ptr(), w.data_ptr(), y.data_ptr(), rm._addresses.get(
             (x.dtype, w.dtype, 3584, True, 1e-6,
              (x.data_ptr() | w.data_ptr()) % 16 == 0)))),
        ("device context", old_context,
         lambda: torch._C._cuda_getDevice() == x.get_device()),
        ("stream handle", lambda: torch.cuda.current_stream(x.device).cuda_stream,
         lambda: torch._C._cuda_getCurrentRawStream(idx)),
        ("ctypes launch", old_launch,
         lambda: new_fn(xp, wp, yp, 8, params, stream)),
        ("error check", lambda: old_check(0), new_check),
        ("launch counter", old_count, lambda: mode.count_launch("rmsnorm")),
        ("whole call", lambda: old_rmsnorm(x, w, plus_one=True),
         lambda: rm.rmsnorm(x, w, plus_one=True)),
    ]

    empty = min(host_us(torch, lambda: None) for _ in range(3))
    print(f"  rmsnorm host cost per call, x(8,3584) f32 1+w (us, median of 5, "
          f"less {empty:.3f} us of an empty call; old -> new):", flush=True)
    total = {"old": 0.0, "new": 0.0}
    for name, old, new in steps:
        t = {}
        for label, f in (("old", old), ("new", new)):
            t[label] = statistics.median(host_us(torch, f)
                                         for _ in range(5)) - empty
            if name != "whole call":
                total[label] += t[label]
        print(f"    {name:18s} {t['old']:7.3f} -> {t['new']:7.3f}")
    print(f"    {'sum of the steps':18s} {total['old']:7.3f} -> "
          f"{total['new']:7.3f}", flush=True)

    # the kernels.dispatch counter: one attribute check with telemetry off,
    # a counter event per launch with a Recorder active; in turns
    from repro_torch import telemetry

    rec = telemetry.Recorder(sinks=[telemetry.MemorySink(maxlen=4096)])
    t = {"off": [], "on": []}
    for label in ("off", "on", "on", "off", "off", "on", "on", "off",
                  "off", "on"):
        with telemetry.recording(rec if label == "on" else None):
            t[label].append(host_us(torch, lambda: rm.rmsnorm(
                x, w, plus_one=True)) - empty)
    print(f"    whole call, telemetry off {statistics.median(t['off']):7.3f}"
          f", with a Recorder active {statistics.median(t['on']):7.3f} "
          f"(medians of 5 in turns; kernels.dispatch counted "
          f"{rec.total('kernels.dispatch', kernel='rmsnorm', mode='cuda')})",
          flush=True)


def host_us(torch, f, reps=1000):
    """Host microseconds of one call of ``f``: ``reps`` calls back to back
    on the host clock, after one warm-up call and a synchronize."""
    f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def in_turns(torch, kern, libs, reps, calls, rounds=5):
    """Median call ms and device ms of the kernel wrapper ``kern`` and of
    each yardstick in ``libs`` (name -> fn), timed in turns: every round
    runs the yardsticks, the kernel twice, then the yardsticks in reverse
    order, ``rounds`` rounds. Call ms: `time_ms` over ``reps`` back-to-back
    calls, the wrapper's host path included; device ms: ``calls`` calls
    captured in one CUDA graph, replayed 3 times (CUDA events), per call.
    Returns {name: (call ms, device ms)} with the kernel under "kernel"."""
    fns = {"kernel": kern, **libs}
    graphs = {k: capture(torch, f, calls) for k, f in fns.items()}
    order = [*libs, "kernel", "kernel", *reversed(list(libs))]
    call = {k: [] for k in fns}
    device = {k: [] for k in fns}
    for _ in range(rounds):
        for k in order:
            call[k].append(time_ms(fns[k], reps))
            device[k].append(replay_ms(torch, graphs[k], calls))
    del graphs
    return {k: (statistics.median(call[k]), statistics.median(device[k]))
            for k in fns}


def capture(torch, fn, calls):
    """``calls`` calls of ``fn`` captured in one CUDA graph (after a warm-up
    call on a side stream, as `torch.cuda.graph` asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(torch, graph, calls, replays=3):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def report_turns(name, shape, dt, err, tol, t, plain, bound):
    """One phase-3 line of a kernel timed in turns: its call and device ms
    beside each yardstick's, the plain version's ms and the bound, and
    whether the kernel's median call ms is at most the fastest
    yardstick's."""
    kc, kd = t["kernel"]
    libs = {k: v for k, v in t.items() if k != "kernel"}
    best = min(c for c, _ in libs.values())
    print(f"  {name:16s} {shape:44s} {dt:8s} max_abs_err {err:.3e} "
          f"(tol {tol:g})  call_ms {kc:.5f} device_ms {kd:.5f}  "
          + "  ".join(f"{k} call_ms {c:.5f} device_ms {d:.5f}"
                      for k, (c, d) in libs.items())
          + f"  plain_ms {plain:.5f}  bound_ms {bound[0]:.6f} ({bound[1]}, "
          f"{bound[0] / kd:.0%} of it on the device)  call / library "
          f"{kc / best:.3f}  call <= library: "
          f"{'yes' if kc <= best else 'NO'}", flush=True)
    check(err <= tol, f"{name} {shape} {dt}: max_abs_err {err} > {tol}")


def table_row(err, t, plain, bound):
    """The kernels-table entry of a kernel timed in turns: its median call
    ms, and the fastest yardstick's as the library time."""
    return dict(max_abs_err=err, ms=t["kernel"][0], plain_ms=plain,
                library_ms=min(c for k, (c, _) in t.items() if k != "kernel"),
                bound_ms=bound[0], bound_by=bound[1])


def bucket_host_cost(torch, dev, g, before=None):
    """Host microseconds of one bucket_pack / bucket_unpack wrapper call.
    Small buckets (8 rows of a four-leaf attention-like and a two-leaf
    MLP-like layout, f32), so the host and not the card sets the pace: each
    call runs 1000 times back to back on the host clock, less an empty
    call; medians of 5. ``before``, another checkout's `bucket.py` loaded
    beside this one's, is timed in turns with it on the same leaves."""
    from repro_torch.kernels import bucket as bk

    mods = {"this": bk} if before is None else {"before": before, "this": bk}
    empty = min(host_us(torch, lambda: None) for _ in range(3))
    print(f"  bucket host cost per call (us, median of 5, less {empty:.3f} "
          f"us of an empty call; {' -> '.join(mods)}):", flush=True)
    for label, widths in (("attn 4 leaves", (896, 128, 128, 896)),
                          ("MLP 2 leaves", (128, 128))):
        leaves = [torch.randn((8, w), generator=g, device=dev) for w in widths]
        flat = bk.bucket_pack(leaves)
        for name in ("bucket_pack", "bucket_unpack"):
            calls = {k: (lambda m=m: m.bucket_pack(leaves))
                     if name == "bucket_pack" else
                     (lambda m=m: m.bucket_unpack(flat, widths))
                     for k, m in mods.items()}
            t = {k: [] for k in calls}
            for _ in range(5):
                for k, f in calls.items():
                    t[k].append(host_us(torch, f))
            print(f"    {label:14s} {name:14s} " + " -> ".join(
                f"{statistics.median(v) - empty:7.3f}" for v in t.values()),
                flush=True)
        if before is not None:
            check(torch.equal(before.bucket_pack(leaves),
                              bk.bucket_pack(leaves)),
                  "bucket_pack: the two checkouts' wrappers disagree")


def bucket_rows(torch, dev, g, rows):
    """bucket_pack / bucket_unpack at the training path's bucket shapes:
    rows = D·n1·buf of the stacked emulated ranks (2 replicas x TP 4 at
    qwen2-7b widths), one launch per bucket; bit-exact against the plain
    versions, timed in turns with `torch.cat` and `split` + `.contiguous()`
    (call ms and device ms)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket import bucket_pack, bucket_unpack

    bucket_host_cost(torch, dev, g)
    attn = (3584 * 896, 3584 * 128, 3584 * 128, 896 * 3584)   # wq wk wv wo
    mlp = (3584 * 128, 128 * 3584)                             # A B
    cases = [("MLP TP (3,4)", 400, mlp), ("MLP healthy", 296, mlp),
             ("attn healthy", 8, attn), ("attn TP (3,4)", 16, attn)]
    for label, n_rows, widths in cases:
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            leaves = [torch.randn((n_rows, w), generator=g, device=dev).to(dt)
                      for w in widths]
            flat = bucket_pack(leaves)
            parts = bucket_unpack(flat, widths)
            torch.cuda.synchronize()
            want = ref.bucket_pack_ref(leaves)
            check(torch.equal(flat, want), f"bucket_pack {label} {dn} is not "
                  "bit-exact")
            check(all(torch.equal(p, w) for p, w in zip(
                parts, ref.bucket_unpack_ref(flat, widths))),
                f"bucket_unpack {label} {dn} is not bit-exact")
            del want, parts
            n_bytes = 2 * n_rows * sum(widths) * flat.element_size()
            bd = bound_ms(n_bytes, 0, dn)
            shape = f"{n_rows}x{sum(widths)} ({len(widths)} leaves)"
            timed = {
                "bucket_pack": (
                    lambda: bucket_pack(leaves),
                    lambda: ref.bucket_pack_ref(leaves),
                    {"torch.cat": lambda: torch.cat(leaves, dim=1)}),
                "bucket_unpack": (
                    lambda: bucket_unpack(flat, widths),
                    lambda: ref.bucket_unpack_ref(flat, widths),
                    {"split+contiguous": lambda: [
                        t.contiguous()
                        for t in torch.split(flat, widths, dim=1)]}),
            }
            for name, (kern, plain_fn, libs) in timed.items():
                plain = time_ms(plain_fn, 10)
                t = in_turns(torch, kern, libs, reps=10,
                             calls=2 if n_rows > 16 else 8)
                report_turns(name, f"{label} {shape}", dn, 0.0, 0.0, t,
                             plain, bd)
                if label == "MLP TP (3,4)" and dt == torch.float32:
                    rows[name] = table_row(0.0, t, plain, bd)
                torch.cuda.empty_cache()
            del leaves, flat
            torch.cuda.empty_cache()


SSD_TOL = 5e-4     # tests/test_kernels.py::test_ssd_scan


def ssd_rows(torch, dev, g, rows, report):
    """ssd_scan at the reference's test shapes, at the prefill shape of
    the Mamba-2 path (batch 4 x 48 heads, S=2048, hp 64, ds 128, chunk 256,
    B/C shared by a batch row's heads as the model passes them), at a
    ragged shape (hp 6, ds 12) and at d_state 256 / chunk 256 (shapes the
    earlier one-block-per-row kernel refused): y against the sequential
    plain version, the final state against the model's plain
    `_ssd_chunked` on the same card tensors, both within 5e-4. At the
    prefill shape, the CUDA kernels one call issues and each one's device
    ms (torch.profiler over 4 calls)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import _ssd_chunked

    cases = [(2, 64, 16, 32, 16, 2, 1), (3, 128, 16, 32, 32, 3, 1),
             (1, 256, 64, 128, 64, 1, 1), (2, 128, 6, 12, 32, 2, 2),
             (2, 512, 64, 256, 256, 2, 2), (4, 2048, 64, 128, 256, 4, 48)]
    for b, s, hp, ds, chunk, groups, nh in cases:
        bh = b * nh
        x = torch.randn((bh, s, hp), generator=g, device=dev)
        dt = 0.01 + 0.19 * torch.rand((bh, s), generator=g, device=dev)
        heads = bh if nh == 1 else nh        # one A per row, or per head
        a = -(0.5 + 1.5 * torch.rand((heads,), generator=g, device=dev))
        A = a.repeat(bh // heads)
        B = 0.3 * torch.randn((groups, s, ds), generator=g, device=dev)
        C = 0.3 * torch.randn((groups, s, ds), generator=g, device=dev)
        y, h = ssd_scan(x, dt, A, B, C, chunk=chunk, final_state=True)
        torch.cuda.synchronize()
        want = ref.ssd_scan_ref(x, dt, A, B, C)
        err = (y - want).abs().max().item()
        del want
        # the model-path formulation on (b, S, nh, ·) views of the same rows
        # (one call per row where every row has its own A)
        z = torch.zeros((b, nh, hp, ds), device=dev)
        if nh == 1:
            wh = torch.cat([_ssd_chunked(
                x[r:r + 1, :, None], dt[r:r + 1, :, None], a[r:r + 1],
                B[r:r + 1], C[r:r + 1], z[r:r + 1], chunk)[1]
                for r in range(b)])
        else:
            wh = _ssd_chunked(x.reshape(b, nh, s, hp).permute(0, 2, 1, 3),
                              dt.reshape(b, nh, s).permute(0, 2, 1), a, B, C,
                              z, chunk)[1]
        wh = wh.reshape(bh, hp, ds)
        err_h = (h - wh).abs().max().item()
        del wh
        print(f"  ssd_scan final state vs _ssd_chunked: max_abs_err "
              f"{err_h:.3e} (tol {SSD_TOL:g})")
        check(err_h <= SSD_TOL, f"ssd_scan final state off by {err_h}")
        ms = time_ms(lambda: ssd_scan(x, dt, A, B, C, chunk=chunk,
                                      final_state=True), 10)
        plain = time_ms(lambda: ref.ssd_scan_ref(x, dt, A, B, C,
                                                 final_state=True), 1)
        # C·Bᵀ once per (B/C row, chunk) over its L(L+1)/2 causal pairs;
        # per (row, chunk) the causal M·x, the carried term C·h and the
        # state update
        L, nc = min(chunk, s), s // min(chunk, s)
        n_ops = (groups * nc * L * (L + 1) * ds
                 + bh * nc * (L * (L + 1) * hp + 4 * L * hp * ds))
        n_bytes = 4 * (2 * bh * s * hp + bh * s + bh + 2 * groups * s * ds
                       + bh * hp * ds)
        bd = bound_ms(n_bytes, n_ops, "float32")
        shape = f"x({bh},{s},{hp}) B/C({groups},{s},{ds}) L={L}"
        report("ssd_scan", shape, "float32", err, ms, plain, None, bd,
               tol=SSD_TOL)
        graph = capture(torch, lambda: ssd_scan(x, dt, A, B, C, chunk=chunk,
                                                final_state=True), 4)
        dev_ms = statistics.median(replay_ms(torch, graph, 4)
                                   for _ in range(5))
        del graph
        print(f"  ssd_scan         {shape:34s} device_ms {dev_ms:.5f} (4 calls "
              f"in a CUDA graph, median of 5 replays of 3; "
              f"{bd[0] / dev_ms:.0%} of the bound)", flush=True)
        if s == 2048:
            rows["ssd_scan"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                    library_ms=None, bound_ms=bd[0],
                                    bound_by=bd[1])
            ssd_kernels(torch, lambda: ssd_scan(x, dt, A, B, C, chunk=chunk,
                                                final_state=True))
        del x, dt, A, B, C, y, h
    torch.cuda.empty_cache()


def ssd_kernels(torch, call, calls=4):
    """The CUDA kernels one ssd_scan call issues, each with its device ms
    per call (torch.profiler over ``calls`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    n = sum(e.count for e in kernels) / calls
    total = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    print(f"  ssd_scan         {n:g} CUDA kernels a call, {total:.5f} device "
          f"ms a call in all (torch.profiler, {calls} calls):", flush=True)
    check(n == 4, f"ssd_scan issued {n} kernels a call, not 4")
    for e in kernels:
        print(f"    {e.self_device_time_total / calls / 1e3:.5f} ms  "
              f"{e.key[:80]}")


def reference_phase(torch, dev):
    """A two-layer model at qwen2-7b's full width on the card against the
    same parameters on the CPU (plain kernel versions), small input."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch("qwen2-7b"), n_layers=2)
    gpu = build_model(cfg)
    params = gpu.init(torch.Generator(device=dev).manual_seed(7))
    cpu = build_model(cfg, device="cpu")
    cparams = _to(params, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 32),
                         generator=torch.Generator().manual_seed(8))
    gl, gc = gpu.prefill(params, toks.to(dev), gpu.init_cache(1, 40, torch.float32))
    cl, cc = cpu.prefill(cparams, toks, cpu.init_cache(1, 40, torch.float32))
    nxt = torch.tensor([[5]])
    gd, _ = gpu.decode_step(params, gc, nxt.to(dev), 32)
    cd, _ = cpu.decode_step(cparams, cc, nxt, 32)
    errs = [(gl.cpu() - cl).abs().max().item(), (gd.cpu() - cd).abs().max().item()]
    check(bool(torch.isfinite(gl).all()) and gl.shape == (1, 32, cfg.padded_vocab()),
          "reference model: non-finite or misshapen logits")
    print(f"  2-layer full-width qwen2-7b, card vs CPU plain versions: prefill "
          f"max_abs_err {errs[0]:.3e}, decode {errs[1]:.3e} (tol 1e-4)")
    check(max(errs) <= 1e-4, f"reference model disagrees: {errs}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def serve(session, requests, events):
    """Drive one session: request i arrives at tick i, ``events`` maps tick
    → event. Returns ({rid: tokens}, ticks, wall seconds)."""
    import torch

    from repro_torch.serve import Request, Router

    router = Router(session)
    pending = [Request(rid=i, prompt=p, max_new=16) for i, p in enumerate(requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    while pending or router.queue or any(e.n_active for e in session.engines):
        while pending and pending[0].rid <= tick:
            router.submit(pending.pop(0))
        if tick in events:
            router.apply(events[tick])
            e = session.engines[0]
            st = e.last_reshard
            print(f"  tick {tick:3d}: {type(events[tick]).__name__:13s} -> TP "
                  f"{e.tp}, capacity {e.capacity}, speed {e.rel_speed:.3f}, "
                  f"boost {e.power_boost:.2f}, reshard {st['bytes_moved']} B "
                  f"({st['bytes_moved'] / 2**20:.1f} MiB) in "
                  f"{st.get('messages', 0)} messages, preemptions so far "
                  f"{e.stats['preemptions']}", flush=True)
        router.step()
        tick += 1
        check(tick < 2000, "serving did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {r.rid: list(r.generated) for r in router.completed}, tick, wall


def serve_phase(torch, dev):
    """Phase 4. Returns the launch counts of the fail→repair run."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mode
    from repro_torch.runtime import FailureEvent, RecoveryEvent
    from repro_torch.serve import ServeSession

    cfg = get_arch("qwen2-7b")
    kw = dict(replicas=1, n1=4, slots=8, max_len=96, prefill_len=32,
              policy="ntp_pw")
    t0 = time.perf_counter()
    session = ServeSession.create(cfg, seed=0, **kw)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(session.params))
    print(f"  qwen2-7b full size: {n_par / 1e9:.3f} B params f32 "
          f"({n_par * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    clean = ServeSession.create(cfg, params=session.params, **kw)
    check(clean.params is session.params, "sessions must share one weight copy")

    rng = np.random.default_rng(0)
    requests = [rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
                for _ in range(24)]
    events = {10: FailureEvent(domain=0), 14: FailureEvent(domain=0),
              40: RecoveryEvent(domain=0), 48: RecoveryEvent(domain=0)}

    mode.reset_launches()
    got, ticks, wall = serve(session, requests, events)
    launches = mode.launches()
    tokens = session.engines[0].stats["tokens"]
    tps = [t["tp_to"] for t in session.transitions]
    print(f"  fail->repair run: {len(got)} requests, {tokens} tokens in "
          f"{ticks} ticks, {wall:.2f} s wall: {tokens / wall:.1f} tokens/s; "
          f"TP path {tps}; preemptions "
          f"{session.engines[0].stats['preemptions']}", flush=True)
    want, cticks, cwall = serve(clean, requests, {})
    ctokens = clean.engines[0].stats["tokens"]
    print(f"  uninterrupted run: {len(want)} requests, {ctokens} tokens in "
          f"{cticks} ticks, {cwall:.2f} s wall: {ctokens / cwall:.1f} tokens/s",
          flush=True)

    check(tps == [3, 2, 3, 4], f"TP path {tps} != [3, 2, 3, 4]")
    check(session.engines[0].stats["preemptions"] > 0, "no preemption happened")
    check(len(got) == 24 and all(len(t) == 16 for t in got.values()),
          "not every request completed with 16 tokens")
    diverged = [rid for rid in want if got.get(rid) != want[rid]]
    check(not diverged, f"token streams diverged through fail->repair: {diverged}")
    print("  all 24 token streams identical to the uninterrupted run")
    for t in session.transitions:
        r = t["reshard"]
        print(f"  transition TP {t['tp_from']}->{t['tp_to']}: "
              f"{r['bytes_moved']} bytes moved, {r['moved_units_per_rank']} "
              f"unit rows through the busiest rank, {r.get('messages', 0)} "
              f"messages, {t['preempted']} preempted")

    # steady-state decode tick at 8 slots (CUDA events)
    eng = clean.engines[0]
    toks = torch.ones(8, dtype=torch.long, device=dev)
    pos = torch.arange(8, device=dev) + 40
    tick_ms = time_ms(lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                     toks, pos), 10)
    floor_ms = n_par * 4 / MEM_BW * 1e3
    print(f"  decode tick (8 slots, full model): {tick_ms:.3f} ms; weight-read "
          f"floor {floor_ms:.3f} ms ({n_par * 4 / 1e9:.2f} GB at 3.35 TB/s)")
    profile_steps(torch, lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                        toks, pos), "decode tick")
    print(f"  kernels {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"a kernel of the path never launched: {launches}")
    del session, clean, eng
    return launches


def mamba_reference_phase(torch, dev):
    """A two-layer Mamba-2 at mamba2-780m's full width on the card against
    the same parameters on the CPU (plain kernel versions: the sequential
    SSD recurrence), on one 512-token prompt, then one decode step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch("mamba2-780m"), n_layers=2)
    gpu = build_model(cfg)
    params = gpu.init(torch.Generator(device=dev).manual_seed(7))
    cpu = build_model(cfg, device="cpu")
    cparams = _to(params, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 512),
                         generator=torch.Generator().manual_seed(8))
    gl, gc = gpu.prefill(params, toks.to(dev), gpu.init_cache(1, 8, torch.float32))
    cl, cc = cpu.prefill(cparams, toks, cpu.init_cache(1, 8, torch.float32))
    errs = {"prefill logits": (gl.cpu() - cl).abs().max().item()}
    for name in ("h", "conv"):
        errs[f"cache {name}"] = (gc[name].cpu() - cc[name]).abs().max().item()
    nxt = torch.tensor([[5]])
    gd, _ = gpu.decode_step(params, gc, nxt.to(dev), 512)
    cd, _ = cpu.decode_step(cparams, cc, nxt, 512)
    errs["decode logits"] = (gd.cpu() - cd).abs().max().item()
    check(bool(torch.isfinite(gl).all()) and gl.shape == (1, 512, cfg.padded_vocab()),
          "reference Mamba-2: non-finite or misshapen logits")
    # the card's prefill runs the chunked scan, the CPU's plain version the
    # sequential recurrence: the reference holds those two to 5e-4
    print("  2-layer full-width mamba2-780m, card vs CPU plain versions: "
          + ", ".join(f"{k} max_abs_err {v:.3e}" for k, v in errs.items())
          + f" (tol {SSD_TOL:g}); max |logit| {cl.abs().max().item():.3f}, "
          f"max |h| {cc['h'].abs().max().item():.3f}")
    check(max(errs.values()) <= SSD_TOL, f"reference Mamba-2 disagrees: {errs}")


def scan_yardstick(torch, cfg, model, params, prompts):
    """Layer 0's SSD scan on the prefill's own inputs: the kernel and the
    reference model's chunked formulation (`_ssd_chunked`), each against
    the sequential recurrence (`ssd_scan_ref`), in y and the final state.
    It measures what the chunked form itself gives up in f32: its decays
    subtract cumulative sums of dt·A that reach ~1e3 within a 256-step
    chunk. The kernel must be no further off than twice the chunked form
    (or 5e-4)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import ssm
    from repro_torch.models.transformer import norm_apply

    lp = params["layers"][0]
    x = norm_apply(cfg, lp["ln1"], model._embed(params, prompts))
    _, xh, dt, A, B, C, _ = ssm.scan_inputs(cfg, lp["mixer"], x)
    b, s, nh, hp = xh.shape
    L = cfg.ssm.chunk
    rows = (xh.permute(0, 2, 1, 3).reshape(b * nh, s, hp),
            dt.permute(0, 2, 1).reshape(b * nh, s), A.repeat(b), B, C)
    ys, hs = ref.ssd_scan_ref(*rows, final_state=True)
    yk, hk = ssd_scan(*rows, chunk=L, final_state=True)
    yc, hc = ssm._ssd_chunked(xh, dt, A, B, C,
                              xh.new_zeros((b, nh, hp, B.shape[-1])), L)
    yc = yc.permute(0, 2, 1, 3).reshape(b * nh, s, hp)
    hc = hc.reshape(hs.shape)
    errs = {name: ((y - ys).abs().max().item(), (h - hs).abs().max().item())
            for name, y, h in (("kernel", yk, hk), ("_ssd_chunked", yc, hc))}
    print(f"  (b) layer 0's scan on the prefill's inputs (|dt·A| up to "
          f"{(dt * A).abs().max().item():.2f} per step; max |y| "
          f"{ys.abs().max().item():.3f}, max |h| {hs.abs().max().item():.3f}) "
          "against the sequential recurrence: " + "; ".join(
              f"{n} y max_abs_err {ey:.3e}, h {eh:.3e}"
              for n, (ey, eh) in errs.items()), flush=True)
    for i, what in enumerate(("y", "h")):
        ek, ec = errs["kernel"][i], errs["_ssd_chunked"][i]
        check(ek <= max(SSD_TOL, 2 * ec),
              f"layer-0 scan: kernel {what} off by {ek}, chunked form {ec}")


def decode_graph(torch, model, params, cache, tok):
    """One `decode_step` of ``model`` on ``cache`` reading the token buffer
    ``tok``, captured as a CUDA graph (after a warm-up step on a side
    stream); ``cache`` is restored to its state before the warm-up. Returns
    (graph, the graph's logits tensor)."""
    saved = {k: v.clone() for k, v in cache.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(params, cache, tok, 1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = model.decode_step(params, cache, tok, 1)
    for k, v in saved.items():
        cache[k].copy_(v)
    return graph, logits


def mamba_phase(torch, dev):
    """Phase 5: mamba2-780m at full size (48 layers, f32, seeded weights on
    the card). (a) a batched prefill of 4 x 2048 tokens through
    `Model.prefill` (one ssd_scan per layer) and 32 greedy decode steps;
    (b) the prefill's last logits and h cache against the same prompts fed
    token by token through the recurrent path on the card; (c) two layers
    on the card against the CPU (`mamba_reference_phase`); (d) serving
    through fail->fail->repair->repair against an uninterrupted session;
    (e) times, profiles and peak memory. Returns the launch counts of (a)
    and (d), each counted from zero just before it."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mode
    from repro_torch.models.transformer import build_model
    from repro_torch.reshard import planner
    from repro_torch.runtime import FailureEvent, RecoveryEvent
    from repro_torch.serve import ServeSession

    mamba_reference_phase(torch, dev)
    cfg = get_arch("mamba2-780m")
    b, s, new = 4, 2048, 32
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_par = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    cache = model.init_cache(b, s + new, torch.float32)
    torch.cuda.synchronize()
    print(f"  mamba2-780m full size: {n_par / 1e9:.4f} B params f32 "
          f"({n_par * 4 / 1e9:.2f} GB) on the card; cache h "
          f"{cache['h'].numel() * 4 / 1e6:.1f} MB, conv "
          f"{cache['conv'].numel() * 4 / 1e6:.1f} MB", flush=True)

    # (a) the main path: batched prefill, then greedy decode
    mode.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = mode.launches()
    last = logits[:, -1].clone()
    h_pre = cache["h"].clone()
    del logits
    tok = torch.argmax(last[:, :cfg.vocab_size], -1)[:, None]
    t0 = time.perf_counter()
    for i in range(new):
        lg, cache = model.decode_step(params, cache, tok, s + i)
        tok = torch.argmax(lg[:, 0, :cfg.vocab_size], -1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    run = mode.launches()
    check(launches["ssd_scan"] == cfg.n_layers,
          f"prefill launched ssd_scan {launches['ssd_scan']} times, not "
          f"{cfg.n_layers}")
    check(run["ssd_scan"] == cfg.n_layers, "decode launched ssd_scan")
    check(bool(torch.isfinite(lg).all()), "decode: non-finite logits")
    print(f"  (a) prefill {b}x{s}: {prefill_s * 1e3:.1f} ms, "
          f"{b * s / prefill_s:.1f} tokens/s; {new} greedy decode steps: "
          f"{decode_s / new * 1e3:.2f} ms per step ({b * new / decode_s:.1f} "
          f"tokens/s); kernels {json.dumps(run)}", flush=True)

    # (b) the same prompts token by token through the recurrent update: the
    # decode step replayed as one CUDA graph (an SSM layer's decode does not
    # read the position, so one capture serves every step; the graph runs
    # the same kernels and only removes the host's ~2,000 launches a step)
    rc = model.init_cache(b, s, torch.float32)
    lr, rc = model.prefill(params, prompts[:, :1], rc)
    tok = prompts[:, 1:2].clone()
    graph, lr = decode_graph(torch, model, params, rc, tok)
    for t in range(1, s):
        tok.copy_(prompts[:, t:t + 1])
        graph.replay()
    ref_l, ref_h = lr[:, 0].clone(), rc["h"].clone()
    del rc, lr, graph
    l_max, h_max = ref_l.abs().max().item(), ref_h.abs().max().item()
    err_l = (last - ref_l).abs().max().item()
    err_h = (h_pre - ref_h).abs().max().item()
    print(f"  (b) prefill vs token by token ({s} recurrent steps): last "
          f"logits max_abs_err {err_l:.3e} (max |logit| {l_max:.3f}), h "
          f"max_abs_err {err_h:.3e} (max |h| {h_max:.3f}); tol 1e-3 x max |.|",
          flush=True)
    check(err_l <= 1e-3 * l_max, f"prefill logits off the recurrent path: {err_l}")
    check(err_h <= 1e-3 * h_max, f"prefill h off the recurrent path: {err_h}")
    del ref_l, ref_h, h_pre
    scan_yardstick(torch, cfg, model, params, prompts)
    torch.cuda.empty_cache()

    # (e) times and where they go
    profile_steps(torch, lambda: model.prefill(params, prompts, cache),
                  "prefill", ticks=1, top=8)
    tok1 = torch.ones((b, 1), dtype=torch.long, device=dev)
    step_ms = time_ms(lambda: model.decode_step(params, cache, tok1, s), 10)
    print(f"  decode step (batch {b}, CUDA events): {step_ms:.3f} ms; "
          f"weight-read floor {n_par * 4 / MEM_BW * 1e3:.3f} ms")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del cache, model, prompts, last

    # (d) serving through fail->fail->repair->repair
    kw = dict(replicas=1, n1=4, slots=8, max_len=96, prefill_len=32,
              policy="ntp_pw")
    session = ServeSession.create(cfg, params=params, **kw)
    clean = ServeSession.create(cfg, params=params, **kw)
    rng = np.random.default_rng(0)
    requests = [rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
                for _ in range(24)]
    events = {10: FailureEvent(domain=0), 14: FailureEvent(domain=0),
              40: RecoveryEvent(domain=0), 48: RecoveryEvent(domain=0)}
    mode.reset_launches()
    got, ticks, wall = serve(session, requests, events)
    served = mode.launches()
    tokens = session.engines[0].stats["tokens"]
    tps = [t["tp_to"] for t in session.transitions]
    print(f"  (d) fail->repair run: {len(got)} requests, {tokens} tokens in "
          f"{ticks} ticks, {wall:.2f} s wall: {tokens / wall:.1f} tokens/s; "
          f"TP path {tps}; preemptions "
          f"{session.engines[0].stats['preemptions']}; kernels "
          f"{json.dumps(served)}", flush=True)
    want, cticks, cwall = serve(clean, requests, {})
    ctokens = clean.engines[0].stats["tokens"]
    print(f"  uninterrupted run: {ctokens} tokens in {cticks} ticks, "
          f"{cwall:.2f} s wall: {ctokens / cwall:.1f} tokens/s", flush=True)
    check(tps == [3, 2, 3, 4], f"TP path {tps} != [3, 2, 3, 4]")
    check(session.engines[0].stats["preemptions"] > 0, "no preemption happened")
    check(len(got) == 24 and all(len(t) == 16 for t in got.values()),
          "not every request completed with 16 tokens")
    diverged = [rid for rid in want if got.get(rid) != want[rid]]
    check(not diverged, f"token streams diverged through fail->repair: {diverged}")
    print("  all 24 token streams identical to the uninterrupted run")
    check(served["reshard_pack"] > 0, "the ssm_head reshards ran no reshard_pack")
    # ledger: moved SSD heads x the bytes of one head's h and conv channels
    ssm = cfg.ssm
    nh = ssm.n_heads(cfg.d_model)
    head_bytes = 4 * cfg.n_layers * kw["slots"] * ssm.head_dim * (
        ssm.d_state + ssm.d_conv - 1)
    for t in session.transitions:
        r = t["reshard"]
        plan = planner.transition_plan(planner.sync_key(nh, 4, t["tp_from"]),
                                       planner.sync_key(nh, 4, t["tp_to"]),
                                       nh, nh)
        print(f"  transition TP {t['tp_from']}->{t['tp_to']}: "
              f"{r['bytes_moved']} bytes moved ({plan.n_moved} SSD heads x "
              f"{head_bytes} B), {r['moved_units_per_rank']} unit rows "
              f"through the busiest rank, {r.get('messages', 0)} messages, "
              f"{t['preempted']} preempted")
        check(r["bytes_moved"] == plan.n_moved * head_bytes,
              f"ssm_head ledger {r['bytes_moved']} != {plan.n_moved * head_bytes}")
    eng = clean.engines[0]
    toks = torch.ones(8, dtype=torch.long, device=dev)
    pos = torch.arange(8, device=dev) + 40
    tick_ms = time_ms(lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                     toks, pos), 10)
    print(f"  decode tick (8 slots, full model, CUDA events): {tick_ms:.3f} ms")
    profile_steps(torch, lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                        toks, pos), "decode tick")
    del session, clean, eng, params
    torch.cuda.empty_cache()
    return {k: run[k] + served[k] for k in run}


def mamba_launcher_phase():
    """(f) the launcher twin at the prefill shape."""
    from repro_torch.launch.serve_decode import main as decode_main

    out = decode_main(["--arch", "mamba2-780m", "--full", "--batch", "4",
                       "--prompt-len", "2048", "--new", "32"])
    check(out["tokens"].shape == (4, 32), "launcher: wrong token shape")


SERVE_KERNELS = ("rmsnorm", "flash_attention", "reshard_pack")
TRAIN_KERNELS = ("bucket_pack", "bucket_unpack", "reshard_pack")
MAMBA_KERNELS = ("rmsnorm", "reshard_pack", "ssd_scan")


def train_phase(torch, dev):
    """Phase 6. Returns the launch counts of the fail→repair training run."""
    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.optim import sgd
    from repro_torch.reshard.transition import expected_transfer
    from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

    cfg = nt.NTPModelConfig(d_model=3584, n_kv_groups=4, q_per_kv=7,
                            head_dim=128, d_ff=18944, unit_rows=128,
                            vocab=152064, n_layers=4)
    lr, lb, seq, steps = 1e-2, 4, 256, 9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    n_par = sum(t.numel() for t in tr.leaves(ref))
    kw = dict(mode="uniform", local_batch=lb, optimizer=sgd(lr), params=ref,
              device=dev)
    sessions = {"on": NTPSession.create(cfg, (2, 4), overlap=True, **kw),
                "off": NTPSession.create(cfg, (2, 4), overlap=False, **kw)}
    torch.cuda.synchronize()
    print(f"  NTP prototype at qwen2-7b widths, 4 layers: {n_par / 1e9:.3f} B "
          f"canonical params f32; two packed sessions (overlap on/off) and "
          f"the dense reference on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * lb, seed=0))
    ref_loss = nt.make_reference_loss(cfg)
    # packing puts the failed domain (domain 1) into replica 0, so the
    # repair addresses replica 0
    events = {3: FailureEvent(step=3, replica=1, n_gpus=1),
              6: RecoveryEvent(step=6, replica=0, n_gpus=1)}
    step_ms = {"on": [], "off": []}
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    def timed(fn):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    mode.reset_launches()
    for i in range(steps):
        if i in events:
            for name, s in sessions.items():
                old = s.plan
                new, ms = timed(lambda: s.apply(events[i]))
                st = s.last_transition
                want = sum(int(m.sum() - np.trace(m)) * _unit_bytes(cfg, f)
                           for f, m in expected_transfer(cfg, old, new).items())
                print(f"  step {i}: {type(events[i]).__name__} -> plan "
                      f"{new.replica_tp} mode {s.mode.value} [{name}]: "
                      f"transition {ms:.3f} ms, {st.bytes_moved} B moved "
                      f"({st.bytes_moved / 2**20:.1f} MiB) in {st.messages} "
                      f"messages, {st.moved_units} units moved, "
                      f"{st.stayed_units} stayed (expected {want} B)",
                      flush=True)
                check(st.bytes_moved == want,
                      f"transition ledger {st.bytes_moved} != {want}")
        tokens = pipe._batch_np(i)
        losses = {}
        for name, s in sessions.items():
            m, ms = timed(lambda: s.step(tokens))
            losses[name] = float(m["loss"])
            step_ms[name].append(ms)
        lbs = sessions["on"].local_batches
        mask = torch.tensor(np.concatenate(
            [np.arange(lb) < lbs[d] for d in range(2)]), dtype=torch.float32,
            device=dev)
        leaves = tr.tree_map(lambda t: t.requires_grad_(True), ref)
        rl = ref_loss(leaves, torch.as_tensor(tokens, device=dev), mask)
        grads = torch.autograd.grad(rl, tr.leaves(leaves))
        ref = tr.tree_map(lambda t: t.detach(), ref)
        with torch.no_grad():
            for p, gr in zip(tr.leaves(ref), grads):
                p.sub_(lr * gr)
        del grads, leaves
        rl = float(rl.detach())
        plan = sessions["on"].plan.replica_tp
        print(f"  step {i}: plan {plan} loss on {losses['on']:.6f} off "
              f"{losses['off']:.6f} reference {rl:.6f}; |on-ref| "
              f"{abs(losses['on'] - rl):.2e} |off-ref| "
              f"{abs(losses['off'] - rl):.2e} |on-off| "
              f"{abs(losses['on'] - losses['off']):.2e}; ms on "
              f"{step_ms['on'][-1]:.1f} off {step_ms['off'][-1]:.1f} "
              f"(collectives on {sessions['on'].step_fn.collectives}, off "
              f"{sessions['off'].step_fn.collectives})", flush=True)
        check(np.isfinite([losses["on"], losses["off"], rl]).all(),
              "non-finite loss")
        check(abs(losses["on"] - rl) < 1e-4 and abs(losses["off"] - rl) < 1e-4,
              f"step {i}: loss off the dense reference")
        check(abs(losses["on"] - losses["off"]) < 1e-5,
              f"step {i}: overlap on and off disagree")
    launches = mode.launches()
    print(f"  kernels {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f"a kernel of the training path never launched: {launches}")
    check([s.plan.replica_tp for s in sessions.values()] == [(4, 4)] * 2,
          "the run did not end healthy")
    errs = {}
    for name, s in sessions.items():
        for r in range(2):
            got = s.canonical_params(r)
            errs[(name, r)] = max(float((a - b).abs().max()) for a, b in
                                  zip(tr.leaves(got), tr.leaves(ref)))
            del got
    on0, off0 = (sessions[n].canonical_params(0) for n in ("on", "off"))
    d_onoff = max(float((a - b).abs().max())
                  for a, b in zip(tr.leaves(on0), tr.leaves(off0)))
    del on0, off0
    print(f"  canonical params vs the dense reference: "
          + ", ".join(f"{n} replica {r} {e:.2e}" for (n, r), e in errs.items())
          + f"; on vs off {d_onoff:.2e} (tol 1e-4)")
    check(max(errs.values()) < 1e-4 and d_onoff < 1e-4,
          "canonical params diverged")
    peak = torch.cuda.max_memory_allocated()
    phases = {"healthy": range(0, 3), "degraded": range(3, 6),
              "repaired": range(6, 9)}
    for ph, idx in phases.items():
        print(f"  {ph} steps ms: " + "; ".join(
            f"overlap {n} " + ", ".join(f"{step_ms[n][i]:.1f}" for i in idx)
            for n in ("off", "on")))
    print(f"  peak device memory {peak / 1e9:.2f} GB", flush=True)

    # after the checked run (the params move on): step times in turns
    # (off, on, on, off) with the reference freed, host syncs per step, and
    # a profile of one step of each session on the degraded plan
    del ref
    torch.cuda.empty_cache()
    tokens = pipe._batch_np(steps)
    for label, event in (("healthy", None),
                         ("degraded", FailureEvent(replica=1, n_gpus=1))):
        for s in sessions.values():
            if event is not None:
                s.apply(event)
            s.step(tokens)                               # warm-up
        turns = {"off": [], "on": []}
        churn = {"off": [], "on": []}
        for name in ("off", "on", "on", "off"):
            before = torch.cuda.memory_stats()
            turns[name].append(timed(lambda: sessions[name].step(tokens))[1])
            churn[name].append(allocator_churn(torch, before))
        syncs = {n: host_syncs(torch, lambda: s.step(tokens))
                 for n, s in sessions.items()}
        print(f"  {label} step in turns (off, on, on, off): ms off "
              + ", ".join(f"{t:.1f}" for t in turns["off"]) + "; on "
              + ", ".join(f"{t:.1f}" for t in turns["on"])
              + f"; host syncs per step off {syncs['off']}, on "
              f"{syncs['on']}; allocator (cudaMalloc, cudaFree, retries) "
              f"per step off {churn['off']}, on {churn['on']}; reserved "
              f"{torch.cuda.memory_reserved() / 1e9:.1f} GB", flush=True)
    # the degraded gradient sync alone, on one set of pre-sync grads
    _, grads = sessions["off"].step_fn.grads_fn(sessions["off"].params,
                                                tokens)
    sync_ms = {}
    for name in ("off", "on", "on", "off"):
        fn = sessions[name].step_fn.sync_fn
        sync_ms.setdefault(name, []).append(timed(lambda: fn(grads))[1])
    print("  degraded gradient sync alone (same grads, in turns): "
          + "; ".join(f"{'bucketed' if n == 'on' else 'per-leaf'} "
                      f"({sessions[n].step_fn.sync_fn.collectives} "
                      f"collectives) " + ", ".join(f"{t:.1f}" for t in v)
                      + " ms" for n, v in sync_ms.items()), flush=True)
    del grads
    for name in ("off", "on"):
        s = sessions[name]
        packs = []
        with record_packs(packs):
            profile_steps(torch, lambda: s.step(tokens),
                          f"degraded step (overlap {name})", ticks=1, top=8,
                          also="pack_kernel")
        shapes = {}
        for key in packs:
            shapes[key] = shapes.get(key, 0) + 1
        print(f"    reshard_pack launches in this step: {len(packs)}; by "
              "(xp, send_idx, dtype), most bytes written first: " + "; ".join(
                  f"{xp} {ix} {dn} x{c}" for (xp, ix, dn), c in sorted(
                      shapes.items(), key=lambda kv: -kv[1] * _written(kv[0]))),
              flush=True)
    del s, sessions
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def record_packs(calls):
    """Record (xp shape, send_idx shape, dtype) of every `reshard_pack_ranks`
    call the reshard engine makes inside the block."""
    from repro_torch.reshard import engine

    real = engine.reshard_pack_ranks

    def recorded(xp, send_idx):
        calls.append((tuple(xp.shape), tuple(send_idx.shape),
                      str(xp.dtype).split(".")[1]))
        return real(xp, send_idx)

    engine.reshard_pack_ranks = recorded
    try:
        yield
    finally:
        engine.reshard_pack_ranks = real


def _written(key):
    """Elements one `reshard_pack_ranks` call of shape ``key`` writes."""
    (_, _, elems), ix, _ = key
    return elems * ix[0] * ix[1] * ix[2]


def host_syncs(torch, fn):
    """How many times ``fn`` makes the host wait for the device (CUDA sync
    debug mode warns at each synchronizing call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n0 = len(caught)     # (switching the mode warns once itself)
            fn()
            run = caught[n0:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in run)


def allocator_churn(torch, before):
    """(cudaMalloc calls, cudaFree calls, OOM retries) of the caching
    allocator since the ``before`` snapshot of `torch.cuda.memory_stats`."""
    after = torch.cuda.memory_stats()
    return tuple(after.get(k, 0) - before.get(k, 0) for k in
                 ("num_device_alloc", "num_device_free", "num_alloc_retries"))


def _unit_bytes(cfg, family):
    """f32 bytes of one partition unit of ``family``, over every layer."""
    d, qh, h = cfg.d_model, cfg.q_per_kv * cfg.head_dim, cfg.head_dim
    elems = {"wq": d * qh, "wk": d * h, "wv": d * h, "wo": qh * d,
             "A": d * cfg.unit_rows, "B": cfg.unit_rows * d}[family]
    return elems * 4 * cfg.n_layers


TRACE_KERNELS = ("bucket_pack", "bucket_unpack", "reshard_pack")
# the mixed trace phase 7 replays (tests/test_torch_lifecycle.py pins it):
# failure -> link degrade -> link repair -> repair -> SDC suspect (rollback)
# -> clear -> straggler -> clear, over 16 steps of 2 replicas x TP 4
TRACE = dict(n_gpus=8, domain_size=4, days=16 / 1.0 / 24.0,
             rate_multiplier=200.0, seed=136, straggler_rate_mult=2.0,
             link_rate_mult=2.0, sdc_rate_mult=1.0)
TRACE_STEPS, TRACE_STEPS_PER_HOUR, TRACE_CKPT_STEP = 16, 1.0, 8
TRACE_LAUNCHER = ["--trace", "200", "--trace-seed", "136", "--trace-mix",
                  "straggler=2,link=2,sdc=1", "--power-policy", "ntp_pw"]


def _host_decisions(torch):
    """Per-step plans, local batches and policy verdicts of the phase-7
    schedule through the port on the CPU (a 2-layer model of the same
    geometry: they are host-side, so they must equal the card's)."""
    from repro_torch.core import ntp_train as nt
    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.optim import sgd
    from repro_torch.runtime import (
        NTPSession, TraceRunner, power_policy, schedule_from_trace,
    )

    cfg = nt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=7,
                            head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                            n_layers=2)
    s = NTPSession.create(cfg, (2, 4), local_batch=4, optimizer=sgd(1e-2),
                          device="cpu", overlap=True,
                          generator=torch.Generator().manual_seed(0),
                          power_policy=power_policy("ntp_pw"))
    decisions = _record_decisions(s)
    runner = TraceRunner(s, schedule_from_trace(
        FailureTraceConfig(**TRACE), steps=TRACE_STEPS,
        steps_per_hour=TRACE_STEPS_PER_HOUR))
    runner.run(lambda i: torch.zeros((8, 17), dtype=torch.int64),
               TRACE_STEPS)
    return [_host_fields(h) for h in runner.history], decisions


def _host_fields(rec):
    return {k: rec.get(k) for k in ("replica_tp", "local_batches",
                                    "events_applied", "policy", "power_boost",
                                    "rel_iter_time", "quarantined")}


def _record_decisions(session):
    """Wrap ``session.step`` so each step appends the session's
    `power_decision`; returns the list."""
    real, out = session.step, []

    def step(batch):
        out.append(session.power_decision)
        return real(batch)

    session.step = step
    return out


def _regime(session):
    if session.quarantined:
        return "quarantined"
    if session.health.degraded is not None:
        return f"repriced (straggler/link) at TP {session.plan.replica_tp}"
    if not session.plan.healthy:
        return f"degraded at TP {session.plan.replica_tp}"
    return "healthy"


def trace_phase(torch, dev):
    """Phase 7. Returns the launch counts of the trace-driven run."""
    import gc
    import shutil

    import numpy as np

    from repro_torch import telemetry
    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.optim import sgd
    from repro_torch.reshard.transition import expected_transfer
    from repro_torch.runtime import (
        NTPSession, TraceRunner, event_kind, power_policy,
        schedule_from_trace,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = nt.NTPModelConfig(d_model=3584, n_kv_groups=4, q_per_kv=7,
                            head_dim=128, d_ff=18944, unit_rows=128,
                            vocab=152064, n_layers=4)
    lb, seq = 4, 256
    schedule = schedule_from_trace(FailureTraceConfig(**TRACE),
                                   steps=TRACE_STEPS,
                                   steps_per_hour=TRACE_STEPS_PER_HOUR)
    print("  schedule: " + "; ".join(
        f"step {e.step} {event_kind(e.event)} domain {e.event.domain}"
        + (f" x{e.event.slowdown:.4f}" if hasattr(e.event, "slowdown")
           else f" bw {e.event.bw_frac:.4f}" if hasattr(e.event, "bw_frac")
           else "") for e in schedule), flush=True)
    want_host, want_decisions = _host_decisions(torch)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * lb, seed=0))
    batches = [torch.as_tensor(pipe._batch_np(i), device=dev)
               for i in range(TRACE_STEPS)]
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    def timed(fn):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def new_session():
        canon = nt.init_canonical(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        return NTPSession.create(cfg, (2, 4), local_batch=lb,
                                 optimizer=sgd(1e-2), params=canon,
                                 overlap=True, device=dev,
                                 power_policy=power_policy("ntp_pw"),
                                 quarantine=True)

    session = new_session()
    decisions = _record_decisions(session)
    real_step, real_apply = session.step, session.apply
    step_ms, applies = [], []

    def step(batch):
        regime = _regime(session)
        out, ms = timed(lambda: real_step(batch))
        step_ms.append((regime, ms))
        return out

    def apply(ev):
        old = session.plan
        out, ms = timed(lambda: real_apply(ev))
        st = session.last_transition if out != old else None
        applies.append((ev, old, out, ms, st, session.last_rollback))
        return out

    session.step, session.apply = step, apply
    rec = telemetry.Recorder(sinks=[telemetry.MemorySink(maxlen=None)])
    t0 = time.perf_counter()
    with telemetry.recording(rec):
        runner = TraceRunner(session, schedule, verify=True, atol=1e-4)
    print(f"  session, dense reference and the step-0 snapshot (host) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    snap_bytes = sum(t.numel() * t.element_size()
                     for t in tr.leaves(session._snapshot))
    ckpt_dir = scratch_dir()
    try:
        mode.reset_launches()
        with telemetry.recording(rec):
            runner.run(lambda i: batches[i], TRACE_CKPT_STEP)
            ckpt = checkpoint_round_trip(torch, session, cfg, dev, ckpt_dir,
                                         new_plan=session.plan)
            runner.run(lambda i: batches[i], TRACE_STEPS - TRACE_CKPT_STEP)
        launches = mode.launches()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for h in runner.history:
        print(f"  step {h['step']:2d}: tp {h['replica_tp']} local batches "
              f"{h['local_batches']} policy {h['policy']} boost "
              f"{h['power_boost']:.2f} rel_iter {h['rel_iter_time']:.4f} "
              f"loss {h['loss']:.6f} reference {h['ref_loss']:.6f} |diff| "
              f"{abs(h['loss'] - h['ref_loss']):.2e}; "
              f"{step_ms[h['step']][0]}, {step_ms[h['step']][1]:.1f} ms",
              flush=True)
    # every transition's ledger against expected_transfer, and the span
    spans = rec.spans("session.transition")
    check(len(spans) == len(applies), "a transition span is missing")
    for (ev, old, new, ms, st, rolled), sp in zip(applies, spans):
        line = (f"  apply {event_kind(ev)} domain {ev.domain}: plan "
                f"{old.replica_tp} -> {new.replica_tp} in {ms:.3f} ms")
        if st is not None:
            want = sum(int(m.sum() - np.trace(m)) * _unit_bytes(cfg, f)
                       for f, m in expected_transfer(cfg, old, new).items())
            line += (f", {st.bytes_moved} B in {st.messages} messages "
                     f"(expected {want} B)")
            check(st.bytes_moved == want,
                  f"transition ledger {st.bytes_moved} != {want}")
            check(all(sp["attrs"][k] == v for k, v in st.as_dict().items()),
                  f"span {sp['attrs']} != ledger {st.as_dict()}")
        if rolled:
            line += " (rolled back to the step-0 snapshot)"
        print(line, flush=True)
    for t in runner.transitions:
        if "canonical_err" in t:
            print(f"  step {t['step']} {t['kind']}"
                  f"{' rollback' if t.get('rollback') else ''}: canonical "
                  f"params vs the dense reference {t['canonical_err']:.2e} "
                  f"(tol 1e-4)")
    check(sum(1 for t in runner.transitions if t.get("rollback")) == 1,
          "the SDC suspicion did not roll back")
    got_host = [_host_fields(h) for h in runner.history]
    check(got_host == want_host,
          f"host-side records differ from the CPU's: {got_host} {want_host}")
    check(decisions == want_decisions,
          "power decisions differ from the CPU's")
    print(f"  kernels {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in TRACE_KERNELS),
          f"a kernel of the trace path never launched: {launches}")
    regimes = {}
    for regime, ms in step_ms:
        regimes.setdefault(regime, []).append(ms)
    for regime, v in regimes.items():
        print(f"  step ms, {regime}: " + ", ".join(f"{t:.1f}" for t in v)
              + f" (mean {statistics.mean(v):.1f})")
    for name in ("train.goodput", "train.goodput_unboosted"):
        v = [e["value"] for e in rec.sinks[0].events(kind="gauge", name=name)]
        print(f"  {name}: mean {statistics.mean(v):.4f} over {len(v)} steps: "
              + ", ".join(f"{x:.3f}" for x in v))
    summ = runner.summary()
    summ["final_plan"] = summ["final_plan"].replica_tp
    print(f"  TraceRunner.summary(): {summ}")
    snap_ms = timed(session.snapshot)[1]
    roll_ms = timed(session.rollback)[1]
    print(f"  snapshot {snap_ms:.1f} ms, rollback {roll_ms:.1f} ms, "
          f"snapshot {snap_bytes} B in host memory; checkpoint {ckpt}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    del runner, session, rec, decisions, real_step, real_apply, step, apply
    gc.collect()          # the step/apply wrappers close over the session
    torch.cuda.empty_cache()

    # the same schedule again, verify off, timed: host syncs outside the
    # transitions come from the drain (one per drain_every steps)
    session = new_session()
    runner = TraceRunner(session, schedule, drain_every=16)
    syncs = {}
    (_, ms) = timed(lambda: syncs.update(syncs_outside_apply(
        torch, session, lambda: runner.run(lambda i: batches[i],
                                           TRACE_STEPS))))
    print(f"  timing run (verify off, drain_every 16): {ms:.1f} ms for "
          f"{TRACE_STEPS} steps and {len(schedule)} events; host syncs "
          f"{syncs['outside']} outside transitions ({syncs['where']}), "
          f"{syncs['inside']} inside them", flush=True)
    check(syncs["outside"] <= -(-TRACE_STEPS // runner.drain_every),
          f"host syncs outside transitions: {syncs['outside']}")
    sync = session.measure_sync(batches[0])
    print(f"  measure_sync at TP {session.plan.replica_tp}: "
          f"{sync['sync_s'] * 1e3:.3f} ms (CUDA events), "
          f"{sync['collectives']} collectives, overlap {sync['overlap']}",
          flush=True)
    del runner, session
    torch.cuda.empty_cache()
    return launches


def scratch_dir():
    """A fresh directory under the checkout's git-ignored `build/` (made if
    the checkout has none); the caller removes it."""
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(dir=root)


def checkpoint_round_trip(torch, session, cfg, dev, directory, new_plan):
    """Save the session's canonical checkpoint, restore it into a fresh
    session on the card under ``new_plan``: canonical params bit-identical.
    Returns a line of bytes and seconds."""
    from repro_torch import tree as tr
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    path = os.path.join(directory, "ckpt.npz")
    t0 = time.perf_counter()
    session.save(path)
    save_s = time.perf_counter() - t0
    n_bytes = os.path.getsize(path)
    fresh = NTPSession.create(cfg, (2, 4), plan=new_plan, local_batch=4,
                              optimizer=sgd(1e-2), overlap=True, device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = fresh.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    os.unlink(path)
    want = [t.cpu() for t in tr.leaves(session.canonical_params())]
    got = fresh.canonical_params()
    same = all(torch.equal(a.cpu(), b) for a, b in zip(tr.leaves(got), want))
    del fresh, got, want
    torch.cuda.empty_cache()
    check(same, "restored canonical params differ from the saving session's")
    check(step == session.opt_step, f"restored step {step}")
    return (f"at step {step}: {n_bytes} B written in {save_s:.1f} s, restored "
            f"into a fresh session at TP {new_plan.replica_tp} in "
            f"{restore_s:.1f} s, canonical params bit-identical")


def syncs_outside_apply(torch, session, fn):
    """Host syncs (CUDA sync debug mode's warnings) while ``fn`` runs,
    split into those inside ``session.apply`` and the rest, with the
    repository source lines (innermost two) of the rest."""
    import collections
    import traceback
    import warnings

    real = session.apply
    caught, inside = [], [0]

    def show(message, *_, **__):
        if "synchroniz" in str(message):
            caught.append(traceback.extract_stack()[:-1])

    def apply(ev):
        n0 = len(caught)
        out = real(ev)
        inside[0] += len(caught) - n0
        return out

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        session.apply = apply
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n0 = len(caught)     # (switching the mode warns once itself)
            fn()
            run = caught[n0:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
            del session.apply
    torch.cuda.synchronize()

    def where(stack):
        ours = [f for f in stack if "repro_torch" in f.filename
                or f.filename.endswith("chip_smoke.py")]
        return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                          for f in reversed(ours[-2:]))

    # an apply's syncs are all inside it; the rest came from elsewhere
    outside = [st for st in run if not any(
        f.name == "apply" and f.filename.endswith("chip_smoke.py")
        for f in st)]
    return {"inside": inside[0], "outside": len(outside),
            "where": dict(collections.Counter(
                where(st) for st in outside).most_common(4))}



def launcher_phase():
    """Phase 8: the training launcher at its defaults on the card, with an
    injected failure, then replaying phase 7's trace with checkpoints and a
    telemetry stream."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import main as train_main
    from repro_torch.telemetry import EVENT_KEYS, load_jsonl

    out = train_main(["--ntp", "--steps", "8", "--fail-at", "3",
                      "--overlap", "on", "--log-every", "1"])
    check(len(out["losses"]) == 8 and np.isfinite(out["losses"]).all(),
          "launcher: non-finite losses")
    check(out["plan"].replica_tp == (3, 4), f"launcher plan {out['plan']}")

    tmp = scratch_dir()
    try:
        ckpt, tel = os.path.join(tmp, "ckpt.npz"), os.path.join(tmp, "run.jsonl")
        out = train_main(["--ntp", *TRACE_LAUNCHER, "--ckpt", ckpt,
                          "--ckpt-every", "4", "--telemetry", tel,
                          "--steps", "12", "--overlap", "on",
                          "--log-every", "4"])
        check(np.isfinite(out["losses"]).all(), "launcher: non-finite losses")
        check(out["summary"]["rollbacks"] == 1,
              f"launcher: no SDC rollback {out['summary']}")
        tree, step = load_checkpoint(ckpt)
        check(step is not None and "params/embed" in tree
              and "opt/m/layers/0/wq" in tree,
              f"launcher checkpoint: step {step}, keys {sorted(tree)[:4]}")
        events = load_jsonl(tel)
        bad = [e for e in events
               if tuple(sorted(e)) != tuple(sorted(EVENT_KEYS[e["kind"]]))]
        check(events and not bad, f"telemetry events off the schema: {bad[:3]}")
        names = {e["name"] for e in events}
        check({"session.step", "session.transition", "orchestrator.event",
               "train.goodput", "kernels.dispatch"} <= names,
              f"telemetry names {sorted(names)}")
        print(f"  trace launcher: checkpoint at step {step} loads "
              f"({len(tree)} leaves), {len(events)} telemetry events on the "
              f"schema", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile_steps(torch, step, label, ticks=3, top=6, also=None):
    """Where a step's time goes: torch.profiler over ``ticks`` steps, device
    time per kernel name and the device's idle share of the (profiled)
    window; the ``top`` kernels by device time, and any kernel whose name
    holds ``also``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  profiled {label}s: {window_ms / ticks:.3f} ms per {label}, device "
          f"busy {busy_ms / ticks:.3f} ms per {label}, idle share "
          f"{1 - busy_ms / window_ms:.3f}")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top] + [e for e in ranked[top:]
                             if also is not None and also in e.key]:
        ms = e.self_device_time_total / 1e3 / ticks
        print(f"    {ms:8.3f} ms/{label}  {e.count // ticks:4d} launches/"
              f"{label}  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:44"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:132"),
    "reshard_pack": ("src/repro_torch/kernels/csrc/reshard_pack.cu",
                     "src/repro/kernels/reshard_pack.py:47"),
    "bucket_pack": ("src/repro_torch/kernels/csrc/bucket.cu",
                    "src/repro/kernels/bucket.py:73"),
    "bucket_unpack": ("src/repro_torch/kernels/csrc/bucket.cu",
                      "src/repro/kernels/bucket.py:95"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:89"),
}


def bucket_host_cost_against(torch, checkout):
    """`bucket_host_cost` of this checkout's bucket wrappers beside those
    of another checkout (its `src/repro_torch/kernels/bucket.py`, loaded
    against this checkout's kernel build; the kernel source must be the
    same), then exit."""
    import importlib.util

    from repro_torch.kernels import build

    path = os.path.join(checkout, "src/repro_torch/kernels/bucket.py")
    spec = importlib.util.spec_from_file_location("bucket_before", path)
    before = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(before)
    build.build_all()
    dev = torch.device("cuda")
    bucket_host_cost(torch, dev, torch.Generator(device=dev).manual_seed(0),
                     before)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    if sys.argv[1:2] == ["--bucket-host-cost-against"]:
        return bucket_host_cost_against(torch, sys.argv[2])
    import torch.nn.functional as F

    from repro_torch.kernels import build

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    print("phase 2: build kernels", flush=True)
    secs = build.build_all()
    print(f"  built {', '.join(build.SOURCES)} in {secs:.1f} s", flush=True)
    for name, info in build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    print("phase 3: kernels against their plain versions", flush=True)
    rows = kernel_phase(torch, F, dev)

    print("phase 4: serve full-size qwen2-7b through fail->repair", flush=True)
    reference_phase(torch, dev)
    serve_launches = serve_phase(torch, dev)
    torch.cuda.empty_cache()
    print(f"  device memory after freeing the served model "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    print("phase 5: full-size mamba2-780m: batched prefill through ssd_scan, "
          "serving through fail->repair", flush=True)
    mamba_launches = mamba_phase(torch, dev)
    check(all(mamba_launches[k] > 0 for k in MAMBA_KERNELS),
          f"a kernel of the Mamba-2 path never launched: {mamba_launches}")
    mamba_launcher_phase()
    torch.cuda.empty_cache()

    print("phase 6: train the NTP prototype at qwen2-7b widths through "
          "fail->repair", flush=True)
    train_launches = train_phase(torch, dev)

    print("phase 7: trace-driven NTP-PW training at qwen2-7b widths through "
          "failure, link, SDC quarantine and straggler", flush=True)
    trace_launches = trace_phase(torch, dev)

    print("phase 8: the training launcher", flush=True)
    launcher_phase()

    paths = ((serve_launches, SERVE_KERNELS), (train_launches, TRAIN_KERNELS),
             (mamba_launches, MAMBA_KERNELS),
             (trace_launches, TRACE_KERNELS))
    table = []
    for name, (src, replaces) in SOURCES.items():
        n = sum(counts[name] for counts, kernels in paths if name in kernels)
        table.append(dict(name=name, route="cuda", source=src,
                          replaces=replaces, launches=n, **rows[name]))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
