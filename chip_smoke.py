#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --gloo-probe`` instead times a 512 MB gloo
all-reduce of CUDA and of CPU tensors and a 512 MB all-to-all between 2
and among 4 processes on the card, and exits.)

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
   (one layer's leaves at pp=1, one stage's two layers' leaves at pp=2)
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
   split + .contiguous()), 3 rounds, medians: the call ms (back-to-back
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
   as phase 4 on the model's first `MAMBA_SERVE_LAYERS` (8) layers (a
   served tick costs host time a layer, and the script has a time limit;
   24 of 24
   token streams identical through TP 4→3→2→3→4, reshard_pack launched on
   the ssm_head reshards, bytes equal to moved heads x head bytes), the
   full model's decode tick timed and profiled, and
   the launcher twin `repro_torch.launch.serve_decode --arch mamba2-780m
   --full --batch 4 --prompt-len 2048 --new 32`;
6. train the NTP prototype at qwen2-7b's widths (d_model 3584, 4 kv-groups
   of 7 query heads, head_dim 128, d_ff 18944, vocab 152064; depth cut to
   2 layers) on 2 emulated DP replicas x TP 4, local batch 4, sequence 256,
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
7. replay a mixed failure trace against the same model at depth 2
   (`TRACE_LAYERS`; one session, TP 4
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
   canonical checkpoint (about 5 GB, under `build/`) saved and restored
   into a fresh session under the live plan, bit-identical. Printed: step
   ms per regime (healthy, degraded at TP (3, 4), repriced, quarantined),
   each event's apply ms and bytes, snapshot and rollback ms, the
   snapshot's host bytes, the goodput gauges, `TraceRunner.summary()`,
   peak memory; then the schedule again with verify off, timed, with the
   host syncs outside the transitions (at most one per `drain_every`
   steps, the metrics drain);
8. pipeline parallelism at pp=2 (stages (0, 1, 2)) on the same model at
   depth 2 (`PP2_LAYERS`), mesh, batch and SGD: (a) two sessions,
   overlap off with microbatches 1 and overlap on with microbatches 2, in
   lockstep with the dense reference on the card through the
   stage-addressed chain of
   tests/dist/session_pp_lifecycle.py (14 steps: stage 1 fails at 2, stage
   0 at 5, stage 1 repaired at 8, stage 0 at 11): every loss within 1e-4
   of the reference and 1e-5 between the sessions, both replicas'
   canonical params within 1e-4 at every transition and the end, every
   ledger stage-local and equal to `expected_transfer` of the hit stage,
   stage_tp / local batches / stage_rel_iter_time / rel_iter_time and
   `step.collectives` equal to the chain on the CPU, reshard_pack,
   bucket_pack and bucket_unpack launched; printed: step ms and
   reshard_pack launches a step by regime, each transition's ms and bytes
   beside phase 6's, then with the reference freed the step ms of overlap
   off/on x microbatches 1/2 at each plan in turns, `measure_sync` at each
   plan, and a profile of one stage-1-degraded step; (b) the pp=2 trace
   (`TRACE_PP`, pinned by tests/test_torch_staged.py: 2 replicas x 2
   stages x TP 4, a failure and its repair, a link degrade and its repair,
   an SDC suspicion that rolls back to the step-0 snapshot, a straggler)
   under NTP-PW with quarantine, overlap on, microbatches 2, through
   `TraceRunner(verify=True, atol=1e-4)`, with phase 7's checks and
   printout (no checkpoint round trip: phase 7 holds it);
9. run the training launcher at its defaults on the card: `--ntp --steps 8
   --fail-at 3 --overlap on`, then `--pp 2 --microbatches 2 --fail-stage
   1`, then phase 7's trace with `--power-policy ntp_pw --ckpt ...
   --ckpt-every 4 --telemetry ... --steps 12`: the checkpoint loads and
   every telemetry event is on the schema; then `--nproc 4 --mesh 2x2
   --backend gloo --steps 8 --fail-at 3` (four processes on this card) and
   `--nproc 8 --pp 2 --mesh 2x2 --microbatches 2 --fail-stage 1 --seq-len
   64 --batch 2` (the README's staged mesh of eight processes);
10. ranks as processes: the training cell's model at qwen2-7b widths,
   its depth cut from phase 6's 2 layers to 1 (gloo's host staging makes
   a process step 20-40 times the emulated one, and the script has a time
   limit), on a (2, 2) mesh of 4 processes (`launch.spawn`, gloo, every
   rank on cuda:0), SGD lr 1e-2, local batch 4, sequence 256, 2 steps,
   `FailureEvent(replica=1)` before step 0 (TP (1, 2)) and its repair
   before step 1. The emulated (2, 2) session runs first on the same seed,
   chain and batches, its canonical params written under `build/` after
   each transition and at the end; the card is freed and the 4 ranks are
   spawned (`PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`). Each rank
   first runs the raw gloo collectives of the path on CUDA tensors (a
   refusal fails the phase), then the chain. Checks: every rank's loss
   within 1e-5 of the emulated; rank 0's canonical params, gathered over
   its model group, within 1e-4 after each transition and at the end;
   each transition's bytes equal to `expected_transfer`, one all-to-all a
   rank; reshard_pack launched on degraded steps only. Printed: the card's
   compute_mode, step ms by regime (max over ranks) beside the emulated
   step, each transition's ms and bytes, rank 0's collective calls and
   bytes a step, each rank's peak memory, what gloo staged (nothing).
   (c) The lifecycle over processes: the same model, mesh, batch and SGD
   with overlap on, `power_policy("ntp_pw")` and quarantine, a snapshot at
   step 0, through `LIFE_STEPS` (3) steps of `_life_chain` (replica 1
   fails, a link degrades and a domain straggles after the snapshot, an
   SDC suspicion rolls back to the snapshot under TP (1, 2), then the
   clears and the repairs), first as the
   emulated (2, 2) session in this process (its canonical params at step
   0 and at the end under `build/`), then as 4 spawned ranks. Checks:
   every rank's loss within 1e-5 of the emulated;
   every step's local batches and `PowerDecision` equal; every ledger
   equal to the emulated and to `expected_transfer`; rank 0's canonical
   params right after the rollback bit-identical to step 0's, at the end
   within 1e-4 of the emulated; bucket_pack and bucket_unpack launched
   once a bucket on every step by every rank, reshard_pack on degraded
   steps only. Printed: step ms by regime (max over ranks) beside (b)'s,
   the per-leaf and bucketed syncs alone on the degraded plan, apply ms
   per event, snapshot and rollback ms and host bytes a rank, collective
   calls and bytes a step, peak memory a rank, the part's seconds.
   Then the per-rank reshard_pack (one rank's MLP gradient leaf under the
   degraded plan's pre-sync tables) against its plain version, timed in
   turns with `src[idx]` and `index_select`, and the per-rank
   bucket_pack / bucket_unpack (one rank's MLP bucket under that plan)
   against theirs, `torch.cat` and `split` + `.contiguous()`;
11. pp=2 ranks as processes, through `launch.profile.measure`: the model
   at qwen2-7b widths with one layer a
   stage on a pp=2 x (2, 2) staged mesh (`launch.mesh.make_staged_mesh`)
   of 8 processes, gloo, all on cuda:0, each holding its stage's share
   (`embed` on stage 0, `head` and `final_norm` on stage 1), each capped at
   its stage's `PP_RANKS_MEMORY_SHARE` of the card; SGD lr 1e-2, local batch 4,
   microbatches 2, sequence 256, overlap on;
   `FailureEvent(replica=1, stage=1)` (stage 1 to TP (1, 2), stage 0
   untouched) and one step, the repair and one step (the profile's two
   warm-up steps), then one timed healthy step, each step timed with CUDA
   events, the timed one under `torch.profiler` (a Chrome trace of the
   emulated session and one of global rank 0), and each session's
   `measure_sync`. The emulated pp=2
   session runs first on the same seed, chain and batches and is freed
   before the spawn. Checks: every process's loss within 1e-5 of the
   emulated, local batches equal; each transition's ledger equal to the
   emulated and its bytes to `expected_transfer`, stage 0's processes
   sending nothing and stage 1's one all-to-all each; every step's
   hand-off bytes (summed over the processes) equal to
   `handoff_accounting`; each stage's canonical params within 1e-5 of the
   emulated at the end; bucket_pack / bucket_unpack once a bucket a step
   on every process, reshard_pack on stage 1's degraded steps only.
   Printed: the profile's lines (step ms, the bubble factor against
   (m+pp-1)/m, the sync probes, ticks and the hand-off table), the
   traces' size and the emulated step's top five device ops, step ms by
   regime, each transition's ms and bytes by stage, the launches by
   process, peak device memory and host RSS at the end by process (the
   per-rank reshard_pack and bucket kernels run at phase 10's shape and
   are held and timed there);
12. NTP with the expert as the partition unit (MoE), and the MoE FFN:
   (A) the prototype at llama4-scout's widths (d_model 5120, 8 kv-groups
   of 5 query heads, head_dim 128, 16 experts of d_ff 8192, top-1, vocab
   202048; depth cut to 1 layer), 2 emulated replicas x TP 4, local batch
   2, sequence 256, SGD, overlap off, a fail before step 2 and its
   repair before step 4 over 6 steps: the dense reference runs first and alone (its losses and final
   params kept on the host), then the session, with expandable segments.
   Checks: losses within 1e-4 of the reference, both replicas' canonical
   params within 1e-4, the router unchanged (top-1), each transition's
   bytes, units and messages as its plans', reshard_pack on the degraded
   steps only. Printed: step ms and peak allocated memory by regime, each
   transition's ms and bytes. Then reshard_pack at the expert unit (one
   row = 41,943,040 f32), timed in turns against `src[idx]` and
   `index_select`. (B) the prototype at arctic-480b's widths (d_model
   7168, 8 kv-groups of 7, head_dim 128, d_ff 4864, the reference's
   `reduced()` 4 experts top-2, vocab 32000; 1 layer at pp=1, 2 at pp=2,
   one a stage) on (2, 2), local batch 4, sequence 256, SGD: the dense
   reference alone, then the emulated pp=1 sessions (overlap on, off)
   through a fail before step 0 and the repair before step 1 (2 steps),
   then 4 gloo processes on cuda:0 (overlap on); then the emulated pp=2
   session (microbatches 2,
   overlap on) and 8 processes on `make_staged_mesh(2, 2, 2)` through
   the same chain on stage 1. Checks: losses 1e-4 from the reference and
   1e-5 between the routes, canonical params 1e-4, the routers within
   1e-6 of the emulated session's and moved by more than ten times that,
   ledgers as the plans', bucket_pack / bucket_unpack / reshard_pack
   launches a process a step as predicted. (C) `models/mlp.py`'s
   `moe_apply` at llama4-scout's FFN widths (gated SiLU, shared expert;
   8.6 GB f32) on 8 x 16 tokens against `moe_apply_dense_ref` at capacity
   8.0 (1e-4), and the slots dropped at 1.25;
13. MoE serving at full width, f32, weights from seed 0 on the card, one
   model at a time: llama4-scout (4 layers, one period of its pattern: 3
   `attn_chunked` (chunk 8192) and 1 global, 16 experts of d_ff 8192 top-1
   with the shared expert, vocab 202048; 43.5 GB), its first layer first
   held against the CPU's plain versions (a 32-token prefill and two
   decode steps, 1e-4); then arctic-480b (1 layer, all 128 experts of
   d_ff 4864 top-2 with the dense residual FFN; 56.3 GB). Each serves
   phase 4's sessions and traffic (two sessions sharing one weight copy,
   TP 4→3→2→3→4 with preemptions) at (a) a drop-free capacity factor E/k
   (a check, not a default): 24 of 24 streams equal to the uninterrupted
   run's and no prefill drops a slot; (b) the published 1.25: every
   request complete with 16 tokens, the dropped prefill slots and equal
   streams printed (a preempted request re-prefills its generated tokens,
   which then compete for capacity); every transition's bytes equal to its
   plan's KV heads times a head's bytes over every cache group; (c) a
   decode tick at 8 slots (CUDA events, torch.profiler) beside the
   every-weight and picked-experts floors. rmsnorm, flash_attention (with
   the chunked and the causal mask, counted by kind) and reshard_pack
   must launch in (b)'s fail→repair runs. Then flash_attention at both
   models' prefill shapes and reshard_pack at their KV-head rows against
   their plain versions and library calls;
14. the global repack allocator (`repro_torch.cluster.GreedyAllocator`):
   the training cell's model at pp=2 (qwen2-7b widths, 4 layers, stages
   (0, 2, 4), 2
   replicas x TP 4, local batch 4, sequence 256, SGD lr 1e-2, f32) with one
   spare domain, overlap on, microbatches 2, through the chain of
   tests/dist/session_allocator_lifecycle.py (`ALLOC_CHAIN`, 12 steps: fail
   (stage 1, domain 0) at 2, fail (stage 0, domain 1) at 5, repair (1, 0)
   at 8, repair (0, 1) at 11) under `TraceRunner(verify=True, atol=1e-4)`
   with the dense reference on the card. Checks: every loss and the
   canonical params at both transitions within 1e-4; at step 2 the spare
   stands in (plan pristine, 0 bytes, no transition); at 5 it relocates to
   (0, 1) and only stage 1 repacks, the moved, priced and ledger stages
   all {1}, predicted bytes equal to the executed ledger and below the
   dense bytes; at 8 likewise, stage 1 up; at 11 nothing moves; every
   decision rescued or amortized; each verdict's counts, spare sites,
   swaps, per-stage TPs and moved stages equal to the chain's on the CPU
   (`_alloc_host_verdicts`, pinned by tests/test_torch_allocator.py) and
   its predicted bytes to the card session's cost model; bucket_pack /
   bucket_unpack launched on every step and in the transitions at 5 and 8
   (their fused messages) and nothing in the applies at 2 and 11,
   reshard_pack on the degraded steps (5-7) only; the recorded telemetry,
   folded by `launch.telemetry_report`, one (predicted, executed)
   `cluster.transition_bytes` pair per moving event, equal. Printed: each
   event's verdict, its apply ms (CUDA events), executed bytes and the
   cost model's `seconds()` at its 9e11 B/s (a model parameter, not this
   card's rate), step ms by regime, peak device memory;
15. the serving lifecycle and the dense attention archs, one model on the
   card at a time, f32, weights from seed 0: (A) gemma2-9b at full width
   (22 of its 42 layers, alternating sliding 4096 and global attention,
   d 3584, 16 heads of 256, 8 KV heads, softcaps 50 / 30, post-norms,
   tied vocab 256,000; 5,277,801,984 params, 21.11 GB), its first two
   layers held against the CPU's plain versions (1e-4); two replicas x n1
   4, 8 slots, max_len 96, prefill 32, NTP-PW, quarantine on; 32
   requests (24 + 16 tokens, four a tick over ticks 0-7) through
   `DENSE_CHAIN` (failure of domain 0 at tick 4, a 1.5x straggler on
   domain 1 at 6, an SDC
   suspicion on domain 1 at 8, a checkpoint at 10, a link at half
   bandwidth on domain 0 at 12, the clears at 14, 16 and 17, the repair
   at 18) with telemetry recorded, beside an uninterrupted session on the
   same weights. Checks: every stream equal; degradations preempt
   nothing; replica 1 drains and admits nothing over ticks 8-13; each
   reshard's bytes as its plan's KV heads; the telemetry fold
   (`launch.telemetry_report`) has TTFT/TPOT and admissions of every
   request and one `serve.transition` span an event. The restore check:
   a third session on the weights takes `FailureEvent(domain=1)` (TP (4,
   3)), restores the tick-10 checkpoint (saved without the weights) and
   serves its slots, what it returns and the requests queued at the save
   to the end, streams equal to the uninterrupted run. A decode tick (8
   slots) timed and profiled beside the weight-read floor. (B)
   granite-3-2b (head_dim 64), minitron-4b (squared ReLU) and
   chameleon-34b (qk-norm) at full width, depth cut to 2, each held
   against the CPU's plain versions and serving 8 requests through fail
   -> repair with streams equal to an uninterrupted run. rmsnorm,
   flash_attention (sliding and causal) and reshard_pack must launch.
   Then flash_attention at gemma2's prefill (D 256, softcap 50, sliding
   and global, against a compiled `flex_attention`) and granite's (D 64,
   against SDPA), each row with its own launches on the path;
16. the recurrent and encoder-decoder archs served at full size, one
   model on the card at a time, f32, weights from seed 0, each on one
   replica x n1 4, 8 slots, max_len 64, prefill 16, NTP-PW, with 12
   requests (8 + 8 tokens, four a tick) through `HYBRID_CHAIN` (fail at
   ticks 3 and 5, repair at 9 and 11: TP 4→3→2→3→4, with preemptions)
   beside an uninterrupted session on the same weights
   (`hybrid_model_part`): (A) recurrentgemma-9b (38 layers of (rglru,
   rglru, attn_sw), two of them tail layers; d 4096, 16 heads of 256, one
   KV head, sliding 2048, RG-LRU width 4096 in 32 blocks of 128, GeGLU
   d_ff 12,288, tied vocab 256,000; 34.21 GB), admitted token by token,
   its first three layers held against the CPU's plain versions (logits
   within max(1e-4, 5e-6 x max |logit|));
   (B) whisper-small (12 encoder + 12 decoder layers, d 768, 12 heads of
   64, LayerNorm, pos_embed 65,536 x 768, GELU, tied vocab 51,865), each
   request with a seeded (1500, 768) `enc_input`, its encoder and first
   decoder layer held against the CPU. Checks: 12 of 12 streams equal;
   each transition's bytes equal to its plans' units (gate blocks over
   h/conv, KV heads over the rings, encoder heads over ek/ev) times a
   unit's bytes; each model's kernels launched in its chain run ((A)
   rmsnorm and reshard_pack, (B) reshard_pack and flash_attention bidir
   and causal, counted by kind). Printed: the peak memory of each stage,
   one admission's ms, (A)'s decode tick (8 slots) timed and profiled
   beside the weight-read floor.
   Then flash_attention at whisper's encoder (q (1, 12, 1500, 64), bidir,
   f32) against its plain version and SDPA, with its launches on the path;
17. train the uniform arch stack (`train.steps.make_setup`,
   `NTPSession.from_arch`; f32, weights from seed 0, AdamW at a constant
   rate, remat on), one model on the card at a time: (A) qwen2-7b at full
   width (d 3584, 28 heads of 128, 4 KV heads, QKV bias, SwiGLU 18,944,
   untied vocab 152,064; depth cut to 2: 1,556,138,496 params, about
   24.9 GB with grads and AdamW's moments), 6 steps at 4 x 256 of the
   synthetic stream; (B) mamba2-780m at full size (48 layers), 3 steps at
   2 x 512; (C) whisper-small at full size, 2 steps at 2 x 64, each row
   with a seeded (1500, 768) `enc_input`. Checks: (i) step 0's gradient
   finite and not all zero in every leaf (the training route computes in
   plain ops: no leaf may lose its gradient to a forward-only kernel);
   (ii) `Model.forward`'s last logits equal `make_setup(prefill)`'s (the
   served model's rmsnorm and flash_attention, ssd_scan for (B), which
   must launch) within max(1e-4, 5e-6 x max |logit|) (5e-4 for (B)); and
   for (A): (iii) step 0's loss and grad_norm at depth 1 on a 1 x 64
   batch equal the CPU's within the same rule; (iv) a microbatches=2 step
   equals the plain step (params 1e-5) and (v) remat off equals remat on
   (params 1e-6), both from the seed-0 weights at AdamW rate 1e-6, their
   first moments compared too; (vi) the loss at step 5 below step 0's.
   The training steps launch no kernel. Printed: losses, step ms (CUDA
   events), peak allocated memory, and (A)'s profiled step with its idle
   share;
18. sharded execution of the uniform arch stack (`make_setup` on a
   `launch.mesh.RankMesh`): qwen2-7b at full width, depth cut to 2 (as
   17 (A)), f32, weights from seed 0. The parent first runs the
   one-device step for 2 steps at 4 x 256 (AdamW at 1e-6, constant),
   then a prefill of 4 x 64 seeded tokens and 8 greedy decode steps on the
   trained weights, writes those weights under `build/` (one .npy a
   leaf) and frees the card; then 4 gloo processes on cuda:0, a (2, 2)
   mesh (`NTPSession.from_arch(mesh)`: each draws the seed-0 weights and
   keeps its shards), take the same 2 steps and the same prefill and
   greedy decode, sharded. Checks: every process's loss within 1e-5 and
   grad_norm within 1e-5 relative of the one-device step's; its param
   shards within 2e-6 of the slices of the one-device params; every
   leaf's first moment after step 0 finite and nonzero (a gradient in
   every leaf); prefill logits within max(1e-4, 5e-6 x max |logit|) and
   the 8 greedy tokens equal; the training steps launch no kernel, every
   process's prefill launches rmsnorm and flash_attention and its decode
   rmsnorm. Printed: step ms (max over processes) beside the one-device
   step, process (0, 0)'s collective calls and bytes a step by (op,
   group), each process's peak allocated memory, the phase's seconds;
19. the dry-run (`launch.dryrun`, two processes of their own started
   before the build, each a fake world of the counting-only `fake`
   process groups on meta tensors): (a) for each process of phase 18's
   (2, 2) mesh, the predicted (calls, bytes) of every (op, group) equal
   to what that process executed in each train step, the prefill and the
   first decode step; (b) phase 17 (A)'s one-device meta FLOPs equal to
   `FlopCounterMode`'s count of its plain step on the card, and the f32
   roofline share (compute seconds at 67 TFLOP/s over the measured step);
   (c) gemma2-9b train_4k's record at the 16 x 16 mesh, ok on 256 chips;
   (d) a meta call of each kernel launches nothing, returns the kernel's
   output shape and dtype and counts its cost function's work;
20. print the kernels table as one JSON line (launches summed over the
   serving, Mamba-2, training, trace, pp=2, process, pp=2 process, MoE, MoE
   serving, allocator, dense serving, hybrid serving, arch-training
   prefill and sharded arch-stack prefill and decode paths, each counted
   from zero just before it), then the device line.

``python3 chip_smoke.py --gloo-probe`` times gloo alone on the card and
reports which tensors its point-to-point `send`/`recv` take.
``python3 chip_smoke.py --moe`` builds the kernels and runs phase 12
alone (``--pp-ranks`` phase 11, ``--moe-serve`` phase 13, ``--allocator``
phase 14, ``--dense-serve`` phase 15, ``--hybrid-serve`` phase 16,
``--arch-train`` phase 17, ``--arch-ranks`` phase 18).
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
# the allocator settings of every rank the script spawns on the card:
# expandable segments (the ranks share the card, no room for
# fragmentation), and the pinned host blocks gloo stages CUDA tensors
# through taken by malloc and registered by 8 threads (a rank's first
# steps pin GBs of them)
RANK_ALLOC_CONF = ("expandable_segments:True,"
                   "pinned_use_cuda_host_register:True,"
                   "pinned_num_register_threads:8")
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


def bound_ms(cost, dtype_name):
    """The least ms the card could take for a kernel call of ``cost`` (the
    `kernels.mode.Cost` from the cost function beside its wrapper, which
    the dry-run counts too): its bytes over HBM's rate or its operations
    over the peak for ``dtype_name``, whichever is larger, and which."""
    t_bytes = cost.bytes / MEM_BW
    t_ops = cost.flops / PEAK[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, F, dev):
    """Phase 3. Returns {name: table row at the main path's shape}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cost

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
            b = bound_ms(rmsnorm_cost(n, d, x.element_size()), dn)
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
            row = flash_row(torch, F, dev, g, dt, (1, 28, 4, s, 128), kind,
                            window=window)
            if s == 32 and dt == torch.float32:
                rows["flash_attention"] = row
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


def flash_row(torch, F, dev, g, dt, shape, kind, window=4096, chunk=8192,
              label="", softcap=None):
    """One flash_attention line of phase 3 at ``shape`` = (B, H, KVH, S,
    D): against the plain version, timed in turns with
    `F.scaled_dot_product_attention` (GQA by `enable_gqa`; a sliding or
    chunked mask passed as a boolean mask) — with a ``softcap``, which SDPA
    cannot apply, against `flex_attention` instead (`flex_yardstick`).
    Returns its table row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost)

    dn = str(dt).split(".")[1]
    b_, h, kvh, s, d = shape
    q = torch.randn((b_, h, s, d), generator=g, device=dev).to(dt)
    k = torch.randn((b_, kvh, s, d), generator=g, device=dev).to(dt)
    v = torch.randn((b_, kvh, s, d), generator=g, device=dev).to(dt)
    if softcap is not None:
        # scores scaled up so that the cap bites, as phase 3's softcap rows
        q, k = q * 4.0, k * 4.0
    kw = dict(kind=kind, window=window, chunk=chunk, softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    del got
    short = s <= 32
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                    10 if short else 1)
    qp = torch.arange(s, device=dev)
    mask = qp[None, :] <= qp[:, None]
    if kind == "sliding":
        mask &= qp[None, :] > qp[:, None] - window
    elif kind == "chunked":
        mask &= qp[None, :] // chunk == qp[:, None] // chunk
    elif kind == "bidir":
        mask |= True
    attn_mask = None if kind in ("causal", "bidir") else mask
    if softcap is None:
        libs = {"SDPA": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=kind == "causal",
            enable_gqa=True)}
    else:
        libs = flex_yardstick(torch, q, k, v, kind, window, chunk, softcap)
        for name, call in libs.items():
            lib_err = (call().float() - want.float()).abs().max().item()
            print(f"  {name} (the library yardstick, compiled) max_abs_err "
                  f"{lib_err:.3e} against the plain version", flush=True)
    del want
    t = in_turns(torch, lambda: flash_attention(q, k, v, **kw), libs,
                 reps=50 if short else 5, calls=20 if short else 3)
    cost = flash_attention_cost(b_, h, kvh, s, d, q.element_size(), kind,
                                window, chunk)
    check(cost.flops == 4 * d * int(mask.sum().item()) * b_ * h,
          f"flash_attention_cost's pairs differ from the {kind} mask's")
    bd = bound_ms(cost, dn)
    cap = "" if softcap is None else f" softcap {softcap:g}"
    report_turns("flash_attention", f"{label}q({b_},{h},{s},{d}) kv{kvh} "
                 f"{kind}{cap}", dn, err, TOL[dn], t, plain, bd)
    return table_row(err, t, plain, bd)


def flex_yardstick(torch, q, k, v, kind, window, chunk, softcap,
                   compiled=True):
    """A PyTorch call computing flash_attention with a ``softcap``:
    `flex_attention` (under `torch.compile`, as it is meant to run) with the
    softcap as its score_mod, the mask as a block mask and GQA by
    `enable_gqa`, at 16 x 16 blocks in one stage (at f32, D 256, S 32 its
    default kernel options run far slower on an H100 and take minutes to
    compile). Compiled and warmed here, outside any timing or graph capture. The
    mask's limits are a tensor, so every mask kind shares one compiled
    graph. Returns {name: call}. The port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    s = q.shape[2]
    lim = torch.tensor([window if kind == "sliding" else s + 1,
                        chunk if kind == "chunked" else s + 1],
                       device=q.device)

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        return ((ki <= qi) & (ki > qi - lim[0])
                & (ki // lim[1] == qi // lim[1]))

    block = create_block_mask(mask_mod, None, None, s, s,
                              device=str(q.device))
    fn = torch.compile(flex_attention, dynamic=False) if compiled \
        else flex_attention
    call = functools.partial(
        fn, q, k, v, score_mod=score_mod, block_mask=block, enable_gqa=True,
        kernel_options=dict(BLOCK_M=16, BLOCK_N=16, num_warps=4,
                            num_stages=1))
    call()
    return {"flex_attention 16x16": call}


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
            calls = [(f"{label} all {n} ranks", xp, idx, reshard_pack_ranks,
                      ref.reshard_pack_ranks_ref, range(n))]
            if one_rank:
                calls.append((f"{label} rank {rank}", xp[rank], idx[rank],
                              reshard_pack, ref.reshard_pack_ref, [rank]))
            for name, src, ix, kern, plain_fn, ranks in calls:
                row = reshard_call(torch, dev, name, src, ix, kern, plain_fn,
                                   send, tables.pad, ranks, dn)
                if label == "kv_head" and src.ndim == 3 and dt == torch.float32:
                    rows["reshard_pack"] = row
                torch.cuda.empty_cache()
            del xp, idx, calls, src, ix
            torch.cuda.empty_cache()


def reshard_call(torch, dev, name, src, ix, kern, plain_fn, send, pad, ranks,
                 dn):
    """One reshard_pack line of phase 3: the wrapper ``kern`` on ``src``
    (stacked (n, U+1, elems) or one rank's (U+1, elems)) and ``ix``,
    bit-exact against ``plain_fn``, timed in turns against advanced
    indexing (`src[idx]`, the plain version's own call, with the index
    already int64) and `index_select` (flat indices precomputed); the
    bound reads each unit row the ``ranks`` send once (``send``: the
    tables' send_idx, ``pad`` its pad id) and writes the send buffer.
    Returns its table row."""
    from repro_torch.kernels.reshard_pack import reshard_pack_cost

    got = kern(src, ix)
    torch.cuda.synchronize()
    want = plain_fn(src, ix)
    check(torch.equal(got, want), f"reshard_pack {name} {dn} is not bit-exact")
    del got, want
    plain = time_ms(lambda: plain_fn(src, ix), 10)
    lidx = ix.long()
    elems = src.shape[-1]
    if src.ndim == 3:
        n, up1 = src.shape[:2]
        rk = torch.arange(n, device=dev)[:, None, None]
        flat = (lidx + rk * up1).flatten()
        index = lambda: src[rk, lidx]                    # noqa: E731
        select = lambda: torch.index_select(             # noqa: E731
            src.view(-1, elems), 0, flat).view(*ix.shape, elems)
    else:
        flat = lidx.flatten()
        index = lambda: src[lidx]                        # noqa: E731
        select = lambda: torch.index_select(             # noqa: E731
            src, 0, flat).view(*ix.shape, elems)
    t = in_turns(torch, lambda: kern(src, ix),
                 {"src[idx]": index, "index_select": select},
                 reps=10, calls=4)
    n_read = sum(len({int(u) for u in send[r].flatten() if u != pad})
                 for r in ranks)
    bd = bound_ms(reshard_pack_cost(ix.numel(), elems, src.element_size(),
                                    n_read), dn)
    report_turns("reshard_pack",
                 f"{name} src{tuple(src.shape)} idx{tuple(ix.shape)}",
                 dn, 0.0, 0.0, t, plain, bd)
    return table_row(0.0, t, plain, bd)


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
         lambda: mode.device_kind(x, w, kernel="rmsnorm")),
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


def in_turns(torch, kern, libs, reps, calls, rounds=3):
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
    best = min((c for c, _ in libs.values()), default=None)
    versus = ("no library call" if best is None else
              f"call / library {kc / best:.3f}  call <= library: "
              f"{'yes' if kc <= best else 'NO'}")
    print(f"  {name:16s} {shape:44s} {dt:8s} max_abs_err {err:.3e} "
          f"(tol {tol:g})  call_ms {kc:.5f} device_ms {kd:.5f}  "
          + "  ".join(f"{k} call_ms {c:.5f} device_ms {d:.5f}"
                      for k, (c, d) in libs.items())
          + f"  plain_ms {plain:.5f}  bound_ms {bound[0]:.6f} ({bound[1]}, "
          f"{bound[0] / kd:.0%} of it on the device)  {versus}", flush=True)
    check(err <= tol, f"{name} {shape} {dt}: max_abs_err {err} > {tol}")


def table_row(err, t, plain, bound):
    """The kernels-table entry of a kernel timed in turns: its median call
    ms, and the fastest yardstick's as the library time."""
    return dict(max_abs_err=err, ms=t["kernel"][0], plain_ms=plain,
                library_ms=min((c for k, (c, _) in t.items()
                                if k != "kernel"), default=None),
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
    qwen2-7b widths), one launch per bucket — one layer's leaves at pp=1,
    one stage's two layers' leaves at pp=2; bit-exact against the plain
    versions, timed in turns with `torch.cat` and `split` + `.contiguous()`
    (call ms and device ms)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket import (bucket_cost, bucket_pack,
                                            bucket_unpack)

    bucket_host_cost(torch, dev, g)
    attn = (3584 * 896, 3584 * 128, 3584 * 128, 896 * 3584)   # wq wk wv wo
    mlp = (3584 * 128, 128 * 3584)                             # A B
    cases = [("MLP TP (3,4)", 400, mlp), ("MLP healthy", 296, mlp),
             ("attn healthy", 8, attn), ("attn TP (3,4)", 16, attn),
             ("pp2 stage MLP TP (3,4)", 400, mlp * 2),
             ("pp2 stage MLP healthy", 296, mlp * 2),
             ("pp2 stage attn healthy", 8, attn * 2),
             ("pp2 stage attn TP (3,4)", 16, attn * 2)]
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
            bd = bound_ms(bucket_cost(n_rows, sum(widths),
                                      flat.element_size()), dn)
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
                if label == "pp2 stage MLP TP (3,4)" and dt == torch.float32:
                    rows[f"{name} pp2"] = table_row(0.0, t, plain, bd)
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
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_cost
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
        L = min(chunk, s)
        bd = bound_ms(ssd_scan_cost(bh, groups, s, L, hp, ds), "float32")
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
    _sync(torch, session.device)
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
    _sync(torch, session.device)
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
    through fail->fail->repair->repair against an uninterrupted session,
    its depth cut to the first `MAMBA_SERVE_LAYERS` layers (a served tick
    costs host time a layer, and the script has a time limit); (e) times,
    profiles and peak memory, the decode tick of the full model. Returns the launch counts of (a)
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

    # (d) serving through fail->fail->repair->repair, depth cut
    kw = dict(replicas=1, n1=4, slots=8, max_len=96, prefill_len=32,
              policy="ntp_pw")
    full_cfg, full_params = cfg, params
    cfg = dataclasses.replace(cfg, n_layers=MAMBA_SERVE_LAYERS)
    params = dict(params, layers=params["layers"][:MAMBA_SERVE_LAYERS])
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
    print(f"  (d) fail->repair run, first {cfg.n_layers} of "
          f"{full_cfg.n_layers} layers: {len(got)} requests, {tokens} tokens in "
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
    del session, clean
    eng = ServeSession.create(full_cfg, params=full_params, **kw).engines[0]
    toks = torch.ones(8, dtype=torch.long, device=dev)
    pos = torch.arange(8, device=dev) + 40
    tick_ms = time_ms(lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                     toks, pos), 10)
    print(f"  decode tick (8 slots, full model, CUDA events): {tick_ms:.3f} ms")
    profile_steps(torch, lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                        toks, pos), "decode tick")
    del eng, params, full_params
    torch.cuda.empty_cache()
    return {k: run[k] + served[k] for k in run}


def mamba_launcher_phase():
    """(f) the launcher twin at the prefill shape."""
    from repro_torch.launch.serve_decode import main as decode_main

    out = decode_main(["--arch", "mamba2-780m", "--full", "--batch", "4",
                       "--prompt-len", "2048", "--new", "32"])
    check(out["tokens"].shape == (4, 32), "launcher: wrong token shape")


def qwen_widths(n_layers=4):
    """The NTP prototype at qwen2-7b's widths (d_model 3584, 4 kv-groups of
    7 query heads, head_dim 128, d_ff 18944, vocab 152064), depth cut to
    ``n_layers``: 4 in phase 14, 2 in phases 6-8, 1 in phase 10."""
    from repro_torch.core import ntp_train as nt

    return nt.NTPModelConfig(d_model=3584, n_kv_groups=4, q_per_kv=7,
                             head_dim=128, d_ff=18944, unit_rows=128,
                             vocab=152064, n_layers=n_layers)


SERVE_KERNELS = ("rmsnorm", "flash_attention", "reshard_pack")
TRAIN_KERNELS = ("bucket_pack", "bucket_unpack", "reshard_pack")
MAMBA_KERNELS = ("rmsnorm", "reshard_pack", "ssd_scan")
# phase 5 (d) serves the first 16 of mamba2-780m's 48 layers
MAMBA_SERVE_LAYERS = 8


def train_phase(torch, dev):
    """Phase 6. Returns the launch counts of the fail→repair training run
    and its transitions as (event, session, ms, bytes moved)."""
    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.optim import sgd
    from repro_torch.reshard.transition import expected_transfer
    from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

    cfg = qwen_widths(TRACE_LAYERS)
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

    transitions = []
    mode.reset_launches()
    for i in range(steps):
        if i in events:
            for name, s in sessions.items():
                old = s.plan
                new, ms = timed(lambda: s.apply(events[i]))
                st = s.last_transition
                transitions.append((type(events[i]).__name__, name, ms,
                                    st.bytes_moved))
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
    return launches, transitions


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
             "A": d * cfg.ffu, "B": cfg.ffu * d}[family]
    return elems * 4 * cfg.n_layers


TRACE_KERNELS = ("bucket_pack", "bucket_unpack", "reshard_pack")
# the mixed trace phase 7 replays (tests/test_torch_lifecycle.py pins it):
# failure -> link degrade -> link repair -> repair -> SDC suspect (rollback)
# -> clear -> straggler -> clear, over 16 steps of 2 replicas x TP 4
TRACE = dict(n_gpus=8, domain_size=4, days=16 / 1.0 / 24.0,
             rate_multiplier=200.0, seed=136, straggler_rate_mult=2.0,
             link_rate_mult=2.0, sdc_rate_mult=1.0)
TRACE_STEPS, TRACE_STEPS_PER_HOUR, TRACE_CKPT_STEP = 16, 1.0, 8
# the pp=2 trace phase 8 replays (tests/test_torch_staged.py pins it): 2
# replicas x 2 stages x TP 4; failure (stage 0) -> link degrade (stage 1)
# -> link repair -> repair -> SDC suspect (rollback) -> clear -> straggler
# (stage 1) -> clear, over 16 steps
TRACE_PP = dict(n_gpus=16, domain_size=4, days=16 / 1.0 / 24.0,
                rate_multiplier=100.0, seed=136, straggler_rate_mult=2.0,
                link_rate_mult=2.0, sdc_rate_mult=1.0)
TRACE_LAUNCHER = ["--trace", "200", "--trace-seed", "136", "--trace-mix",
                  "straggler=2,link=2,sdc=1", "--power-policy", "ntp_pw"]


def _host_decisions(torch, trace, pp, microbatches):
    """Per-step plans, local batches and policy verdicts of a trace's
    schedule through the port on the CPU (a small model of the same
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
                          device="cpu", overlap=True, pp=pp,
                          microbatches=microbatches,
                          generator=torch.Generator().manual_seed(0),
                          power_policy=power_policy("ntp_pw"))
    decisions = _record_decisions(s)
    runner = TraceRunner(s, schedule_from_trace(
        FailureTraceConfig(**trace), steps=TRACE_STEPS,
        steps_per_hour=TRACE_STEPS_PER_HOUR, pp=pp))
    runner.run(lambda i: torch.zeros((8, 17), dtype=torch.int64),
               TRACE_STEPS)
    return [_host_fields(h) for h in runner.history], decisions


def _host_fields(rec):
    return {k: rec.get(k) for k in ("replica_tp", "local_batches",
                                    "events_applied", "policy", "power_boost",
                                    "rel_iter_time", "quarantined",
                                    "stage_tp", "stage_rel_iter_time")}


def _record_decisions(session):
    """Wrap ``session.step`` so each step appends the session's
    `power_decision`; returns the list."""
    real, out = session.step, []

    def step(batch):
        out.append(session.power_decision)
        return real(batch)

    session.step = step
    return out


def _tp(plan):
    """A plan's TPs as printed: per stage at pp>1, per replica at pp=1."""
    return plan.stage_tp if getattr(plan, "pp", 1) > 1 else plan.replica_tp


def _regime(session):
    if session.quarantined:
        return "quarantined"
    h = session.health
    repriced = (any(st.degraded is not None for st in h.stages)
                if session.pp > 1 else h.degraded is not None)
    if repriced:
        return f"repriced (straggler/link) at TP {_tp(session.plan)}"
    if not session.plan.healthy:
        return f"degraded at TP {_tp(session.plan)}"
    return "healthy"


def _site(ev):
    return (f"stage {ev.stage} domain {ev.domain}" if ev.stage is not None
            else f"domain {ev.domain}")


def _expected_bytes(cfg, old, new):
    """Bytes a transition must move: `expected_transfer`'s units off the
    diagonal x their f32 bytes; at pp>1 summed over the stages whose plan
    changed, each over its own layers."""
    import numpy as np

    from repro_torch.configs.shapes import stage_boundaries
    from repro_torch.reshard.transition import expected_transfer

    if getattr(old, "pp", 1) == 1:
        return sum(int(m.sum() - np.trace(m)) * _unit_bytes(cfg, f)
                   for f, m in expected_transfer(cfg, old, new).items())
    b = stage_boundaries(cfg.n_layers, old.pp)
    return sum(
        int(m.sum() - np.trace(m)) * _unit_bytes(cfg, f) // cfg.n_layers
        * (b[s + 1] - b[s])
        for s in range(old.pp) if old.stages[s] != new.stages[s]
        for f, m in expected_transfer(cfg, old.stages[s],
                                      new.stages[s]).items())


def _changed_stages(old, new):
    return {s for s in range(old.pp) if old.stages[s] != new.stages[s]}


def replay_trace(torch, dev, cfg, trace, *, pp=1, microbatches=1,
                 ckpt_step=None):
    """Replay ``trace``'s schedule against one overlap-on session under
    NTP-PW with quarantine on, through `TraceRunner(verify=True,
    atol=1e-4)` with the dense reference on the card, and check and print
    it (phases 7 and 8). ``ckpt_step``: a canonical checkpoint round trip
    after that step. Returns (launch counts, schedule, batches)."""
    import gc
    import shutil

    from repro_torch import telemetry
    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.optim import sgd
    from repro_torch.runtime import (
        NTPSession, TraceRunner, event_kind, power_policy,
        schedule_from_trace,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lb, seq = 4, 256
    schedule = schedule_from_trace(FailureTraceConfig(**trace),
                                   steps=TRACE_STEPS,
                                   steps_per_hour=TRACE_STEPS_PER_HOUR, pp=pp)
    print("  schedule: " + "; ".join(
        f"step {e.step} {event_kind(e.event)} {_site(e.event)}"
        + (f" x{e.event.slowdown:.4f}" if hasattr(e.event, "slowdown")
           else f" bw {e.event.bw_frac:.4f}" if hasattr(e.event, "bw_frac")
           else "") for e in schedule), flush=True)
    want_host, want_decisions = _host_decisions(torch, trace, pp,
                                                microbatches)
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

    canon = nt.init_canonical(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    session = NTPSession.create(cfg, (2, 4), local_batch=lb,
                                optimizer=sgd(1e-2), params=canon,
                                overlap=True, device=dev, pp=pp,
                                microbatches=microbatches,
                                power_policy=power_policy("ntp_pw"),
                                quarantine=True)
    del canon
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
    ckpt = None
    mode.reset_launches()
    with telemetry.recording(rec):
        if ckpt_step is None:
            runner.run(lambda i: batches[i], TRACE_STEPS)
        else:
            ckpt_dir = scratch_dir()
            try:
                runner.run(lambda i: batches[i], ckpt_step)
                ckpt = checkpoint_round_trip(torch, session, cfg, dev,
                                             ckpt_dir, new_plan=session.plan)
                runner.run(lambda i: batches[i], TRACE_STEPS - ckpt_step)
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = mode.launches()
    for h in runner.history:
        print(f"  step {h['step']:2d}: tp {h['replica_tp']}"
              + (f" stages {h['stage_tp']}" if pp > 1 else "")
              + f" local batches {h['local_batches']} policy {h['policy']} "
              f"boost {h['power_boost']:.2f} rel_iter "
              f"{h['rel_iter_time']:.4f}"
              + (" stage_rel (" + ", ".join(
                  f"{r:.4f}" for r in h["stage_rel_iter_time"]) + ")"
                 if pp > 1 else "")
              + f" loss {h['loss']:.6f} reference {h['ref_loss']:.6f} "
              f"|diff| {abs(h['loss'] - h['ref_loss']):.2e}; "
              f"{step_ms[h['step']][0]}, {step_ms[h['step']][1]:.1f} ms",
              flush=True)
        check(pp == 1 or h["rel_iter_time"] == max(h["stage_rel_iter_time"]),
              f"step {h['step']}: rel_iter_time is not the slowest stage's")
    # every transition's ledger against expected_transfer, and the span
    spans = rec.spans("session.transition")
    check(len(spans) == len(applies), "a transition span is missing")
    for (ev, old, new, ms, st, rolled), sp in zip(applies, spans):
        line = (f"  apply {event_kind(ev)} {_site(ev)}: plan {_tp(old)} -> "
                f"{_tp(new)} in {ms:.3f} ms")
        if st is not None:
            want = _expected_bytes(cfg, old, new)
            line += (f", {st.bytes_moved} B in {st.messages} messages "
                     f"(expected {want} B)")
            check(st.bytes_moved == want,
                  f"transition ledger {st.bytes_moved} != {want}")
            check(all(sp["attrs"][k] == v for k, v in st.as_dict().items()),
                  f"span {sp['attrs']} != ledger {st.as_dict()}")
            check(pp == 1 or {k[0] for k in st.per_pair}
                  == _changed_stages(old, new),
                  f"transition not stage-local: {st.per_pair}")
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
    summ["final_plan"] = _tp(summ["final_plan"])
    print(f"  TraceRunner.summary(): {summ}")
    snap_ms = timed(session.snapshot)[1]
    roll_ms = timed(session.rollback)[1]
    print(f"  snapshot {snap_ms:.1f} ms, rollback {roll_ms:.1f} ms, "
          f"snapshot {snap_bytes} B in host memory"
          + (f"; checkpoint {ckpt}" if ckpt is not None else ""))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    del runner, session, rec, decisions, real_step, real_apply, step, apply
    gc.collect()          # the step/apply wrappers close over the session
    torch.cuda.empty_cache()
    return launches, schedule, batches


def trace_phase(torch, dev):
    """Phase 7. Returns the launch counts of the trace-driven run."""
    from repro_torch.core import ntp_train as nt
    from repro_torch.runtime import NTPSession, TraceRunner, power_policy
    from repro_torch.optim import sgd

    cfg = qwen_widths(TRACE_LAYERS)
    launches, schedule, batches = replay_trace(
        torch, dev, cfg, TRACE, ckpt_step=TRACE_CKPT_STEP)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    # the same schedule again, verify off, timed: host syncs outside the
    # transitions come from the drain (one per drain_every steps)
    canon = nt.init_canonical(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    session = NTPSession.create(cfg, (2, 4), local_batch=4,
                                optimizer=sgd(1e-2), params=canon,
                                overlap=True, device=dev,
                                power_policy=power_policy("ntp_pw"),
                                quarantine=True)
    del canon
    runner = TraceRunner(session, schedule, drain_every=16)
    syncs = {}
    torch.cuda.synchronize()
    start.record()
    syncs.update(syncs_outside_apply(
        torch, session, lambda: runner.run(lambda i: batches[i],
                                           TRACE_STEPS)))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
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
    del runner, session, batches
    torch.cuda.empty_cache()
    return launches


PP2_KERNELS = ("bucket_pack", "bucket_unpack", "reshard_pack")
PP2_STEPS = 14      # the chain of tests/dist/session_pp_lifecycle.py
# the lockstep chain's regimes by step
PP2_REGIMES = (("healthy", range(0, 2)), ("stage 1 degraded", range(2, 5)),
               ("both stages degraded", range(5, 8)),
               ("stage 0 degraded (stage 1 repaired)", range(8, 11)),
               ("repaired", range(11, 14)))


def _pp2_chain():
    """tests/dist/session_pp_lifecycle.py's stage-addressed chain: stage 1
    then stage 0 of replica 0 lose a GPU, then each is repaired."""
    from repro_torch.runtime import FailureEvent, RecoveryEvent

    return {2: FailureEvent(step=2, stage=1, domain=0),
            5: FailureEvent(step=5, stage=0, domain=0),
            8: RecoveryEvent(step=8, stage=1, domain=0),
            11: RecoveryEvent(step=11, stage=0, domain=0)}


def _pp2_fields(session, metrics):
    return {"stage_tp": session.plan.stage_tp,
            "local_batches": tuple(session.local_batches),
            "stage_rel_iter_time": metrics["stage_rel_iter_time"],
            "rel_iter_time": metrics["rel_iter_time"],
            "collectives": session.step_fn.collectives}


# phases 6-8 run the training cell's model at depth 2 (one layer a stage
# at pp=2): their trace replays and in-turns timings repeat the model many
# times, and the script has a time limit
TRACE_LAYERS = PP2_LAYERS = 2
PP2_SESSIONS = {"off": dict(overlap=False, microbatches=1),
                "on": dict(overlap=True, microbatches=2)}


def _pp2_host_chain(torch):
    """`_pp2_fields` of every step of the chain through the port on the CPU
    (a small model of the same geometry), for both lockstep sessions."""
    from repro_torch.core import ntp_train as nt
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    cfg = nt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=7,
                            head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                            n_layers=PP2_LAYERS)
    chain, out = _pp2_chain(), {}
    for name, kw in PP2_SESSIONS.items():
        s = NTPSession.create(cfg, (2, 4), local_batch=4, optimizer=sgd(1e-2),
                              device="cpu", pp=2,
                              generator=torch.Generator().manual_seed(0),
                              **kw)
        out[name] = []
        for i in range(PP2_STEPS):
            if i in chain:
                s.apply(chain[i])
            m = s.step(torch.zeros((8, 17), dtype=torch.int64))
            out[name].append(_pp2_fields(s, m))
    return out


def pp2_phase(torch, dev, pp1_transitions):
    """Phase 8. Returns the launch counts of the pp=2 runs (the lockstep
    chain and the trace)."""
    import gc

    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.core.overlap import chunk_ranges, sync_collectives
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.optim import sgd
    from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

    cfg = qwen_widths(PP2_LAYERS)
    lr, lb, seq = 1e-2, 4, 256
    chain = _pp2_chain()
    want = _pp2_host_chain(torch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sessions = {name: NTPSession.create(cfg, (2, 4), local_batch=lb,
                                        optimizer=sgd(lr), params=ref,
                                        device=dev, pp=2, **kw)
                for name, kw in PP2_SESSIONS.items()}
    torch.cuda.synchronize()
    bounds = (0, PP2_LAYERS // 2, PP2_LAYERS)
    check(all(s.stage_boundaries == bounds for s in sessions.values()),
          "stage boundaries")
    print(f"  (a) pp=2 (stages {bounds}) on 2 replicas x TP 4: sessions "
          f"overlap off/microbatches 1 and overlap on/microbatches 2, and "
          f"the dense reference on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * lb, seed=0))
    ref_loss = nt.make_reference_loss(cfg)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    def timed(fn):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def canonical_errs():
        errs = {}
        for name, s in sessions.items():
            for r in range(2):
                got = s.canonical_params(r)
                errs[(name, r)] = max(float((a - b).abs().max()) for a, b in
                                      zip(tr.leaves(got), tr.leaves(ref)))
                del got
        return errs

    step_ms = {n: [] for n in sessions}
    packs = {n: [] for n in sessions}
    applied = []
    mode.reset_launches()
    for i in range(PP2_STEPS):
        if i in chain:
            ev = chain[i]
            for name, s in sessions.items():
                old = s.plan
                new, ms = timed(lambda: s.apply(ev))
                st = s.last_transition
                want_b = _expected_bytes(cfg, old, new)
                stages = {k[0] for k in st.per_pair}
                applied.append((i, name, ev, old, new, ms, st))
                print(f"  step {i}: {type(ev).__name__} {_site(ev)} -> "
                      f"stages {new.stage_tp} [{name}]: transition "
                      f"{ms:.3f} ms, {st.bytes_moved} B moved "
                      f"({st.bytes_moved / 2**20:.1f} MiB) in {st.messages} "
                      f"messages, stages moved {sorted(stages)} (expected "
                      f"{want_b} B, stage {ev.stage} only)", flush=True)
                check(st.bytes_moved == want_b,
                      f"transition ledger {st.bytes_moved} != {want_b}")
                check(stages == {ev.stage},
                      f"transition not stage-local: {st.per_pair}")
            errs = canonical_errs()
            print(f"  step {i}: canonical params vs the dense reference "
                  "after the transition: " + ", ".join(
                      f"{n} replica {r} {e:.2e}" for (n, r), e in
                      errs.items()) + " (tol 1e-4)", flush=True)
            check(max(errs.values()) < 1e-4,
                  f"step {i}: canonical params diverged at the transition")
        tokens = pipe._batch_np(i)
        losses, fields = {}, {}
        for name, s in sessions.items():
            n0 = mode.launches().get("reshard_pack", 0)
            m, ms = timed(lambda: s.step(tokens))
            packs[name].append(mode.launches().get("reshard_pack", 0) - n0)
            losses[name] = float(m["loss"])
            step_ms[name].append(ms)
            fields[name] = _pp2_fields(s, m)
            check(fields[name] == want[name][i],
                  f"step {i} [{name}]: host records {fields[name]} differ "
                  f"from the CPU's {want[name][i]}")
            host = sync_collectives(
                cfg, s.plan, s.mode, bucketed=s.overlap,
                chunks=chunk_ranges(cfg.n_layers, 2) if s.overlap else None)
            check(s.step_fn.collectives == host,
                  f"step {i} [{name}]: collectives {s.step_fn.collectives} "
                  f"!= host count {host}")
            check(m["rel_iter_time"] == max(m["stage_rel_iter_time"]),
                  f"step {i}: rel_iter_time is not the slowest stage's")
        lbs = sessions["off"].local_batches
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
        f = fields["off"]
        print(f"  step {i}: stages {f['stage_tp']} local batches "
              f"{f['local_batches']} stage_rel_iter_time "
              f"{tuple(round(r, 4) for r in f['stage_rel_iter_time'])} "
              f"rel_iter_time {f['rel_iter_time']:.4f}; loss off "
              f"{losses['off']:.6f} on {losses['on']:.6f} reference "
              f"{rl:.6f}; |off-ref| {abs(losses['off'] - rl):.2e} |on-ref| "
              f"{abs(losses['on'] - rl):.2e} |on-off| "
              f"{abs(losses['on'] - losses['off']):.2e}; ms off "
              f"{step_ms['off'][-1]:.1f} on {step_ms['on'][-1]:.1f}; "
              f"collectives off {fields['off']['collectives']} on "
              f"{fields['on']['collectives']}; reshard_pack launches off "
              f"{packs['off'][-1]} on {packs['on'][-1]}", flush=True)
        check(np.isfinite([losses["on"], losses["off"], rl]).all(),
              "non-finite loss")
        check(abs(losses["on"] - rl) < 1e-4 and abs(losses["off"] - rl) < 1e-4,
              f"step {i}: loss off the dense reference")
        check(abs(losses["on"] - losses["off"]) < 1e-5,
              f"step {i}: the two sessions disagree")
    launches = mode.launches()
    print(f"  kernels {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in PP2_KERNELS),
          f"a kernel of the pp=2 path never launched: {launches}")
    check([s.plan.healthy for s in sessions.values()] == [True, True],
          "the chain did not end healthy")
    errs = canonical_errs()
    print("  canonical params vs the dense reference at the end: "
          + ", ".join(f"{n} replica {r} {e:.2e}" for (n, r), e in
                      errs.items()) + " (tol 1e-4)")
    check(max(errs.values()) < 1e-4, "canonical params diverged")
    for label, idx in PP2_REGIMES:
        print(f"  {label}: step ms " + "; ".join(
            f"overlap {n} (microbatches {PP2_SESSIONS[n]['microbatches']}) "
            + ", ".join(f"{step_ms[n][i]:.1f}" for i in idx)
            for n in sessions) + "; reshard_pack launches a step "
            + "; ".join(f"{n} " + ", ".join(str(packs[n][i]) for i in idx)
                        for n in sessions))
    for i, name, ev, old, new, ms, st in applied:
        print(f"  transition at step {i} [{name}]: {type(ev).__name__} "
              f"{_site(ev)}, {ms:.3f} ms, {st.bytes_moved} B")
    print("  beside phase 6's pp=1 transitions: " + "; ".join(
        f"{kind} [{name}] {ms:.3f} ms, {b} B"
        for kind, name, ms, b in pp1_transitions))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)

    # step ms of each (overlap, microbatches) at each plan, in turns, with
    # the reference freed; measure_sync at each plan; a profile of one step
    # with stage 1 degraded
    del ref
    torch.cuda.empty_cache()
    tokens = pipe._batch_np(PP2_STEPS)
    combos = [(o, m) for o in ("off", "on") for m in (1, 2)]
    plans = (("healthy", ()),
             ("stage 1 degraded", (FailureEvent(stage=1, domain=0),)),
             ("both stages degraded", (FailureEvent(stage=0, domain=0),)),
             ("repaired", (RecoveryEvent(stage=1, domain=0),
                           RecoveryEvent(stage=0, domain=0))))
    for label, evs in plans:
        for ev in evs:
            for s in sessions.values():
                s.apply(ev)
        steps = {}
        for o, m in combos:
            s = sessions[o]
            fn = nt.make_ntp_train_step(
                cfg, s.plan, (2, 4), mode=s.mode, local_batch=lb,
                optimizer=sgd(lr), microbatches=m, overlap=o == "on")
            steps[(o, m)] = (lambda fn=fn, s=s:
                             fn(s.params, s.opt_state, tokens))
            steps[(o, m)]()                              # warm-up
        turns = {c: [] for c in combos}
        for c in combos + combos[::-1]:
            turns[c].append(timed(steps[c])[1])
        sync = {n: s.measure_sync(tokens) for n, s in sessions.items()}
        print(f"  {label} (stages {sessions['off'].plan.stage_tp}) step ms "
              "in turns: " + "; ".join(
                  f"overlap {o} microbatches {m} " + ", ".join(
                      f"{t:.1f}" for t in turns[(o, m)])
                  for o, m in combos)
              + "; measure_sync " + "; ".join(
                  f"overlap {n} {v['sync_s'] * 1e3:.3f} ms "
                  f"({v['collectives']} collectives)"
                  for n, v in sync.items()), flush=True)
        if label == "stage 1 degraded":
            for name, s in sessions.items():
                profile_steps(torch, lambda: s.step(tokens),
                              f"stage-1-degraded step (overlap {name})",
                              ticks=1, top=8, also="pack_kernel")
        del steps
    del s, sessions
    gc.collect()
    torch.cuda.empty_cache()

    print("  (b) the pp=2 trace under NTP-PW with quarantine, overlap on, "
          "microbatches 2, TraceRunner(verify=True)", flush=True)
    trace_launches, _, _ = replay_trace(torch, dev, cfg, TRACE_PP, pp=2,
                                        microbatches=2)
    return {k: launches.get(k, 0) + trace_launches.get(k, 0)
            for k in set(launches) | set(trace_launches)}


# the chain of tests/dist/session_allocator_lifecycle.py (stage, domain):
# a stage-1 failure the spare stands in for, a stage-0 failure that makes
# the spare relocate (stage 1 repacks), and the two repairs
ALLOC_CHAIN = {2: ("fail", 1, 0), 5: ("fail", 0, 1), 8: ("repair", 1, 0),
               11: ("repair", 0, 1)}
ALLOC_STEPS = 12
ALLOC_KERNELS = ("reshard_pack", "bucket_pack", "bucket_unpack")


def _alloc_event(i):
    from repro_torch.runtime import FailureEvent, RecoveryEvent

    kind, stage, domain = ALLOC_CHAIN[i]
    cls = FailureEvent if kind == "fail" else RecoveryEvent
    return cls(step=i, stage=stage, domain=domain)


def _alloc_verdict(gp, moved):
    return {"counts": gp.counts, "spare_sites": gp.spare_sites,
            "swaps": gp.swaps,
            "stage_tp": tuple(p.replica_tp for p in gp.staged_plan.stages),
            "moved": moved}


def _alloc_host_verdicts(torch):
    """Each event's verdict fields (counts, spare sites, swaps, per-stage
    TPs, the stages its transition moved) of `ALLOC_CHAIN` through the
    port's emulated allocator session on the CPU, at phase 14's geometry
    (pp=2 over 4 layers, 2 replicas x TP 4, one spare) with a small model."""
    from repro_torch.cluster import GreedyAllocator
    from repro_torch.core import ntp_train as nt
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    cfg = nt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=7,
                            head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                            n_layers=4)
    s = NTPSession.create(cfg, (2, 4), local_batch=4, optimizer=sgd(1e-2),
                          device="cpu", pp=2, spares=1,
                          allocator=GreedyAllocator(),
                          generator=torch.Generator().manual_seed(0))
    out = []
    for i in sorted(ALLOC_CHAIN):
        old, before = s.plan, s.last_transition
        s.apply(_alloc_event(i))
        st = s.last_transition
        moved = (sorted({k[0] for k in st.per_pair})
                 if s.plan != old and st is not before else [])
        out.append(_alloc_verdict(s.last_global_plan, moved))
    return out


def allocator_phase(torch, dev):
    """Phase 14. Returns the launch counts of the allocator session's run."""
    import gc

    from repro_torch import telemetry
    from repro_torch.cluster import GreedyAllocator
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.launch import telemetry_report
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession, ScheduledEvent, TraceRunner

    cfg = qwen_widths()
    lb, seq = 4, 256
    want = _alloc_host_verdicts(torch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * lb, seed=0))
    batches = [torch.as_tensor(pipe._batch_np(i), device=dev)
               for i in range(ALLOC_STEPS)]
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

    def timed(fn):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    t0 = time.perf_counter()
    canon = nt.init_canonical(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    allocator = GreedyAllocator()
    session = NTPSession.create(cfg, (2, 4), local_batch=lb,
                                optimizer=sgd(1e-2), params=canon,
                                overlap=True, device=dev, pp=2,
                                microbatches=2, spares=1, allocator=allocator)
    del canon
    cost = allocator.cost
    print(f"  session (pp=2, overlap on, microbatches 2, one spare, "
          f"GreedyAllocator) in {time.perf_counter() - t0:.1f} s; cost model "
          f"per moved unit a layer {dict(cost.family_layer_bytes)} B, "
          f"scaleup_bw {cost.scaleup_bw:.3g} B/s (the model's parameter, "
          f"not a rate of this card)", flush=True)
    real_step, real_apply = session.step, session.apply
    steps, applies = [], []

    def step(batch):
        regime = ("healthy" if session.plan.healthy else
                  f"degraded at stages {session.plan.stage_tp}")
        n0 = mode.launches()
        out, ms = timed(lambda: real_step(batch))
        n1 = mode.launches()
        steps.append((regime, ms, {k: n1[k] - n0[k] for k in ALLOC_KERNELS}))
        return out

    def apply(ev):
        old, before = session.plan, session.last_transition
        n0 = mode.launches()
        out, ms = timed(lambda: real_apply(ev))
        n1 = mode.launches()
        st = session.last_transition
        applies.append((ev, old, out, ms,
                        st if st is not before else None,
                        session.last_global_plan,
                        {k: n1[k] - n0[k] for k in ALLOC_KERNELS}))
        return out

    session.step, session.apply = step, apply
    rec = telemetry.Recorder(sinks=[telemetry.MemorySink(maxlen=None)])
    schedule = [ScheduledEvent(i, _alloc_event(i)) for i in sorted(ALLOC_CHAIN)]
    runner = TraceRunner(session, schedule, verify=True, atol=1e-4)
    mode.reset_launches()
    with telemetry.recording(rec):
        runner.run(lambda i: batches[i], ALLOC_STEPS)
    launches = mode.launches()
    for h, (regime, ms, n) in zip(runner.history, steps):
        print(f"  step {h['step']:2d}: stages {h['stage_tp']} local batches "
              f"{h['local_batches']} loss {h['loss']:.6f} reference "
              f"{h['ref_loss']:.6f} |diff| "
              f"{abs(h['loss'] - h['ref_loss']):.2e}; {ms:.1f} ms; "
              f"launches {n}", flush=True)
        check(n["bucket_pack"] > 0 and n["bucket_unpack"] > 0,
              f"step {h['step']}: the bucket kernels did not launch")
        check((n["reshard_pack"] > 0) == (regime != "healthy"),
              f"step {h['step']}: reshard_pack launches {n['reshard_pack']} "
              f"at {regime}")
    check(len(applies) == len(ALLOC_CHAIN), "an event was not applied")
    for (ev, old, new, ms, st, gp, n), w in zip(applies, want):
        s = gp.summary()
        moved = sorted({k[0] for k in st.per_pair}) if st is not None else []
        print(f"  step {ev.step}: {type(ev).__name__} {_site(ev)} -> verdict "
              f"spares at {gp.spare_sites} swaps {gp.swaps} counts "
              f"{gp.counts} stage_tp {s['stage_tp']} goodput "
              f"{gp.goodput:.4f} (stage-local {gp.baseline_goodput:.4f}) "
              f"predicted {gp.predicted_bytes} B; apply {ms:.3f} ms"
              + (f", executed {st.bytes_moved} B ({st.bytes_moved / 2**20:.1f}"
                 f" MiB) in {st.messages} messages of dense "
                 f"{st.dense_bytes} B, stages {moved}; the cost model's "
                 f"seconds() at its 9e11 B/s {cost.seconds(st.bytes_moved) * 1e3:.3f}"
                 f" ms (a model figure, not this card's)"
                 if st is not None else ", no transition")
              + f"; launches {n}", flush=True)
        check(_alloc_verdict(gp, moved) == w,
              f"step {ev.step}: verdict {_alloc_verdict(gp, moved)} differs "
              f"from the CPU's {w}")
        check(gp.predicted_bytes == cost.predict_bytes(old, new),
              f"step {ev.step}: predicted {gp.predicted_bytes} != the cost "
              f"model's {cost.predict_bytes(old, new)}")
        for a in gp.decisions:
            check(a.rescue or a.cost_s <= a.gain_s,
                  f"step {ev.step}: {a} does not amortize")
        if ev.step in (5, 8):
            check(st is not None and moved == [1]
                  and {a.stage for a in gp.transitions} == {1}
                  and gp.predicted_bytes == st.bytes_moved
                  < st.dense_bytes,
                  f"step {ev.step}: not a priced stage-1 repack: {st}")
            # the emulated transition's fused messages are bucket_pack /
            # bucket_unpack; reshard_pack runs in the degraded steps' sync
            check(n["bucket_pack"] > 0 and n["bucket_unpack"] > 0
                  and n["reshard_pack"] == 0,
                  f"step {ev.step}: the transition's launches {n}")
        else:
            check(st is None and gp.predicted_bytes == 0 and new.healthy
                  and not any(n.values()),
                  f"step {ev.step}: the plan moved: {new} {st} {n}")
    errs = [(t["step"], t["canonical_err"]) for t in runner.transitions
            if "canonical_err" in t]
    print("  canonical params vs the dense reference at the transitions: "
          + ", ".join(f"step {i} {e:.2e}" for i, e in errs) + " (tol 1e-4)")
    check([i for i, _ in errs] == [5, 8] and max(e for _, e in errs) < 1e-4,
          "canonical params unchecked or off at a transition")
    folded = telemetry_report.report(list(rec.sinks[0].events()))
    pairs = folded.get("transition_bytes", [])
    print(f"  telemetry fold: cluster.transition_bytes (predicted, executed) "
          f"{[(p['predicted'], p['executed']) for p in pairs]}; transitions "
          f"{folded.get('transitions')}", flush=True)
    check(len(pairs) == 2 and all(p["predicted"] == p["executed"] > 0
                                  for p in pairs),
          f"the fold's predicted and executed bytes differ: {pairs}")
    print(f"  kernels {json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in ALLOC_KERNELS),
          f"a kernel of the allocator path never launched: {launches}")
    regimes = {}
    for regime, ms, _ in steps:
        regimes.setdefault(regime, []).append(ms)
    for regime, v in regimes.items():
        print(f"  step ms, {regime}: " + ", ".join(f"{t:.1f}" for t in v)
              + f" (mean {statistics.mean(v):.1f})")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    del runner, session, rec, real_step, real_apply, step, apply, allocator
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def allocator_only(torch):
    """``--allocator``: build the kernels and run phase 14 alone, then exit
    (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    allocator_phase(torch, torch.device("cuda"))
    return 0


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
    """Phase 9: the training launcher at its defaults on the card, with an
    injected failure, then at pp=2 with microbatches and a stage-addressed
    failure, then as 4 processes, pp=1 and pp=2 (a staged mesh), then
    replaying phase 7's trace with checkpoints and a telemetry stream."""
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
    out = train_main(["--ntp", "--pp", "2", "--microbatches", "2",
                      "--steps", "8", "--fail-at", "3", "--fail-stage", "1",
                      "--overlap", "on", "--log-every", "1"])
    check(len(out["losses"]) == 8 and np.isfinite(out["losses"]).all(),
          "launcher --pp 2: non-finite losses")
    check(out["plan"].stage_tp == ((4, 3), (4, 4)),
          f"launcher --pp 2 plan {out['plan']}")
    out = train_main(["--ntp", "--nproc", "4", "--mesh", "2x2", "--backend",
                      "gloo", "--steps", "8", "--fail-at", "3",
                      "--log-every", "1"])
    check(len(out["losses"]) == 8 and np.isfinite(out["losses"]).all(),
          "launcher --nproc 4: non-finite losses")
    check(out["plan"].replica_tp == (1, 2),
          f"launcher --nproc 4 plan {out['plan']}")
    # the README's staged-mesh command: 2 stages of (2, 2), 8 processes
    out = train_main(["--ntp", "--nproc", "8", "--pp", "2", "--mesh", "2x2",
                      "--backend", "gloo", "--microbatches", "2", "--steps",
                      "4", "--fail-at", "2", "--fail-stage", "1",
                      "--seq-len", "64", "--batch", "2", "--log-every", "1"])
    check(len(out["losses"]) == 4 and np.isfinite(out["losses"]).all(),
          "launcher --nproc 8 --pp 2: non-finite losses")
    check(out["plan"].stage_tp == ((2, 1), (2, 2)),
          f"launcher --nproc 8 --pp 2 plan {out['plan']}")

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


RANKS_KERNELS = ("reshard_pack", "bucket_pack", "bucket_unpack")
# phase 10's chain on the (2, 2) mesh of processes: replica 1 loses a GPU
# before step 0 (TP (1, 2): packing puts it in replica 0) and is repaired
# before step 1, 2 steps (degraded, repaired; a first healthy step was cut
# for the script's time)
RANKS_EVENTS = {0: ("fail", 1), 1: ("repair", 0)}
RANKS_LR, RANKS_LB = 1e-2, 4
# the degraded step after which part (b) measures its (per-leaf) sync
RANKS_SYNC_AFTER = 0


def _ranks_event(i):
    from repro_torch.runtime import FailureEvent, RecoveryEvent

    kind, replica = RANKS_EVENTS[i]
    cls = FailureEvent if kind == "fail" else RecoveryEvent
    return cls(step=i, replica=replica, n_gpus=1)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _plan_regime(plan):
    return "healthy" if plan.healthy else f"degraded {plan.replica_tp}"


def ranks_reference(torch, dev, cfg, seq, steps, directory):
    """Phase 10 (a): the emulated session on the card through the chain;
    its canonical params after each transition and at the end go to
    ``directory`` (one .npy a leaf, flatten order) for the ranks to read,
    written by a thread while the session steps on. Returns its losses
    and step ms."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    s = NTPSession.create(cfg, (2, 2), local_batch=RANKS_LB,
                          optimizer=sgd(RANKS_LR), params=canon, device=dev)
    del canon
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * RANKS_LB,
                                          seed=0))

    losses, ms, writes = [], [], []
    with ThreadPoolExecutor(max_workers=1) as pool:
        def keep(tag):
            leaves = [t.cpu() for t in tr.leaves(s.canonical_params(0))]
            writes.append(pool.submit(_write_leaves, directory, tag, leaves))

        for i in range(steps):
            if i in RANKS_EVENTS:
                s.apply(_ranks_event(i))
                keep(f"step{i}")
            _sync(torch, dev)
            t0 = time.perf_counter()
            losses.append(float(s.step(pipe._batch_np(i))["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        keep("end")
        for w in writes:
            w.result()
    del s
    return losses, ms


def _gloo_takes(torch, mesh):
    """Each collective the process path runs, raw, on tensors of the mesh's
    device (CUDA tensors of this card on the chip) over the model group
    (uneven all-to-all splits, one of them empty); raises if gloo refuses
    one or gets it wrong."""
    import torch.distributed as dist

    dev, r, n = mesh.device, mesh.rank, mesh.n_model
    x = torch.full((5,), float(r + 1), device=dev)
    dist.all_reduce(x, group=mesh.model)
    check(bool((x == n * (n + 1) / 2).all()), "gloo all_reduce")
    sc = [(r + j) % 3 for j in range(n)]
    rc = [(j + r) % 3 for j in range(n)]
    send = torch.cat([torch.full((c,), float(10 * r + j), device=dev)
                      for j, c in enumerate(sc)])
    out = torch.empty(sum(rc), device=dev)
    dist.all_to_all_single(out, send, output_split_sizes=rc,
                           input_split_sizes=sc, group=mesh.model)
    want = torch.cat([torch.full((c,), float(10 * j + r), device=dev)
                      for j, c in enumerate(rc)])
    check(torch.equal(out, want), "gloo all_to_all_single (uneven)")
    outs = [torch.empty(2, device=dev) for _ in range(n)]
    dist.all_gather(outs, torch.full((2,), float(r), device=dev),
                    group=mesh.model)
    check(all(bool((o == j).all()) for j, o in enumerate(outs)),
          "gloo all_gather")
    return ("all_reduce", "all_to_all_single (uneven)", "all_gather")


def _canonical_err(torch, leaves, directory):
    """Max |rank 0's gathered canonical params ``leaves`` - the emulated
    run's, read from ``directory``|."""
    import numpy as np

    return max(float((leaf - torch.from_numpy(np.load(
        os.path.join(directory, f"{i}.npy")))).abs().max())
        for i, leaf in enumerate(leaves))


def rank_worker(cfg, seq, steps, directory, device):
    """Phase 10 (b): one (replica, rank) process of the (2, 2) gloo mesh on
    the card: the chain with SGD, each step and transition timed (host
    clock after a device sync), its collectives and reshard_pack launches
    counted, the canonical params checked by rank 0 after each transition
    and at the end."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch import tree as tr
    from repro_torch.core import collectives as C
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    t_part = time.perf_counter()
    mesh = make_test_mesh(2, 2, backend="gloo", device=device)
    dev, cuda = mesh.device, mesh.device.type == "cuda"
    takes = _gloo_takes(torch, mesh)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    s = NTPSession.create(cfg, mesh, local_batch=RANKS_LB,
                          optimizer=sgd(RANKS_LR), params=canon)
    del canon
    if cuda:
        torch.cuda.empty_cache()
    _sync(torch, dev)
    out = {"setup_s": time.perf_counter() - t0, "takes": takes,
           "loss": [], "grad_norm": [], "step_ms": [], "regime": [],
           "counts": [], "packs": [], "transitions": []}
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * RANKS_LB,
                                          seed=0))
    # rank 0 gathers its replica's canonical params to the host (with rank
    # 1) after each transition and at the end, and compares them with the
    # emulated run's on a thread while the ranks step on
    pool = ThreadPoolExecutor(max_workers=1)
    checks = []

    def check_canonical(tag):
        got = s.canonical_params(0, device="cpu")
        if got is not None and mesh.rank == 0:
            checks.append(pool.submit(_canonical_err, torch, tr.leaves(got),
                                      os.path.join(directory, tag)))

    mode.reset_launches()
    for i in range(steps):
        if i in RANKS_EVENTS:
            old = s.plan
            C.reset_counts()
            _sync(torch, dev)
            t0 = time.perf_counter()
            s.apply(_ranks_event(i))
            _sync(torch, dev)
            ms = (time.perf_counter() - t0) * 1e3
            out["transitions"].append((i, old, s.plan, ms,
                                       s.last_transition.as_dict(),
                                       C.counts()))
            check_canonical(f"step{i}")
        C.reset_counts()
        before = mode.launches()["reshard_pack"]
        _sync(torch, dev)
        t0 = time.perf_counter()
        m = s.step(pipe._batch_np(i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        _sync(torch, dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["regime"].append(_plan_regime(s.plan))
        out["counts"].append(C.counts())
        out["packs"].append(mode.launches()["reshard_pack"] - before)
        if i == RANKS_SYNC_AFTER:
            out["sync"] = s.measure_sync(pipe._batch_np(i))
    out["launches"] = mode.launches()
    check_canonical("end")
    out["canonical"] = [c.result() for c in checks] or None
    pool.shutdown()
    out["collectives"] = (s.step_fn.collectives,
                          s.step_fn.sync_fn.replicated_collectives)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9,
                      torch.cuda.max_memory_reserved(dev) / 1e9) if cuda \
        else (0.0, 0.0)
    out["rank"] = (mesh.replica, mesh.rank)
    out["part_s"] = time.perf_counter() - t_part
    return out


def ranks_worker(cfg, seq, steps, directory, directory_c, device):
    """Phase 10's processes: part (b) (`rank_worker`), then, in the same
    processes and process group, part (c) (`lifecycle_worker`) with the
    card memory (b) cached handed back first."""
    import gc

    import torch

    b = rank_worker(cfg, seq, steps, directory, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return b, lifecycle_worker(cfg, seq, LIFE_STEPS, directory_c, device)


def ranks_phase(torch, dev, cfg=None, seq=256, steps=2):
    """Phase 10: ranks as processes. The NTP prototype at qwen2-7b widths
    (``cfg``; 1 layer from `main`) on a (2, 2) mesh of 4 processes, gloo on this card, through
    fail → repair with SGD, held to the emulated session run first on the
    same seed, chain and batches (parts (a) and (b)); then part (c), the
    lifecycle with overlap on (`lifecycle_part`). Returns the ranks' launch
    counts of (b) and (c)
    summed (and, on the card, the per-rank kernel rows). ``cfg``/``seq``/
    ``steps`` and a CPU ``dev`` let the phase be rehearsed small on the
    CPU."""
    import shutil
    import subprocess

    from repro_torch.core.nonuniform import FailurePlan
    from repro_torch.launch.spawn import spawn

    cfg = cfg or qwen_widths()
    if dev.type == "cuda":
        mode_ = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip()
        print(f"  compute_mode {mode_}: 4 processes share cuda:0", flush=True)
    tmp, tmp_c = scratch_dir(), scratch_dir()
    # four processes share the card: segments that grow in place keep each
    # rank's cached-but-free memory small (the ranks read it at start)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    try:
        t0 = time.perf_counter()
        ref_losses, ref_ms = ranks_reference(torch, dev, cfg, seq, steps, tmp)
        print(f"  emulated (2, 2) session: {steps} steps in "
              f"{time.perf_counter() - t0:.1f} s with its checkpoints, step "
              f"ms {', '.join(f'{m:.1f}' for m in ref_ms)}", flush=True)
        t0 = time.perf_counter()
        ref_c = lifecycle_reference(torch, dev, cfg, seq, LIFE_STEPS, tmp_c)
        check(ref_c["healthy_end"], "the chain does not end pristine")
        print(f"  (c)'s emulated (2, 2) session, overlap on: {LIFE_STEPS} "
              f"steps in {time.perf_counter() - t0:.1f} s with its "
              f"checkpoints", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info(dev)
            print(f"  the parent keeps {torch.cuda.memory_allocated() / 1e9:.2f}"
                  f" GB allocated; card memory free before the spawn "
                  f"{free / 1e9:.2f} of {total / 1e9:.2f} GB", flush=True)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = RANK_ALLOC_CONF
        t0 = time.perf_counter()
        # one spawn runs (b), then (c), in the same four processes
        both = spawn(ranks_worker, 4, backend="gloo", device=dev.type,
                     deadline_s=900,
                     args=(cfg, seq, steps, tmp, tmp_c, dev.type))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tmp_c, ignore_errors=True)
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ranks = [b for b, _ in both]
    r0 = ranks[0]
    b_steps = [(regime, max(r["step_ms"][i] for r in ranks))
               for i, regime in enumerate(r0["regime"])]
    print(f"  gloo takes {dev.type} tensors for {', '.join(r0['takes'])}: "
          f"staged through host buffers: none", flush=True)
    print(f"  4 ranks spawned, run (b) and (c) and joined in {wall:.1f} s; "
          f"(b)'s set-up (canonical init + pack) "
          f"{max(r['setup_s'] for r in ranks):.1f} s, (b) "
          f"{max(r['part_s'] for r in ranks):.1f} s", flush=True)
    for r in ranks:
        err = max(abs(a - b) for a, b in zip(r["loss"], ref_losses))
        print(f"  rank {r['rank']}: max |loss - emulated| {err:.3e}, peak "
              f"{r['peak_gb'][0]:.2f} GB allocated, {r['peak_gb'][1]:.2f} GB "
              f"reserved", flush=True)
        check(err <= 1e-5, f"rank {r['rank']} loss off the emulated by {err}")
    print(f"  losses {', '.join(f'{x:.5f}' for x in r0['loss'])}")
    for i, regime in enumerate(r0["regime"]):
        step_ms = max(r["step_ms"][i] for r in ranks)
        counts = ", ".join(f"{op}/{g} {c} calls {b} B" for (op, g), (c, b)
                           in sorted(r0["counts"][i].items()))
        print(f"  step {i} ({regime}): {step_ms:.1f} ms (max over ranks; "
              f"emulated {ref_ms[i]:.1f}); rank 0: {counts}; reshard_pack "
              f"launches {sum(r['packs'][i] for r in ranks)} (all ranks)",
              flush=True)
        check(dev.type != "cuda" or
              (sum(r["packs"][i] for r in ranks) > 0) == (regime != "healthy"),
              f"step {i}: reshard_pack launches {[r['packs'][i] for r in ranks]}"
              f" in a {regime} step")
    for k, (i, old, new, _, st, counts) in enumerate(r0["transitions"]):
        ms = max(r["transitions"][k][3] for r in ranks)
        want = _expected_bytes(cfg, old, new)
        print(f"  step {i}: {old.replica_tp} -> {new.replica_tp}: transition "
              f"{ms:.1f} ms (max over ranks), {st['bytes_moved']} B in "
              f"{st['messages']} messages (expected {want} B); rank 0 sent "
              f"{counts}; canonical params of rank 0 within "
              f"{r0['canonical'][k]:.3e} of the emulated", flush=True)
        check(st["bytes_moved"] == want, f"transition bytes {st} != {want}")
        check(all(r["transitions"][k][4] == st for r in ranks),
              "ranks disagree on the transition ledger")
        check(counts == {("all_to_all", "model"): counts[("all_to_all",
                                                          "model")]}
              and counts[("all_to_all", "model")][0] == 1,
              f"a transition sends one all-to-all: {counts}")
        check(r0["canonical"][k] <= 1e-4, "canonical params off the emulated")
    print(f"  end: canonical params of rank 0 within {r0['canonical'][-1]:.3e} "
          f"of the emulated", flush=True)
    check(r0["canonical"][-1] <= 1e-4, "final canonical params off")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    check(launches["reshard_pack"] > 0 or dev.type != "cuda",
          f"reshard_pack never launched: {launches}")
    del ranks
    print("  (c) the lifecycle over processes, overlap on, NTP-PW, "
          "quarantine, at full width", flush=True)
    life = lifecycle_part(torch, dev, cfg, ref_c, [c for _, c in both],
                          b_steps, r0["sync"])
    launches = {k: launches[k] + life.get(k, 0) for k in launches}
    if dev.type != "cuda":
        return launches, None
    plan = FailurePlan(2, (1, 2))
    return launches, dict(reshard_pack=rank_reshard_row(torch, dev, cfg,
                                                        plan),
                          **rank_bucket_rows(torch, dev, cfg, plan))


def rank_reshard_row(torch, dev, cfg, plan):
    """The per-rank reshard_pack at the process path's largest call: one
    rank's MLP gradient leaf (one unit row = 3584·128 elems) under the
    degraded plan's pre-sync tables, the rank that sends the most rows;
    bit-exact against its plain version and timed in turns against
    advanced indexing and `index_select`, as phase 3's rows."""
    from repro_torch.core import nonuniform as nu
    from repro_torch.kernels import ref
    from repro_torch.kernels.reshard_pack import reshard_pack, \
        reshard_pack_cost

    tables = nu.weight_plan(cfg.k_ff, plan).pre
    g = torch.Generator(device=dev).manual_seed(7)
    elems = cfg.d_model * cfg.unit_rows
    best = None
    for d in range(plan.d):
        t = tables.replica(d)
        for r in range(t.n):
            n_rows = int((t.send_idx[r] != t.pad).sum())
            if best is None or n_rows > best[0]:
                best = (n_rows, d, r, t)
    _, d, r, t = best
    xp = torch.randn((t.buf + 1, elems), generator=g, device=dev)
    xp[-1] = 0
    ix = torch.as_tensor(t.send_idx[r], device=dev)
    got = reshard_pack(xp, ix)
    torch.cuda.synchronize()
    check(torch.equal(got, ref.reshard_pack_ref(xp, ix)),
          "per-rank reshard_pack is not bit-exact")
    del got
    plain = time_ms(lambda: ref.reshard_pack_ref(xp, ix), 10)
    flat = ix.long().flatten()
    tm = in_turns(torch, lambda: reshard_pack(xp, ix), {
        "src[idx]": lambda: xp[ix.long()],
        "index_select": lambda: torch.index_select(xp, 0, flat).view(
            *ix.shape, elems)}, reps=10, calls=4)
    n_read = len({int(u) for u in t.send_idx[r].flatten() if u != t.pad})
    bd = bound_ms(reshard_pack_cost(ix.numel(), elems, 4, n_read), "float32")
    report_turns("reshard_pack", f"per rank, replica {d} rank {r} "
                 f"src{tuple(xp.shape)} idx{tuple(ix.shape)}", "float32",
                 0.0, 0.0, tm, plain, bd)
    row = table_row(0.0, tm, plain, bd)
    del xp, ix
    torch.cuda.empty_cache()
    return row


def rank_bucket_rows(torch, dev, cfg, plan):
    """bucket_pack / bucket_unpack at the process path's largest bucket:
    one rank's MLP bucket of one layer (A and B, ``buf`` rows of
    3584·128 elems each) under ``plan``; bit-exact against the plain
    versions, timed in turns with `torch.cat` and `split` +
    `.contiguous()`, as phase 3's rows."""
    from repro_torch.core import nonuniform as nu
    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket import (bucket_cost, bucket_pack,
                                            bucket_unpack)

    n_rows = nu.weight_plan(cfg.k_ff, plan).buf
    widths = (cfg.d_model * cfg.unit_rows,) * 2
    g = torch.Generator(device=dev).manual_seed(11)
    leaves = [torch.randn((n_rows, w), generator=g, device=dev)
              for w in widths]
    flat = bucket_pack(leaves)
    parts = bucket_unpack(flat, widths)
    torch.cuda.synchronize()
    check(torch.equal(flat, ref.bucket_pack_ref(leaves)) and all(
        torch.equal(p, w) for p, w in zip(
            parts, ref.bucket_unpack_ref(flat, widths))),
        "per-rank bucket_pack / bucket_unpack are not bit-exact")
    del parts
    bd = bound_ms(bucket_cost(n_rows, sum(widths), 4), "float32")
    rows = {}
    for name, kern, plain_fn, libs in (
            ("bucket_pack", lambda: bucket_pack(leaves),
             lambda: ref.bucket_pack_ref(leaves),
             {"torch.cat": lambda: torch.cat(leaves, dim=1)}),
            ("bucket_unpack", lambda: bucket_unpack(flat, widths),
             lambda: ref.bucket_unpack_ref(flat, widths),
             {"split+contiguous": lambda: [
                 t.contiguous() for t in torch.split(flat, widths, dim=1)]})):
        plain = time_ms(plain_fn, 10)
        t = in_turns(torch, kern, libs, reps=10, calls=2)
        report_turns(name, f"per rank, MLP TP {plan.replica_tp} "
                     f"{n_rows}x{sum(widths)} (2 leaves)", "float32", 0.0,
                     0.0, t, plain, bd)
        rows[name] = table_row(0.0, t, plain, bd)
    del leaves, flat
    torch.cuda.empty_cache()
    return rows


# phase 10 (c): the lifecycle chain on the (2, 2) mesh of processes, every
# event kind with its inverse, in order within a step. Before step 0, after
# the snapshot: replica 1's GPU fails (TP (1, 2): its domain packs into
# replica 0), the failed domain's link degrades and domain 0 straggles; 1:
# an SDC suspicion on replica 1 (domain 0) quarantines it and rolls back
# to the step-0 snapshot under TP (1, 2); 2: its clear, the link's repair,
# the straggler's clear and the repair (TP (2, 2)). 3 steps (a first
# healthy step and a separate straggler step were cut for the script's
# time).
LIFE_STEPS = 3


def _life_chain():
    from repro_torch.runtime import (
        FailureEvent, LinkDegradeEvent, LinkRepairEvent, RecoveryEvent,
        SdcClearEvent, SdcSuspectEvent, StragglerClearEvent, StragglerEvent,
    )

    return {0: [FailureEvent(step=0, replica=1),
                LinkDegradeEvent(step=0, domain=1, bw_frac=0.5),
                StragglerEvent(step=0, domain=0, slowdown=2.0)],
            1: [SdcSuspectEvent(step=1, replica=1)],
            2: [SdcClearEvent(step=2, replica=1),
                LinkRepairEvent(step=2, domain=1, bw_frac=0.5),
                StragglerClearEvent(step=2, domain=0, slowdown=2.0),
                RecoveryEvent(step=2, replica=0)]}


# the degraded step after which part (c) measures its (bucketed) sync;
# part (b) measures its per-leaf one after RANKS_SYNC_AFTER, both at TP (1, 2)
LIFE_SYNC_AFTER = 0
# each rank's share of the card in part (c): 4 x 0.235 of 79.18 GiB, the
# rest for the four CUDA contexts
LIFE_MEMORY_SHARE = 0.235
# how often a rank worker's thread samples its resident host memory
HOST_SAMPLE_S = 0.01


def _life_session(torch, cfg, mesh, dev):
    from repro_torch.core import ntp_train as nt
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession, power_policy

    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    kw = dict(device=dev) if mesh == (2, 2) else {}
    return NTPSession.create(cfg, mesh, local_batch=RANKS_LB,
                             optimizer=sgd(RANKS_LR), params=canon,
                             overlap=True, power_policy=power_policy("ntp_pw"),
                             quarantine=True, **kw)


def _write_leaves(directory, tag, leaves):
    import numpy as np

    os.makedirs(os.path.join(directory, tag))
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(directory, tag, f"{i}.npy"), leaf.numpy())


def lifecycle_reference(torch, dev, cfg, seq, steps, directory):
    """Phase 10 (c), first: the emulated (2, 2) session, overlap on, NTP-PW,
    quarantine, snapshot at step 0, through the chain on the card; its
    canonical params at step 0 and at the end go to ``directory`` (one
    .npy a leaf) on a thread. Returns its losses, per-step decisions and
    per-event records."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import tree as tr
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

    s = _life_session(torch, cfg, (2, 2), dev)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * RANKS_LB,
                                          seed=0))
    chain = _life_chain()
    out = {"loss": [], "decision": [], "events": []}
    with ThreadPoolExecutor(max_workers=1) as pool:
        writes = []

        def keep(tag):
            leaves = [t.cpu() for t in tr.leaves(s.canonical_params(0))]
            writes.append(pool.submit(_write_leaves, directory, tag, leaves))

        keep("start")
        s.snapshot()
        for i in range(steps):
            for ev in chain.get(i, ()):
                old = s.plan
                s.apply(ev)
                out["events"].append(_life_event(i, ev, old, s))
            out["loss"].append(float(s.step(pipe._batch_np(i))["loss"]))
            out["decision"].append((tuple(s.local_batches),
                                    s.power_decision))
        keep("end")
        out["healthy_end"] = s.health.healthy and s.health.degraded is None
        for w in writes:
            w.result()
    del s
    return out


def _life_event(i, ev, old, s):
    """What an apply did: (step, kind, old plan, new plan, ledger when the
    plan changed, rolled back)."""
    from repro_torch.runtime import event_kind

    return (i, event_kind(ev), old, s.plan,
            s.last_transition.as_dict() if s.plan != old else None,
            s.last_rollback)


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def lifecycle_worker(cfg, seq, steps, directory, device):
    """Phase 10 (c): one (replica, rank) process of the (2, 2) gloo mesh
    on the card: the overlap-on NTP-PW session through the lifecycle
    chain, snapshot at step 0; each step and apply timed (host clock after
    a device sync), its collectives and kernel launches counted; the syncs
    timed alone on the degraded plan; rank 0 checks its replica's
    canonical params right after the rollback (against step 0, bit for
    bit) and at the end (against the emulated run)."""
    import numpy as np
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.launch.mesh import make_test_mesh

    t_part = time.perf_counter()
    mesh = make_test_mesh(2, 2, backend="gloo", device=device)
    dev, cuda = mesh.device, mesh.device.type == "cuda"
    if cuda:
        # four caching allocators share the card: each frees its own cache
        # before it takes more than its share (the side stream's pool
        # would otherwise sit on memory another rank needs)
        torch.cuda.set_per_process_memory_fraction(LIFE_MEMORY_SHARE, dev)
        torch.cuda.reset_peak_memory_stats(dev)
    s = _life_session(torch, cfg, mesh, dev)
    if cuda:
        torch.cuda.empty_cache()
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * RANKS_LB,
                                          seed=0))
    chain = _life_chain()

    host = _HostPeak()

    def timed(fn):
        _sync(torch, dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        return r, ms

    _, snap_ms = timed(s.snapshot)
    out = {"snapshot": (snap_ms, _tree_bytes(s._snapshot[1])), "loss": [],
           "decision": [], "step_ms": [], "regime": [], "plan": [],
           "counts": [], "launches": [], "events": [], "apply_ms": [],
           "chunks":
           len(s.step_fn.chunks)}
    checks = {}

    def check_canonical(tag):
        """Rank 0: max |its replica's canonical params - the emulated run's
        under ``tag``|, gathered and compared one leaf at a time (replica
        0's ranks gather; the host holds one leaf a rank)."""
        if mesh.replica != 0:
            return
        err = 0.0
        for i, (_, leaf) in enumerate(nt.rank_canonical_leaves(
                cfg, s.params, s.plan, mesh, "cpu")):
            if mesh.rank == 0:
                want = np.load(os.path.join(directory, tag, f"{i}.npy"))
                err = max(err, float(leaf.sub_(torch.from_numpy(want))
                                     .abs_().max()))
            del leaf
        if mesh.rank == 0:
            checks[tag] = err
        _release_host_cache(torch)

    mode.reset_launches()
    total = {}
    for i in range(steps):
        for ev in chain.get(i, ()):
            old = s.plan
            _, ms = timed(lambda: s.apply(ev))
            out["events"].append(_life_event(i, ev, old, s))
            out["apply_ms"].append(ms)
            if s.plan != old:
                _release_host_cache(torch)
            if s.last_rollback:
                check_canonical("start")
                _, out["rollback_ms"] = timed(s.rollback)   # same plan
        C.reset_counts()
        before = mode.launches()
        m, ms = timed(lambda: s.step(pipe._batch_np(i)))
        out["loss"].append(float(m["loss"]))
        out["decision"].append((tuple(s.local_batches), s.power_decision))
        out["step_ms"].append(ms)
        out["regime"].append(_regime(s))
        out["plan"].append(s.plan)
        out["counts"].append(C.counts())
        after = mode.launches()
        out["launches"].append({k: after[k] - before[k]
                                for k in RANKS_KERNELS})
        total = after
        if i == LIFE_SYNC_AFTER:
            out["sync"] = (s.measure_sync(pipe._batch_np(i)),
                           s.plan.replica_tp)
    out["total_launches"] = {k: total.get(k, 0) for k in RANKS_KERNELS}
    check_canonical("end")
    out["canonical"] = checks
    out["collectives"] = (s.step_fn.collectives,
                          s.step_fn.replicated_collectives)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9,
                      torch.cuda.max_memory_reserved(dev) / 1e9) if cuda \
        else (0.0, 0.0)
    out["alloc_retries"] = torch.cuda.memory_stats(dev).get(
        "num_alloc_retries") if cuda else 0
    out["host_gb"] = host.stop()
    stats = getattr(torch.cuda, "host_memory_stats", dict)() if cuda else {}
    out["pinned_bytes"] = stats.get("allocated_bytes.peak")
    out["rank"] = (mesh.replica, mesh.rank)
    out["part_s"] = time.perf_counter() - t_part
    return out


def _host_rss_gb():
    """This process's resident memory now, in GB (``/proc/self/statm``).
    A spawned rank is forked from this script and then exec'd, and
    ``ru_maxrss`` keeps the parent's resident size from before the exec
    (the chip machine's kernel has no ``VmHWM``), so the rank workers take
    their peak from `_HostPeak`."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


class _HostPeak:
    """The maximum of `_host_rss_gb` from construction to `stop`, sampled
    every ``HOST_SAMPLE_S`` by a daemon thread, so a peak inside a step
    (gloo's host staging of a sum) shows to within the interval."""

    def __init__(self):
        self.peak = _host_rss_gb()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._done.wait(HOST_SAMPLE_S):
            self.peak = max(self.peak, _host_rss_gb())

    def stop(self) -> float:
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, _host_rss_gb())
        return self.peak


def _release_host_cache(torch):
    """Return the pinned host blocks no collective holds any more (gloo
    stages each CUDA tensor it sums or sends through one, kept cached,
    rounded up to a power of two): four ranks share this host's memory,
    and a transition's or a gather's staging blocks are not needed again
    soon."""
    if torch.cuda.is_available():
        torch._C._host_emptyCache()


def lifecycle_part(torch, dev, cfg, ref, ranks, b_steps, b_sync):
    """Phase 10 (c)'s checks: the emulated overlap-on (2, 2) session
    (`lifecycle_reference`, ``ref``, run by `ranks_phase` before the
    spawn) and the 4 ranks' runs of the same chain (`lifecycle_worker`,
    ``ranks``, run after part (b) in the same processes). Checks: every
    rank's loss within 1e-5 of the emulated; every step's local batches and
    `PowerDecision` equal to the emulated; every transition's ledger equal
    to the emulated and its bytes to `expected_transfer`; one rollback, and
    rank 0's canonical params right after it bit-identical to step 0's; at
    the end within 1e-4 of the emulated; on the card bucket_pack and
    bucket_unpack launched once a bucket on every step by every rank (2
    unit buckets and 1 rep bucket a chunk), reshard_pack on degraded steps
    only. Returns the ranks' launch counts summed."""
    t_part = time.perf_counter()
    r0 = ranks[0]
    cuda = dev.type == "cuda"
    print(f"  (c) over the same 4 ranks: {max(r['part_s'] for r in ranks):.1f}"
          f" s", flush=True)
    for r in ranks:
        err = max(abs(a - b) for a, b in zip(r["loss"], ref["loss"]))
        print(f"  rank {r['rank']}: max |loss - emulated| {err:.3e}, peak "
              f"{r['peak_gb'][0]:.2f} GB allocated, {r['peak_gb'][1]:.2f} GB "
              f"reserved, host peak {r['host_gb']:.2f} GB resident (sampled "
              f"every {HOST_SAMPLE_S * 1e3:.0f} ms; "
              + ("pinned peak not measured" if r["pinned_bytes"] is None else
                 f"{r['pinned_bytes'] / 1e9:.2f} GB pinned at peak") + "); "
              f"snapshot {r['snapshot'][0]:.1f} ms, "
              f"{r['snapshot'][1]} B of host memory; allocator retries "
              f"{r['alloc_retries']}; a second rollback at "
              f"the same plan {r['rollback_ms']:.1f} ms", flush=True)
        check(err <= 1e-5, f"rank {r['rank']} loss off the emulated by {err}")
        check(r["decision"] == ref["decision"],
              f"rank {r['rank']}: local batches / PowerDecision differ from "
              "the emulated")
        check([e[:5] for e in r["events"]] == [e[:5] for e in ref["events"]]
              and [e[5] for e in r["events"]] == [e[5] for e in ref["events"]],
              f"rank {r['rank']}: events / ledgers differ from the emulated")
    print(f"  losses {', '.join(f'{x:.5f}' for x in r0['loss'])}")
    n_buckets = 3 * r0["chunks"]
    for i, regime in enumerate(r0["regime"]):
        step_ms = max(r["step_ms"][i] for r in ranks)
        lb, dec = r0["decision"][i]
        counts = ", ".join(f"{op}/{g} {c} calls {b} B" for (op, g), (c, b)
                           in sorted(r0["counts"][i].items()))
        launched = [r["launches"][i] for r in ranks]
        print(f"  step {i} ({regime}): {step_ms:.1f} ms (max over ranks); "
              f"local batches {lb}, policy {dec.method if dec else None}, "
              f"boost {max(dec.boost) if dec else 1.0:.3f}; rank 0: "
              f"{counts}; launches a rank {launched[0]}", flush=True)
        if cuda:
            check(all(l["bucket_pack"] == l["bucket_unpack"] == n_buckets
                      for l in launched),
                  f"step {i}: bucket launches {launched}, want {n_buckets} "
                  "a rank")
            check(all((l["reshard_pack"] > 0) == (not r0["plan"][i].healthy)
                      for l in launched),
                  f"step {i}: reshard_pack launches {launched} in a "
                  f"{regime} step")
    for k, ev in enumerate(r0["events"]):
        i, kind, old, new, ledger, rolled = ev
        ms = max(r["apply_ms"][k] for r in ranks)
        line = (f"  step {i}: {kind}: {old.replica_tp} -> {new.replica_tp}, "
                f"apply {ms:.1f} ms (max over ranks)")
        if ledger is not None:
            want = _expected_bytes(cfg, old, new)
            line += (f", {ledger['bytes_moved']} B in {ledger['messages']} "
                     f"messages (expected {want} B)")
            check(ledger["bytes_moved"] == want,
                  f"transition bytes {ledger} != {want}")
        if rolled:
            err = r0["canonical"]["start"]
            line += (f", rolled back to the step-0 snapshot: rank 0's "
                     f"canonical params off step 0's by {err:.3e}")
            check(err == 0.0, "the rollback is not bit-exact")
        print(line, flush=True)
    check(sum(e[5] for e in r0["events"]) == 1, "one rollback expected")
    sync, tp = r0["sync"]
    print(f"  measure_sync at TP {tp} (sync_s, max over ranks): bucketed "
          f"(overlap on) {sync['sync_s'] * 1e3:.1f} ms, "
          f"{sync['collectives']} unit collectives; per-leaf (part (b), "
          f"overlap off) {b_sync['sync_s'] * 1e3:.1f} ms, "
          f"{b_sync['collectives']}; a healthy step's unit collectives {r0['collectives'][0]} + "
          f"replicated {r0['collectives'][1]}", flush=True)
    b_by = {}
    for regime, ms in b_steps:
        b_by.setdefault(regime, []).append(ms)
    c_by = {}
    for i, regime in enumerate(r0["regime"]):
        c_by.setdefault(regime, []).append(max(r["step_ms"][i]
                                               for r in ranks))
    print("  step ms by regime, overlap on (c): " + "; ".join(
        f"{k} {min(v):.1f}-{max(v):.1f}" for k, v in c_by.items())
        + " | overlap off (b): " + "; ".join(
        f"{k} {min(v):.1f}-{max(v):.1f}" for k, v in b_by.items()),
        flush=True)
    print(f"  end: canonical params of rank 0 within "
          f"{r0['canonical']['end']:.3e} of the emulated", flush=True)
    check(r0["canonical"]["end"] <= 1e-4, "final canonical params off")
    launches = {k: sum(r["total_launches"][k] for r in ranks)
                for k in RANKS_KERNELS}
    print(f"  part (c)'s checks: {time.perf_counter() - t_part:.1f} s; "
          f"launches {launches}", flush=True)
    return launches


# phase 11: pp=2 ranks as processes, a staged mesh (`make_staged_mesh`) of
# pp x D x N1 gloo processes on this card, one layer a stage, driven by
# `launch.profile.measure` beside the emulated session. The chain, in the
# profile's two warm-up steps: the last replica's stage 1 loses a GPU
# before step 0 (TP (1, 2) there, stage 0 untouched), the repair before
# step 1; then one timed healthy step.
PP_RANKS_KERNELS = ("reshard_pack", "bucket_pack", "bucket_unpack")
PP_RANKS_STEPS = 2      # the profile's warm-up steps: the chain's
PP_RANKS_TIMED = 1      # the profile's timed steps
PP_RANKS_MB = 2
# each process's share of the card by stage (stage 1 holds `head` and the
# microbatch logits, and packs a degraded layer wider): 4 x (0.10 + 0.125)
# of 79.18 GiB, the rest for the nine CUDA contexts
PP_RANKS_MEMORY_SHARE = (0.10, 0.125)


def _pp_ranks_chain(n_data):
    from repro_torch.runtime import FailureEvent, RecoveryEvent

    return {0: FailureEvent(step=0, replica=n_data - 1, stage=1, n_gpus=1),
            1: RecoveryEvent(step=1, replica=0, stage=1, n_gpus=1)}


def pp_rank_finish(session, mesh, cfg, directory):
    """Phase 11, each process at the end of its profile run: this stage's
    canonical params gathered over its model groups to the host one leaf
    at a time (no traffic between stages); replica 0's rank 0 of each
    stage compares them with the emulated run's in ``directory``. Returns
    (that error or None, the process's resident GB at the end)."""
    import numpy as np
    import torch

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt

    index = {p: i for i, (p, _) in enumerate(tr.leaves_with_path(
        nt.canonical_like(cfg)))}
    err = 0.0 if mesh.replica == 0 and mesh.rank == 0 else None
    if mesh.replica == 0:
        for path, leaf in nt.rank_canonical_leaves(
                cfg, session.params, session.plan, mesh, "cpu"):
            if err is not None:
                want = np.load(os.path.join(directory, "end",
                                            f"{index[path]}.npy"))
                err = max(err, float(leaf.sub_(torch.from_numpy(want))
                                     .abs_().max()))
            del leaf
    _release_host_cache(torch)
    return err, _host_rss_gb()


def pp_ranks_phase(torch, dev, cfg=None, seq=256, mesh=(2, 2)):
    """Phase 11: pp=2 ranks as processes, through `launch.profile.measure`.
    The NTP prototype at qwen2-7b widths with one layer a stage on a pp=2
    x ``mesh`` staged mesh of gloo processes on this card
    (`launch.mesh.make_staged_mesh`; each process holds its stage's share:
    `embed` on stage 0, `head` and `final_norm` on stage 1), overlap on,
    microbatches 2, through the chain in the profile's warm-up steps and
    one timed step, held to the emulated pp=2 session the profile runs
    first on the same seed, chain and batches. Checks: every process's
    loss within 1e-5 of the emulated; local batches equal; each
    transition's ledger equal to the emulated and its bytes to
    `expected_transfer`, stage 0's processes sending nothing and each of
    stage 1's one all-to-all; every step's hand-off bytes, summed over the
    processes, equal to `handoff_accounting`'s table; each stage's
    canonical params within 1e-5 of the emulated at the end; bucket_pack
    and bucket_unpack launched once a bucket on every step by every
    process, reshard_pack by stage 1's on its degraded steps only; on the
    card a Chrome trace written. Prints the profile's lines (step ms from
    CUDA events, the bubble factor, the sync probes, ticks and the
    hand-off table) and the trace's size and top five device ops. Returns
    the processes' launch counts summed. (The per-rank kernels run at
    phase 10's shape, held and timed there.) ``cfg``/``seq``/``mesh`` and
    a CPU ``dev`` let the phase be rehearsed small on the CPU."""
    import shutil

    from repro_torch import tree as tr
    from repro_torch.launch import profile

    cfg = cfg or dataclasses.replace(qwen_widths(), n_layers=2)
    cuda = dev.type == "cuda"
    tmp = scratch_dir()
    trace = os.path.join(tmp, "trace") if cuda else None
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    t_part = time.perf_counter()

    def emulated_done(session):
        _write_leaves(tmp, "end",
                      [t.cpu() for t in tr.leaves(session.canonical_params(0))])
        if cuda:
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info(dev)
            print(f"  card memory free before the spawn {free / 1e9:.2f} of "
                  f"{total / 1e9:.2f} GB", flush=True)

    try:
        # the processes' allocator: four ranks' transitions need room
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = RANK_ALLOC_CONF
        prof = profile.measure(
            steps=PP_RANKS_TIMED, warmup=PP_RANKS_STEPS, pp=2,
            microbatches=PP_RANKS_MB, batch=RANKS_LB, seq_len=seq,
            overlap=True, trace_dir=trace, n_data=mesh[0], n_model=mesh[1],
            cfg=cfg, device=dev.type, lr=RANKS_LR,
            events=_pp_ranks_chain(mesh[0]),
            memory_share=PP_RANKS_MEMORY_SHARE, after_emulated=emulated_done,
            finish=pp_rank_finish, finish_args=(cfg, tmp),
            report=lambda line: print(f"  {line}", flush=True))
        if trace:
            files = sorted(os.listdir(trace))
            size = sum(os.path.getsize(os.path.join(trace, f)) for f in files)
            print(f"  Chrome traces {files}: {size / 1e6:.1f} MB", flush=True)
            check(files and size > 0, "no profiler trace was written")
            for name, ms in prof["emulated"].get("top", []):
                print(f"  top device op (emulated, timed step): {ms:9.3f} ms "
                      f"{name[:80]}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ref, ranks = prof["emulated"], prof["staged"]
    r0 = ranks[0]
    for r in ranks:
        err = max(abs(a["loss"] - b["loss"])
                  for a, b in zip(r["steps"], ref["steps"]))
        print(f"  process (stage, replica, rank) {r['rank']}: max |loss - "
              f"emulated| {err:.3e}, peak {r['peak_gb'][0]:.2f} GB "
              f"allocated, {r['peak_gb'][1]:.2f} GB reserved, "
              f"{r['finish'][1]:.2f} GB resident at the end", flush=True)
        check(err <= 1e-5, f"process {r['rank']} loss off the emulated by "
              f"{err}")
        check([st["local_batches"] for st in r["steps"]]
              == [st["local_batches"] for st in ref["steps"]],
              f"process {r['rank']}: local batches differ from the emulated")
    losses = ", ".join(f"{st['loss']:.5f}" for st in r0["steps"])
    print(f"  losses {losses}")
    by_regime = {}
    for i, st in enumerate(r0["steps"]):
        regime = ("healthy" if st["plan"].healthy
                  else f"degraded at TP {_tp(st['plan'])}")
        step_ms = max(r["steps"][i]["ms"] for r in ranks)
        by_regime.setdefault(regime, []).append(step_ms)
        table = st["handoff"]
        fwd = sum(r["steps"][i]["counts"].get(("send_next", "stage"),
                                              (0, 0))[1] for r in ranks)
        bwd = sum(r["steps"][i]["counts"].get(("send_prev", "stage"),
                                              (0, 0))[1] for r in ranks)
        launched = [{k: r["steps"][i]["launches"][k]
                     for k in PP_RANKS_KERNELS} for r in ranks]
        print(f"  step {i} ({regime}{'' if st['timed'] else ', warm-up'}): "
              f"{step_ms:.1f} ms (max over processes; emulated "
              f"{ref['steps'][i]['ms']:.1f}); {st['ticks']} ticks; hand-off "
              f"{fwd} B forward + {bwd} B backward (table "
              f"{table['fwd_bytes']} + {table['bwd_bytes']}); launches "
              f"{launched[0]} (stage 0), {launched[-1]} (stage 1)",
              flush=True)
        check((fwd, bwd) == (table["fwd_bytes"], table["bwd_bytes"]),
              f"step {i}: hand-off bytes ({fwd}, {bwd}) != table {table}")
        if cuda:
            stage1_degraded = "degraded" in regime
            for r, l in zip(ranks, launched):
                check(l["bucket_pack"] == l["bucket_unpack"] == 3,
                      f"step {i}: process {r['rank']} bucket launches {l}")
                check((l["reshard_pack"] > 0)
                      == (stage1_degraded and r["rank"][0] == 1),
                      f"step {i}: process {r['rank']} reshard_pack {l} in a "
                      f"{regime} step")
    for k, ev in enumerate(r0["events"]):
        i, old, new, st, pairs = (ev["step"], ev["old"], ev["new"],
                                  ev["ledger"], ev["per_pair"])
        ms = max(r["events"][k]["ms"] for r in ranks)
        want = _expected_bytes(cfg, old, new)
        per_stage = {}
        for key, units in pairs.items():
            per_stage[key[0]] = per_stage.get(key[0], 0) + units
        sent = {r["rank"]: r["events"][k]["counts"].get(
            ("all_to_all", "model"), (0, 0)) for r in ranks}
        print(f"  step {i}: {_tp(old)} -> {_tp(new)}: apply {ms:.1f} ms (max "
              f"over processes), {st['bytes_moved']} B in {st['messages']} "
              f"messages (expected {want} B), units moved by stage "
              f"{per_stage}; all-to-all (calls, B) by process {sent}",
              flush=True)
        check(st == ref["events"][k]["ledger"]
              and pairs == ref["events"][k]["per_pair"],
              "the transition ledger differs from the emulated")
        check(st["bytes_moved"] == want, f"transition bytes {st} != {want}")
        check(set(per_stage) == {1}, "the transition is not stage-local")
        check(all(r["events"][k]["ledger"] == st for r in ranks),
              "processes disagree on the transition ledger")
        for r in ranks:
            counts = r["events"][k]["counts"]
            if r["rank"][0] == 0:
                check(counts == {}, f"stage 0 process {r['rank']} sent "
                      f"{counts} in a stage-1 transition")
            else:
                check(list(counts) == [("all_to_all", "model")]
                      and counts[("all_to_all", "model")][0] == 1,
                      f"a transition sends one all-to-all: {counts}")
    print("  step ms by regime (max over processes): " + "; ".join(
        f"{k} {min(v):.1f}-{max(v):.1f}" for k, v in by_regime.items()),
        flush=True)
    errs = {r["rank"][0]: r["finish"][0] for r in ranks
            if r["finish"][0] is not None}
    print(f"  end: canonical params by stage within {errs} of the emulated",
          flush=True)
    check(len(errs) == 2 and max(errs.values()) <= 1e-5,
          "final canonical params off")
    launches = {k: sum(st["launches"][k] for r in ranks for st in r["steps"])
                for k in PP_RANKS_KERNELS}
    by_proc = {r["rank"]: {k: sum(st["launches"][k] for st in r["steps"])
                           for k in PP_RANKS_KERNELS} for r in ranks}
    print(f"  phase 11: {time.perf_counter() - t_part:.1f} s; launches "
          f"{launches}; by process {by_proc}; unit collectives a step "
          f"(whole mesh) {r0['collectives'][0]}, replicated a process "
          f"{r0['collectives'][1]}", flush=True)
    check(not cuda or all(launches[k] > 0 for k in PP_RANKS_KERNELS),
          f"a kernel of the pp=2 process path never launched: {launches}")
    return launches


# phase 12: NTP with the expert as the partition unit. (A) llama4-scout's
# widths on the emulated mesh; (B) arctic-480b's widths (the reference's
# reduced() expert count) on every other training route; (C) the MoE FFN
# of models/mlp.py at llama4-scout's full FFN widths.
MOE_KERNELS = ("bucket_pack", "bucket_unpack", "reshard_pack")
MOE_LR = 1e-2
# (A): replica 1 loses a GPU before step 2 (TP (3, 4): packing puts it in
# replica 0), repaired before step 4, 6 steps
MOE_A_EVENTS = {2: ("fail", 1), 4: ("repair", 0)}
MOE_A_STEPS, MOE_A_LB, MOE_A_SEQ = 6, 2, 256
# (B): on the (2, 2) mesh, the fail before step 0 and the repair before
# step 1, 2 steps (at pp=2 on stage 1; a first healthy step was cut for the
# script's time)
MOE_B_EVENTS = {0: ("fail", 1), 1: ("repair", 0)}
MOE_B_STEPS, MOE_B_LB, MOE_B_SEQ, MOE_B_MB = 2, 4, 256, 2
# each process's share of the card: 4 processes at pp=1; at pp=2 by stage
# (a stage-1 process under the degraded plan holds its layer at 4 x 4
# expert slots, `head`, and params, accumulated and fresh grads: ~10 GB)
MOE_B_MEMORY_SHARE = {1: (0.2,), 2: (0.10, 0.15)}


def llama4_widths(n_layers=1):
    """The NTP-MoE prototype at llama4-scout's widths (configs/llama4_scout:
    d_model 5120, 8 kv-groups of 5 query heads, head_dim 128, 16 experts of
    d_ff 8192, top-1, vocab 202048), depth cut to ``n_layers``."""
    from repro_torch.configs import get_arch
    from repro_torch.core import ntp_train as nt

    c = get_arch("llama4-scout-17b-a16e")
    return nt.NTPModelConfig(
        d_model=c.d_model, n_kv_groups=c.n_kv_heads,
        q_per_kv=c.n_heads // c.n_kv_heads, head_dim=c.head_dim,
        d_ff=c.d_ff, n_experts=c.moe.n_experts, top_k=c.moe.top_k,
        vocab=c.vocab_size, n_layers=n_layers)


def arctic_widths(n_layers=2):
    """The NTP-MoE prototype at arctic-480b's widths (configs/arctic_480b:
    d_model 7168, 8 kv-groups of 7 query heads, head_dim 128, experts of
    d_ff 4864, top-2, vocab 32000), the expert count cut by the reference's
    `reduced()` rule (128 -> 4, top-2 kept), depth cut to ``n_layers``."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import ntp_train as nt

    c = get_arch("arctic-480b")
    m = reduced(c).moe
    return nt.NTPModelConfig(
        d_model=c.d_model, n_kv_groups=c.n_kv_heads,
        q_per_kv=c.n_heads // c.n_kv_heads, head_dim=c.head_dim,
        d_ff=c.d_ff, n_experts=m.n_experts, top_k=m.top_k,
        vocab=c.vocab_size, n_layers=n_layers)


def _moe_event(events, i, stage=None):
    from repro_torch.runtime import FailureEvent, RecoveryEvent

    kind, replica = events[i]
    cls = FailureEvent if kind == "fail" else RecoveryEvent
    return cls(step=i, replica=replica, stage=stage, n_gpus=1)


def _moe_pp_chain(i):
    """(B)'s chain at pp=2: `MOE_B_EVENTS` on stage 1."""
    return _moe_event(MOE_B_EVENTS, i, stage=1) if i in MOE_B_EVENTS else None


def _ledger_check(cfg, old, new, st):
    """A transition's ledger against its plans: bytes as
    `expected_transfer`'s off-diagonal units x their f32 bytes, units as
    theirs over every layer and leaf, one message per (replica, src, dst)
    pair of the plans (at pp>1 each stage its own, tagged by stage)."""
    import numpy as np

    from repro_torch.reshard.transition import (expected_transfer,
                                                replica_transition_plans)
    from repro_torch.reshard.units import ntp_unit_specs

    want = _expected_bytes(cfg, old, new)
    stages = [(None, old, new)] if getattr(old, "pp", 1) == 1 else [
        ((s,), o, n) for s, (o, n) in enumerate(zip(old.stages, new.stages))
        if o != n]
    pairs, units = set(), 0
    for tag, o, n in stages:
        layers = cfg.n_layers // getattr(old, "pp", 1)
        units += sum(int(m.sum() - np.trace(m)) for m in
                     expected_transfer(cfg, o, n).values()) * layers
        for spec in set(ntp_unit_specs(cfg).values()):
            for d, p in enumerate(replica_transition_plans(spec.k, o, n)):
                pairs |= {(tag or ()) + (d,) + tuple(x) for x in p.pairs}
    check(st["bytes_moved"] == want, f"transition bytes {st} != {want}")
    check(st["moved_units"] == units and st["messages"] == len(pairs),
          f"transition ledger {st} != plans ({units} units, {len(pairs)} "
          "messages)")
    return want


def moe_full_width_part(torch, dev):
    """Phase 12 (A): NTP-MoE at llama4-scout's widths, 1 layer (16 experts,
    top-1), 2 emulated replicas x TP 4, local batch 2, sequence 256, SGD,
    overlap off, through fail (TP (3, 4)) -> repair, 6 steps. The dense
    reference runs first and alone (its losses and final params kept on
    the host), then the session. Checks: every loss within 1e-4 of the
    reference's, both replicas' canonical params within 1e-4 at the end,
    the router unchanged (top-1: the renormalised gate w/w = 1 carries no
    gradient), each transition's ledger equal to its plans', reshard_pack
    launched on the degraded steps only. Returns the session's launches
    and the (3, 4) plan's MLP weight plan for the expert-unit row."""
    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.core.nonuniform import FailurePlan
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    cfg = llama4_widths()
    lb, seq, steps = MOE_A_LB, MOE_A_SEQ, MOE_A_STEPS
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, seq, 2 * lb, seed=0))
    healthy, degraded = FailurePlan(4, (4, 4)), FailurePlan(4, (3, 4))
    fail, repair = sorted(MOE_A_EVENTS)
    plans = [degraded if fail <= i < repair else healthy
             for i in range(steps)]

    def regime(plan):
        return "healthy" if plan.healthy else f"degraded {plan.replica_tp}"

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    t_part = time.perf_counter()
    torch.cuda.empty_cache()
    # the degraded step holds ~70 GB in blocks of many sizes: segments that
    # grow in place keep the freed remainder usable (set back after (A))
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    torch.cuda.reset_peak_memory_stats()
    ref = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    n_par = sum(t.numel() for t in tr.leaves(ref))
    router0 = ref["layers"][0]["router"].clone()
    ref_loss = nt.make_reference_loss(cfg)
    ref_losses, ref_ms = [], []
    for i in range(steps):
        lbs = nt.default_local_batches(plans[i], "ntp", lb)
        mask = torch.tensor(np.concatenate([np.arange(lb) < b for b in lbs]),
                            dtype=torch.float32, device=dev)
        tokens = torch.as_tensor(pipe._batch_np(i), device=dev)

        def ref_step():
            leaves = tr.tree_map(lambda t: t.requires_grad_(True), ref)
            rl = ref_loss(leaves, tokens, mask)
            grads = torch.autograd.grad(rl, tr.leaves(leaves))
            with torch.no_grad():
                for p, gr in zip(tr.leaves(ref), grads):
                    p.requires_grad_(False)
                    p.sub_(gr.mul_(MOE_LR))
            return rl.detach()

        rl, ms = timed(ref_step)
        rl = float(rl)
        ref_losses.append(rl)
        ref_ms.append(ms)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    ref_router_moved = float((ref["layers"][0]["router"] - router0)
                             .abs().max())
    ref_host = [t.cpu() for t in tr.leaves(ref)]
    del ref
    torch.cuda.empty_cache()
    print(f"  (A) llama4-scout widths, 1 layer: {n_par / 1e9:.3f} B canonical"
          f" params f32 ({4 * n_par / 1e9:.2f} GB); the dense reference "
          f"alone: step ms {', '.join(f'{m:.1f}' for m in ref_ms)}, peak "
          f"{ref_peak:.2f} GB allocated; its router moved "
          f"{ref_router_moved:.3e} over {steps} steps", flush=True)

    torch.cuda.reset_peak_memory_stats()
    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    s = NTPSession.create(cfg, (2, 4), local_batch=lb,
                          optimizer=sgd(MOE_LR), params=canon, device=dev)
    del canon
    torch.cuda.empty_cache()
    held = sum(t.numel() * 4 for t in tr.leaves(s.params)) / 1e9
    print(f"  session packed: {held:.2f} GB of params healthy", flush=True)
    mode.reset_launches()
    peaks, step_ms, transitions = {}, {}, []
    for i in range(steps):
        if i in MOE_A_EVENTS:
            old = s.plan
            peaks[regime(old)] = max(peaks.get(regime(old), 0.0),
                                     torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            _, ms = timed(lambda: s.apply(_moe_event(MOE_A_EVENTS, i)))
            # the old packing's blocks go back before the steps under the
            # new one allocate theirs (the degraded step peaks near the
            # card's size)
            torch.cuda.empty_cache()
            st = s.last_transition.as_dict()
            want = _ledger_check(cfg, old, s.plan, st)
            transitions.append((i, old, s.plan, ms, st))
            held = sum(t.numel() * 4 for t in tr.leaves(s.params)) / 1e9
            print(f"  step {i}: {old.replica_tp} -> {s.plan.replica_tp}: "
                  f"transition {ms:.1f} ms, {st['bytes_moved']} B "
                  f"({st['bytes_moved'] / 1e9:.3f} GB) in {st['messages']} "
                  f"messages, {st['moved_units']} units moved (expected "
                  f"{want} B); transition peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; params "
                  f"now {held:.2f} GB", flush=True)
        check(s.plan == plans[i], f"step {i}: plan {s.plan} != {plans[i]}")
        check(list(s.local_batches) == list(nt.default_local_batches(
            plans[i], "ntp", lb)), f"step {i}: local batches differ")
        before = mode.launches()["reshard_pack"]
        m, ms = timed(lambda: s.step(pipe._batch_np(i)))
        packs = mode.launches()["reshard_pack"] - before
        loss = float(m["loss"])
        step_ms.setdefault(regime(s.plan), []).append(ms)
        print(f"  step {i} ({regime(s.plan)}): loss {loss:.6f} reference "
              f"{ref_losses[i]:.6f} |diff| {abs(loss - ref_losses[i]):.2e}; "
              f"{ms:.1f} ms; reshard_pack launches {packs}", flush=True)
        check(np.isfinite(loss) and abs(loss - ref_losses[i]) < 1e-4,
              f"step {i}: loss off the dense reference")
        check((packs > 0) == (not s.plan.healthy),
              f"step {i}: {packs} reshard_pack launches in a "
              f"{regime(s.plan)} step")
    peaks[regime(s.plan)] = max(peaks.get(regime(s.plan), 0.0),
                                torch.cuda.max_memory_allocated() / 1e9)
    launches = mode.launches()
    errs, moved = [], 0.0
    for r in range(2):
        got = s.canonical_params(r)
        errs.append(max(float((a - b.to(dev)).abs().max())
                        for a, b in zip(tr.leaves(got), ref_host)))
        moved = max(moved, float((got["layers"][0]["router"] - router0)
                                 .abs().max()))
        del got
    print(f"  canonical params vs the dense reference: replica 0 "
          f"{errs[0]:.3e}, replica 1 {errs[1]:.3e} (tol 1e-4); the router "
          f"moved {moved:.3e} (top-1)", flush=True)
    check(max(errs) < 1e-4, "canonical params diverged")
    check(moved < 1e-6, "the top-1 router moved")
    print("  step ms by regime: " + "; ".join(
        f"{k} " + ", ".join(f"{v:.1f}" for v in vs)
        for k, vs in step_ms.items()) + "; peak allocated by regime "
        + "; ".join(f"{k} {v:.2f} GB" for k, v in peaks.items())
        + f"; reference {ref_peak:.2f} GB", flush=True)
    print(f"  (A): {time.perf_counter() - t_part:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    check(all(launches[k] > 0 for k in ("reshard_pack",)),
          f"reshard_pack never launched: {launches}")
    del s, ref_host
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    return launches, cfg, degraded


def expert_reshard_row(torch, dev, cfg, plan):
    """reshard_pack at the expert unit, the widest row any path gathers
    (one row = one expert's A, d_model x d_ff elems): the pre-sync reshard
    of phase 12 (A)'s A gradient under the degraded plan, all 4 ranks of
    the replica that sends the most rows in one launch, as the emulated
    sync runs it; bit-exact against the plain version and timed in turns
    against `src[idx]` and `index_select` (one call a CUDA graph: each
    output is GBs)."""
    from repro_torch.core import nonuniform as nu
    from repro_torch.kernels import ref
    from repro_torch.kernels.reshard_pack import reshard_pack_cost, \
        reshard_pack_ranks

    tables = nu.weight_plan(cfg.k_ff, plan).pre
    elems = cfg.d_model * cfg.ffu
    t = max((tables.replica(d) for d in range(plan.d)),
            key=lambda t: int((t.send_idx != t.pad).sum()))
    n, up1 = t.n, t.buf + 1
    g = torch.Generator(device=dev).manual_seed(7)
    xp = torch.randn((n, up1, elems), generator=g, device=dev)
    xp[:, -1] = 0
    ix = torch.as_tensor(t.send_idx, device=dev)
    got = reshard_pack_ranks(xp, ix)
    torch.cuda.synchronize()
    check(torch.equal(got, ref.reshard_pack_ranks_ref(xp, ix)),
          "reshard_pack at the expert unit is not bit-exact")
    del got
    torch.cuda.empty_cache()
    plain = time_ms(lambda: ref.reshard_pack_ranks_ref(xp, ix), 3)
    lidx = ix.long()
    rk = torch.arange(n, device=dev)[:, None, None]
    flat = (lidx + rk * up1).flatten()
    tm = in_turns(torch, lambda: reshard_pack_ranks(xp, ix), {
        "src[idx]": lambda: xp[rk, lidx],
        "index_select": lambda: torch.index_select(
            xp.view(-1, elems), 0, flat).view(*ix.shape, elems)},
        reps=3, calls=1)
    n_read = sum(len({int(u) for u in t.send_idx[r].flatten()
                      if u != t.pad}) for r in range(n))
    bd = bound_ms(reshard_pack_cost(ix.numel(), elems, 4, n_read), "float32")
    report_turns("reshard_pack", f"expert unit, all {n} ranks "
                 f"src{tuple(xp.shape)} idx{tuple(ix.shape)}", "float32",
                 0.0, 0.0, tm, plain, bd)
    row = table_row(0.0, tm, plain, bd)
    del xp, ix
    torch.cuda.empty_cache()
    return row


def _moe_b_plans(pp, steps):
    """The plan of each step of (B)'s chain: TP (1, 2) (at pp=2 on stage
    1) from the failure to the repair, healthy otherwise."""
    from repro_torch.core.nonuniform import FailurePlan, StagedPlan

    healthy, degraded = FailurePlan(2, (2, 2)), FailurePlan(2, (1, 2))
    fail, repair = sorted(MOE_B_EVENTS)
    plans = [degraded if fail <= i < repair else healthy for i in range(steps)]
    if pp == 1:
        return plans
    return [StagedPlan((healthy, plan)) for plan in plans]


def _moe_emulated(torch, dev, cfg, pp):
    """Phase 12 (B), emulated: at pp=1 sessions with overlap on and off
    through `MOE_B_EVENTS` (2 steps); at pp=2 (one layer a stage,
    microbatches 2, overlap on) through the same chain on stage 1. The
    dense reference runs first, on the chain's local batches, and keeps its
    losses and final params on the host; then each session runs alone and
    is held to it (losses 1e-4, both replicas' canonical params 1e-4; on
    against off 1e-5). Returns the overlap-on session's losses, local
    batches, ledgers, step ms, each layer's router at the end and at the
    start."""
    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    steps = MOE_B_STEPS
    plans = _moe_b_plans(pp, steps)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, MOE_B_SEQ, 2 * MOE_B_LB,
                                          seed=0))

    def canonical():
        return nt.init_canonical(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    ref = canonical()
    routers0 = [lp["router"].to("cpu", copy=True) for lp in ref["layers"]]
    ref_loss = nt.make_reference_loss(cfg)
    ref_losses = []
    for i in range(steps):
        lbs = nt.default_local_batches(plans[i], "ntp", MOE_B_LB)
        mask = torch.tensor(np.concatenate(
            [np.arange(MOE_B_LB) < b for b in lbs]), dtype=torch.float32,
            device=dev)
        leaves = tr.tree_map(lambda t: t.requires_grad_(True), ref)
        rl = ref_loss(leaves, torch.as_tensor(pipe._batch_np(i), device=dev),
                      mask)
        grads = torch.autograd.grad(rl, tr.leaves(leaves))
        with torch.no_grad():
            for p, gr in zip(tr.leaves(ref), grads):
                p.requires_grad_(False)
                p.sub_(gr.mul_(MOE_LR))
        del grads, leaves
        ref_losses.append(float(rl.detach()))
    ref_host = [t.cpu() for t in tr.leaves(ref)]
    del ref
    torch.cuda.empty_cache()

    runs, errs = {}, {}
    for o in ((True, False) if pp == 1 else (True,)):
        canon = canonical()
        kw = dict(pp=2, microbatches=MOE_B_MB) if pp > 1 else {}
        s = NTPSession.create(cfg, (2, 2), overlap=o, local_batch=MOE_B_LB,
                              optimizer=sgd(MOE_LR), params=canon,
                              device=dev, **kw)
        del canon
        out = {"loss": [], "local_batches": [], "ledgers": [], "ms": []}
        for i in range(steps):
            ev = _moe_event(MOE_B_EVENTS, i) if pp == 1 and \
                i in MOE_B_EVENTS else (_moe_pp_chain(i) if pp == 2 else None)
            if ev is not None:
                old = s.plan
                s.apply(ev)
                st = s.last_transition.as_dict()
                _ledger_check(cfg, old, s.plan, st)
                out["ledgers"].append((old, s.plan, st))
            check(s.plan == plans[i], f"(B) step {i}: plan {s.plan}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(s.step(pipe._batch_np(i))["loss"])
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["loss"].append(loss)
            out["local_batches"].append(tuple(s.local_batches))
            check(list(s.local_batches) == list(nt.default_local_batches(
                plans[i], "ntp", MOE_B_LB)), f"(B) step {i}: local batches")
            check(abs(loss - ref_losses[i]) < 1e-4,
                  f"(B) pp={pp} step {i}: loss {loss} off the reference "
                  f"{ref_losses[i]}")
        for r in range(2):
            got = s.canonical_params(r)
            errs[(o, r)] = max(float((a - b.to(dev)).abs().max())
                               for a, b in zip(tr.leaves(got), ref_host))
            del got
        out["router"] = [lp["router"].cpu() for lp in s.params["layers"]]
        runs[o] = out
        del s
        torch.cuda.empty_cache()
    out = runs[True]
    if False in runs:
        d = max(abs(a - b) for a, b in zip(out["loss"], runs[False]["loss"]))
        check(d < 1e-5, f"(B) overlap on and off disagree by {d}")
    check(max(errs.values()) < 1e-4, f"(B) pp={pp}: canonical params {errs}")
    out["router0"] = routers0
    moved = max(float((a - b).abs().max())
                for a, b in zip(out["router"], routers0))
    print(f"  (B) emulated pp={pp} x (2, 2)"
          + (" overlap on/off" if pp == 1 else
             f", microbatches {MOE_B_MB}, overlap on")
          + f": losses {', '.join(f'{x:.5f}' for x in out['loss'])} (each "
          f"within 1e-4 of the dense reference, run first); canonical params"
          f" within {max(errs.values()):.2e}; routers moved {moved:.3e} "
          f"(top-2); step ms on " + ", ".join(f"{m:.1f}" for m in out["ms"])
          + ("; off " + ", ".join(f"{m:.1f}" for m in runs[False]["ms"])
             if False in runs else ""), flush=True)
    check(moved > 0, "(B) the top-2 router did not train")
    return out


def moe_rank_worker(cfg, pp, device):
    """Phase 12 (B3/B4): one process of a (2, 2) gloo mesh on the card
    (pp=1, overlap on, `MOE_B_EVENTS`) or of a pp=2 x (2, 2) staged mesh
    (overlap on, microbatches 2, the stage-1 chain), its share drawn from
    the seed; per step its loss, its kernel launches and its host-clock ms,
    per event its ledger; its routers at the end."""
    import torch

    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.kernels import mode
    from repro_torch.launch.mesh import make_staged_mesh, make_test_mesh
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    if pp == 1:
        mesh = make_test_mesh(2, 2, backend="gloo", device=device)
    else:
        mesh = make_staged_mesh(2, 2, 2, backend="gloo", device=device)
    dev, cuda = mesh.device, mesh.device.type == "cuda"
    if cuda:
        torch.cuda.set_per_process_memory_fraction(
            MOE_B_MEMORY_SHARE[pp][mesh.stage], dev)
        torch.cuda.reset_peak_memory_stats(dev)
    canon = nt.init_canonical(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev, pp=pp,
                              stage=mesh.stage if pp > 1 else None)
    kw = dict(pp=2, microbatches=MOE_B_MB) if pp > 1 else {}
    s = NTPSession.create(cfg, mesh, local_batch=MOE_B_LB,
                          optimizer=sgd(MOE_LR), params=canon, overlap=True,
                          **kw)
    del canon
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, MOE_B_SEQ, 2 * MOE_B_LB,
                                          seed=0))
    steps = MOE_B_STEPS
    out = {"loss": [], "launches": [], "ms": [], "ledgers": [],
           "local_batches": [], "regime": []}
    mode.reset_launches()
    for i in range(steps):
        ev = _moe_event(MOE_B_EVENTS, i) if pp == 1 and i in MOE_B_EVENTS \
            else (_moe_pp_chain(i) if pp == 2 else None)
        if ev is not None:
            old = s.plan
            s.apply(ev)
            out["ledgers"].append((old, s.plan,
                                   s.last_transition.as_dict()))
            _release_host_cache(torch)
        before = mode.launches()
        _sync(torch, dev)
        t0 = time.perf_counter()
        out["loss"].append(float(s.step(pipe._batch_np(i))["loss"]))
        _sync(torch, dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        after = mode.launches()
        out["launches"].append({k: after[k] - before[k]
                                for k in MOE_KERNELS})
        out["local_batches"].append(tuple(s.local_batches))
        out["regime"].append(_regime(s))
    out["total_launches"] = {k: mode.launches()[k] for k in MOE_KERNELS}
    # numpy, not tensors: a tensor in the result would be shared through a
    # file descriptor that dies with this process
    out["router"] = {li: lp["router"].cpu().numpy()
                     for li, lp in enumerate(s.params["layers"]) if lp}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda \
        else 0.0
    out["rank"] = (mesh.stage, mesh.replica, mesh.rank)
    return out


def _predicted_launches(cfg, pp, stage, degraded):
    """bucket_pack / bucket_unpack / reshard_pack launches of one process's
    overlapped step: per chunk of its layers (one a layer at pp=1; its
    stage's one layer at pp=2) two unit buckets and one rep
    bucket packed and unpacked, and each unit bucket resharded pre and
    post when its stage is degraded."""
    from repro_torch.core.overlap import chunk_ranges

    chunks = chunk_ranges(cfg.n_layers, pp)
    mine = len(chunks) if pp == 1 else 1
    hit = degraded if pp == 1 else degraded and stage == 1
    return {"bucket_pack": 3 * mine, "bucket_unpack": 3 * mine,
            "reshard_pack": 4 * mine if hit else 0}


def moe_ranks_part(torch, dev, cfg, pp, want):
    """Phase 12 (B3) at pp=1 / (B4) at pp=2: the processes against the
    emulated overlap-on session's run ``want``: every loss within 1e-5,
    local batches and ledgers equal, each transition's bytes as its plans',
    the routers within 1e-6 of the emulated session's at the end (and moved
    from the start); launches a process a step as predicted. Returns the
    processes' launches summed."""
    from repro_torch.launch.spawn import spawn

    n = 4 * pp
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = RANK_ALLOC_CONF
    t0 = time.perf_counter()
    try:
        ranks = spawn(moe_rank_worker, n, backend="gloo", device=dev.type,
                      deadline_s=600, args=(cfg, pp, dev.type))
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    wall = time.perf_counter() - t0
    where = "(2, 2) mesh" if pp == 1 else "pp=2 x (2, 2) staged mesh"
    err = max(abs(a - b) for r in ranks for a, b in zip(r["loss"],
                                                         want["loss"]))
    check(err <= 1e-5, f"(B) {where}: losses off the emulated by {err}")
    for r in ranks:
        check(r["local_batches"] == want["local_batches"],
              f"process {r['rank']}: local batches differ")
        check([st for _, _, st in r["ledgers"]]
              == [st for _, _, st in want["ledgers"]],
              f"process {r['rank']}: ledgers differ from the emulated")
        for old, new, st in r["ledgers"]:
            _ledger_check(cfg, old, new, st)
        for i, l in enumerate(r["launches"]):
            pred = _predicted_launches(cfg, pp, r["rank"][0],
                                       "degraded" in r["regime"][i])
            check(dev.type != "cuda" or l == pred,
                  f"process {r['rank']} step {i}: launches {l} != {pred}")
    r_err = max(float((torch.from_numpy(v) - want["router"][li]).abs().max())
                for r in ranks for li, v in r["router"].items())
    moved = min(float((torch.from_numpy(v) - want["router0"][li]).abs().max())
                for r in ranks for li, v in r["router"].items())
    # the routers moved by more than ten times their distance from the
    # emulated session's, so a router sync that missed the model group's
    # share would show
    check(r_err <= 1e-6 and moved > 10 * r_err,
          f"(B) {where}: routers {r_err} off the emulated, moved {moved}")
    by_regime = {}
    for i, regime in enumerate(ranks[0]["regime"]):
        by_regime.setdefault(regime, []).append(
            max(r["ms"][i] for r in ranks))
    launches = {k: sum(r["total_launches"][k] for r in ranks)
                for k in MOE_KERNELS}
    print(f"  (B) {n} gloo processes on a {where}: spawned, run and joined "
          f"in {wall:.1f} s; losses within {err:.3e} of the emulated; "
          f"routers within {r_err:.3e} (moved >= {moved:.3e}); ledgers "
          + "; ".join(f"{o.replica_tp if pp == 1 else o.stage_tp} -> "
                      f"{nw.replica_tp if pp == 1 else nw.stage_tp} "
                      f"{st['bytes_moved']} B"
                      for o, nw, st in ranks[0]["ledgers"])
          + "; step ms by regime (max over processes) " + "; ".join(
              f"{k} " + ", ".join(f"{v:.1f}" for v in vs)
              for k, vs in by_regime.items())
          + f"; launches a step on process {ranks[-1]['rank']} by regime "
          + "; ".join(sorted({f"{g}: {l}" for g, l in zip(
              ranks[-1]["regime"], ranks[-1]["launches"])}))
          + "; peak allocated "
          f"{max(r['peak_gb'] for r in ranks):.2f} GB a process", flush=True)
    return launches


def moe_ffn_part(torch, dev):
    """Phase 12 (C): `models.mlp.moe_apply` at llama4-scout's full FFN
    widths (d 5120, 16 experts of d_ff 8192, gated SiLU, the shared
    expert; weights f32 from a seed on the card), B x S = 8 x 16: against
    `moe_apply_dense_ref` at drop-free capacity (8.0) within 1e-4 with its
    aux loss, then the slots dropped at the published 1.25."""
    from repro_torch.configs import get_arch
    from repro_torch.models import mlp

    cfg = get_arch("llama4-scout-17b-a16e")
    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    p = mlp.moe_init(cfg, torch.Generator(device=dev).manual_seed(0),
                     torch.float32)
    gb = sum(t.numel() * 4 for t in _leaves(p)) / 1e9
    x = torch.randn((8, 16, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    got, aux = mlp.moe_apply(free, p, x)
    want = mlp.moe_apply_dense_ref(free, p, x)
    err = float((got - want).abs().max())
    ms = time_ms(lambda: mlp.moe_apply(free, p, x), 5)
    ref_ms = time_ms(lambda: mlp.moe_apply_dense_ref(free, p, x), 5)
    dropped = mlp.dropped_slots(cfg, p, x)
    out, _ = mlp.moe_apply(cfg, p, x)
    print(f"  (C) moe_apply at llama4-scout's FFN widths ({gb:.2f} GB f32): "
          f"max |moe_apply - moe_apply_dense_ref| {err:.3e} (tol 1e-4) at "
          f"capacity 8.0 ({mlp.dropped_slots(free, p, x)} slots dropped), aux"
          f" loss {float(aux['moe_aux_loss']):.6f}; {ms:.3f} ms a call, the "
          f"dense oracle {ref_ms:.3f} ms; at the published 1.25: {dropped} of"
          f" {8 * 16 * cfg.moe.top_k} slots dropped, output finite "
          f"{bool(torch.isfinite(out).all())}", flush=True)
    check(err < 1e-4 and float(aux["moe_aux_loss"]) >= 0
          and mlp.dropped_slots(free, p, x) == 0, "(C) moe_apply is off")
    check(bool(torch.isfinite(out).all()), "(C) non-finite output at 1.25")
    del p, x, got, want, out
    torch.cuda.empty_cache()


def moe_phase(torch, dev):
    """Phase 12: (A), the expert-unit reshard_pack row, (B) and (C).
    Returns the launches of (A) and (B), and the expert-unit row."""
    t0 = time.perf_counter()
    launches, cfg_a, degraded = moe_full_width_part(torch, dev)
    row = expert_reshard_row(torch, dev, cfg_a, degraded)
    from repro_torch.core import ntp_train as nt

    t_b = time.perf_counter()
    # one layer at pp=1 (cut from 2 for the script's time), one a stage at
    # pp=2
    for pp in (1, 2):
        cfg = arctic_widths(pp)
        n_par = sum(t.numel() for t in _leaves(nt.canonical_like(cfg)))
        print(f"  (B) arctic-480b widths, {cfg.n_experts} experts top-"
              f"{cfg.top_k}, {cfg.n_layers} layers (pp={pp}): "
              f"{n_par / 1e9:.3f} B canonical params f32 "
              f"({4 * n_par / 1e9:.2f} GB)", flush=True)
        want = _moe_emulated(torch, dev, cfg, pp)
        got = moe_ranks_part(torch, dev, cfg, pp, want)
        launches = {k: launches[k] + got[k] for k in MOE_KERNELS}
    print(f"  (B): {time.perf_counter() - t_b:.1f} s", flush=True)
    moe_ffn_part(torch, dev)
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches, row


# phase 13: MoE serving at full width, on phase 4's kernels, sessions and
# traffic (replicas 1, n1 4, 8 slots, max_len 96, prefill 32)
MOE_SERVE_KW = dict(replicas=1, n1=4, slots=8, max_len=96, prefill_len=32,
                    policy="ntp_pw")
# depth a model keeps: llama4-scout one full pattern period (3 chunked + 1
# global layer), arctic-480b the one layer whose 128 experts fit the card
MOE_SERVE_LAYERS = {"llama4-scout-17b-a16e": 4, "arctic-480b": 1}


def moe_serve_widths(arch):
    """``arch`` at full width, its depth cut to `MOE_SERVE_LAYERS`."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch),
                               n_layers=MOE_SERVE_LAYERS[arch])


def moe_serve_traffic(cfg):
    """Phase 4's traffic: 24 requests of 24 tokens (seed 0), request i
    arriving at tick i, and fail, fail, repair, repair at ticks 10, 14,
    40, 48 (TP 4 -> 3 -> 2 -> 3 -> 4)."""
    import numpy as np

    from repro_torch.runtime import FailureEvent, RecoveryEvent

    rng = np.random.default_rng(0)
    requests = [rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
                for _ in range(24)]
    events = {10: FailureEvent(domain=0), 14: FailureEvent(domain=0),
              40: RecoveryEvent(domain=0), 48: RecoveryEvent(domain=0)}
    return requests, events


def drop_free(cfg):
    """``cfg`` at ``capacity_factor = E/k``: no expert can get more slots
    than its capacity, so no MoE call drops (a check, not a default)."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


@contextlib.contextmanager
def prefill_drops():
    """Counts, into the yielded list, the (token, pick) slots each
    multi-token `moe_apply` call (a prefill's MoE FFN) drops, by
    `mlp.dropped_slots` on its input; decode ticks and one-token steps
    never drop and are not counted."""
    from repro_torch.models import mlp

    drops, plain = [], mlp.moe_apply

    def counted(cfg, p, x):
        if x.shape[0] * x.shape[1] > 1:
            drops.append(mlp.dropped_slots(cfg, p, x))
        return plain(cfg, p, x)

    mlp.moe_apply = counted
    try:
        yield drops
    finally:
        mlp.moe_apply = plain


def _kv_ledger_check(cfg, engine, st):
    """A KV-head transition's bytes: the heads its plan moves times one
    head's bytes summed over every leaf of the cache (every group, ring
    or full), as `reshard.state.ShardedState` counts them."""
    from repro_torch.reshard import planner

    k, n1 = cfg.n_kv_heads, engine.n1
    plan = planner.transition_plan(planner.sync_key(k, n1, st["tp_from"]),
                                   planner.sync_key(k, n1, st["tp_to"]), k, k)
    head = sum(t.numel() // k * t.element_size()
               for t in engine.cache.values())
    check(st["bytes_moved"] == plan.n_moved * head,
          f"TP {st['tp_from']}->{st['tp_to']}: {st['bytes_moved']} B moved, "
          f"the plan's {plan.n_moved} heads x {head} B")
    return plan.n_moved


def _picked_experts(torch, model, params, cache, toks, pos):
    """Distinct experts the tick's slots pick, per MoE layer (one decode
    tick on a copy of ``cache`` with `mlp._route` observed)."""
    from repro_torch.models import mlp

    picked, route = [], mlp._route

    def seen(m, logits):
        idx, w, probs = route(m, logits)
        picked.append(int(torch.unique(idx).numel()))
        return idx, w, probs

    mlp._route = seen
    try:
        model.decode_slots(params, {n: t.clone() for n, t in cache.items()},
                           toks, pos)
    finally:
        mlp._route = route
    return picked


def moe_serve_model(torch, dev, cfg, requests, events, ref_layers=0):
    """Phase 13 for one model: a session drawn on ``dev`` (seed 0), then
    (a) at drop-free capacity and (b) at the published one, each a
    fail -> repair session and an uninterrupted one on the same weights.
    Checks: TP path [3, 2, 3, 4] with preemptions; every request complete
    with 16 tokens; each transition's bytes as its plan's KV heads; (a)
    the 24 streams equal the uninterrupted run's and no prefill drops a
    slot; every kernel of the path launched in (b)'s fail -> repair run.
    Prints (b)'s dropped prefill slots and equal streams. The first
    ``ref_layers`` layers are held against the CPU's plain versions first
    (`layers_reference`). Returns (launches and flash launches by kind of (b)'s fail -> repair run, the
    uninterrupted (b) session, the params count)."""
    from repro_torch.kernels import mode
    from repro_torch.serve import ServeSession

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base = ServeSession.create(cfg, seed=0, device=dev, **MOE_SERVE_KW)
    params = base.params
    _sync(torch, dev)
    n_par = sum(t.numel() for t in _leaves(params))
    mem = (f"; device memory allocated "
           f"{torch.cuda.memory_allocated() / 1e9:.2f} GB"
           if dev.type == "cuda" else "")
    m = cfg.moe
    print(f"  {cfg.arch_id} at full width, {cfg.n_layers} layer(s) "
          f"{cfg.layer_pattern[:cfg.n_layers]}, {m.n_experts} experts "
          f"top-{m.top_k}: {n_par / 1e9:.3f} B params f32 "
          f"({n_par * 4 / 1e9:.2f} GB) drawn in {time.perf_counter() - t0:.1f}"
          f" s{mem}", flush=True)
    if ref_layers:
        layers_reference(torch, dev, cfg, params, ref_layers)
    del base
    out = {}
    for label, c in (("drop-free", drop_free(cfg)), ("published", cfg)):
        session = ServeSession.create(c, params=params, device=dev,
                                      **MOE_SERVE_KW)
        clean = ServeSession.create(c, params=params, device=dev,
                                    **MOE_SERVE_KW)
        print(f"  ({'a' if label == 'drop-free' else 'b'}) capacity factor "
              f"{c.moe.capacity_factor:g} ({label}):", flush=True)
        with prefill_drops() as drops:
            mode.reset_launches()
            got, ticks, wall = serve(session, requests, events)
            launches = (mode.launches(), mode.variant_launches())
            n_drop, n_pre = sum(drops), len(drops)
            want, cticks, cwall = serve(clean, requests, {})
            c_drop = sum(drops) - n_drop
        e = session.engines[0]
        tps = [t["tp_to"] for t in session.transitions]
        moved = [_kv_ledger_check(c, e, t["reshard"])
                 for t in session.transitions]
        equal = sum(got.get(r) == want[r] for r in want)
        print(f"    fail->repair: {len(got)} requests, {e.stats['tokens']} "
              f"tokens in {ticks} ticks, {wall:.2f} s "
              f"({e.stats['tokens'] / wall:.1f} tokens/s); TP path {tps}, "
              f"preemptions {e.stats['preemptions']}, KV heads moved "
              f"{moved}; uninterrupted: {cticks} ticks, {cwall:.2f} s; "
              f"streams equal {equal} of {len(want)}; dropped prefill slots "
              f"{n_drop} over {n_pre} MoE prefill calls (uninterrupted "
              f"{c_drop})", flush=True)
        check(tps == [3, 2, 3, 4], f"TP path {tps} != [3, 2, 3, 4]")
        check(e.stats["preemptions"] > 0, "no preemption happened")
        for run in (got, want):
            check(len(run) == len(requests)
                  and all(len(t) == 16 for t in run.values()),
                  "not every request completed with 16 tokens")
        if label == "drop-free":
            check(equal == len(want), f"drop-free streams diverged: "
                  f"{[r for r in want if got.get(r) != want[r]]}")
            check(n_drop == 0 and c_drop == 0,
                  f"a prefill dropped slots at drop-free capacity")
        out[label] = launches
        del session, e
    if dev.type == "cuda":
        print(f"  {cfg.arch_id}: peak device memory allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return out["published"], clean, n_par


def moe_serve_tick(torch, dev, cfg, clean, n_par):
    """Phase 13 (c): one decode tick of the served model at 8 slots (random
    tokens, positions 40-47), CUDA events and torch.profiler, beside two
    floors at 3.35 TB/s: every weight read, and only the experts the tick's
    slots pick (the rest of the weights read once)."""
    eng = clean.engines[0]
    g = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(1, cfg.vocab_size, (8,), generator=g, device=dev)
    pos = torch.arange(8, device=dev) + 40
    picked = _picked_experts(torch, eng.model, eng.params, eng.cache, toks,
                             pos)
    m = cfg.moe
    expert = (3 if cfg.ffn_gated else 2) * cfg.d_model * cfg.d_ff
    n_moe = len(picked)
    floor_all = n_par * 4 / MEM_BW * 1e3
    floor_picked = ((n_par - n_moe * m.n_experts * expert
                     + sum(picked) * expert) * 4 / MEM_BW * 1e3)
    tick_ms = time_ms(lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                     toks, pos), 10)
    print(f"  (c) decode tick, 8 slots: {tick_ms:.3f} ms; floors: every "
          f"weight read {floor_all:.3f} ms ({n_par * 4 / 1e9:.2f} GB), only "
          f"the picked experts {floor_picked:.3f} ms (distinct experts a "
          f"layer {picked} of {m.n_experts})", flush=True)
    profile_steps(torch, lambda: eng.model.decode_slots(eng.params, eng.cache,
                                                        toks, pos),
                  "decode tick")
    return tick_ms


def moe_serve_rows(torch, F, dev):
    """This path's kernel shapes, in phase 3's form: flash_attention at
    llama4-scout's prefill (q (1, 40, 32, 128), kv 8; chunked 8192 and
    causal) and arctic-480b's (q (1, 56, 32, 128), kv 8, causal), f32,
    timed in turns with SDPA (the chunked mask passed as a boolean mask);
    reshard_pack at the TP 4->3 KV-head transition of each model's slot
    cache (8 heads over n1 = 4; one row = every leaf's head: 2 x 4 layers
    x 8 slots x 96 x 128 for llama4-scout, 2 x 1 x 8 x 96 x 128 for
    arctic-480b), against `src[idx]` and `index_select`."""
    from repro_torch.core import shard_mapping as sm
    from repro_torch.kernels import ref
    from repro_torch.kernels.reshard_pack import reshard_pack_ranks

    g = torch.Generator(device=dev).manual_seed(1313)
    rows = {}
    for arch, h, kind in (("llama4-scout", 40, "chunked"),
                          ("llama4-scout", 40, "causal"),
                          ("arctic-480b", 56, "causal")):
        rows[f"flash_attention {arch} {kind}"] = flash_row(
            torch, F, dev, g, torch.float32, (1, h, 8, 32, 128), kind,
            label=f"{arch} ")
    tables = sm.reshard_tables(sm.sync_layout(8, 4, 4),
                               sm.sync_layout(8, 4, 3), 4)
    for arch, layers in (("llama4-scout", 4), ("arctic-480b", 1)):
        xp = torch.randn((tables.n, tables.buf + 1, 2 * layers * 8 * 96 * 128),
                         generator=g, device=dev)
        xp[:, -1] = 0
        idx = torch.as_tensor(tables.send_idx, device=dev)
        rows[f"reshard_pack {arch}"] = reshard_call(
            torch, dev, f"{arch} kv_head all 4 ranks", xp, idx,
            reshard_pack_ranks, ref.reshard_pack_ranks_ref, tables.send_idx,
            tables.pad, range(tables.n), "float32")
        del xp
    torch.cuda.empty_cache()
    return rows


def moe_serve_phase(torch, F, dev):
    """Phase 13: MoE serving at full width on the card. llama4-scout (4
    layers: 3 `attn_chunked` + 1 global, 16 experts top-1 and the shared
    expert) with the one-layer reference first, then arctic-480b (1 layer,
    all 128 experts top-2 and the dense residual FFN), each through
    `moe_serve_model` and `moe_serve_tick`, one model on the card at a
    time; then this path's kernel rows. Checks every kernel of the path
    launched in the published fail -> repair runs, flash_attention with
    the chunked mask among them. Returns (launches summed over both
    models' published fail -> repair runs, the rows)."""
    t0 = time.perf_counter()
    launches, variants = dict.fromkeys(SERVE_KERNELS, 0), {}
    for arch in MOE_SERVE_LAYERS:
        cfg = moe_serve_widths(arch)
        # llama4-scout's first layer (an `attn_chunked` block with the MoE
        # FFN and its shared expert) against the CPU's plain versions
        (counts, kinds), clean, n_par = moe_serve_model(
            torch, dev, cfg, *moe_serve_traffic(cfg),
            ref_layers=int(arch.startswith("llama4")))
        moe_serve_tick(torch, dev, cfg, clean, n_par)
        print(f"  {arch} kernels {json.dumps(counts)} flash by mask "
              f"{json.dumps(kinds)}; {time.perf_counter() - t0:.1f} s so far",
              flush=True)
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
        for k, n in kinds.items():
            variants[k] = variants.get(k, 0) + n
        del clean
        torch.cuda.empty_cache()
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"a kernel of the MoE serving path never launched: {launches}")
    check(variants.get("flash_attention:chunked", 0) > 0
          and variants.get("flash_attention:causal", 0) > 0,
          f"flash_attention did not run both masks: {variants}")
    rows = moe_serve_rows(torch, F, dev)
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launches)}, flash by mask {json.dumps(variants)}",
          flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# phase 15: the serving lifecycle and the dense attention archs

DENSE_SERVE_KW = dict(replicas=2, n1=4, slots=8, max_len=96, prefill_len=32,
                      policy="ntp_pw", quarantine=True)
# the mixed chain, by router tick: (a class of `repro_torch.runtime`, its
# fields), or "save" (the session's checkpoint, restored in the restore
# check); tests/test_torch_serve_lifecycle.py runs it against the JAX
# package's session
DENSE_CHAIN = {
    4: ("FailureEvent", dict(domain=0)),
    6: ("StragglerEvent", dict(domain=1, slowdown=1.5)),
    8: ("SdcSuspectEvent", dict(domain=1)),
    10: ("save", {}),
    12: ("LinkDegradeEvent", dict(domain=0, bw_frac=0.5)),
    14: ("SdcClearEvent", dict(domain=1)),
    16: ("StragglerClearEvent", dict(domain=1, slowdown=1.5)),
    17: ("LinkRepairEvent", dict(domain=0, bw_frac=0.5)),
    18: ("RecoveryEvent", dict(domain=0)),
}
# (B): each arch's fail -> repair, one arrival a tick
DENSE_ARCH_CHAIN = {3: ("FailureEvent", dict(domain=0)),
                    9: ("RecoveryEvent", dict(domain=0))}
DENSE_ARCH_KW = dict(replicas=1, n1=4, slots=8, max_len=96, prefill_len=32,
                     policy="ntp_pw")
DENSE_ARCHS = ("granite-3-2b", "minitron-4b", "chameleon-34b")
DENSE_ARCH_LAYERS = 2          # (B)'s depth
DENSE_CHAIN_LAYERS = 22        # (A)'s depth, of gemma2-9b's 42 (for time)
DENSE_REF_LAYERS = 2           # (A)'s layers held against the CPU


def dense_traffic(cfg, n=32, prompt_len=24):
    """``n`` prompts of ``prompt_len`` tokens (seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, size=prompt_len).astype(np.int32)
            for _ in range(n)]


def chain_serve(session, router, request_cls, runtime, prompts, *,
                max_new=16, per_tick=4, chain=DENSE_CHAIN, save=None,
                enc=None, apply=None):
    """Drive ``session`` through ``router``: request i arrives at tick
    i // ``per_tick`` (with ``enc[i]`` as its ``enc_input`` when ``enc``
    is given); at a tick of ``chain`` its event (a class of the
    ``runtime`` module, so the tests run the JAX package's session through
    the same chain) is applied before the tick's dispatch, and a "save"
    entry calls ``save(session, router)``; ``apply`` (an event → the
    requests it preempted) stands in for ``session.apply``, e.g. a probe
    around each event. Returns a dict: ``streams``
    {rid: tokens}, ``ticks``, ``wall`` s, ``preempted`` [(tick, event,
    requests preempted)], ``admits`` [(tick, prefills a replica)] and
    ``draining`` [(tick, flag a replica)]."""
    pending = [request_cls(rid=i, prompt=p, max_new=max_new)
               for i, p in enumerate(prompts)]
    for r, x in zip(pending, enc or ()):
        r.enc_input = x
    out = dict(preempted=[], admits=[], draining=[])
    t0 = time.perf_counter()
    tick = 0
    while pending or router.queue or any(e.n_active for e in session.engines):
        while pending and pending[0].rid // per_tick <= tick:
            router.submit(pending.pop(0))
        if tick in chain:
            name, kw = chain[tick]
            if name == "save":
                save(session, router)
            else:
                pre = (apply or session.apply)(getattr(runtime, name)(**kw))
                router.requeue(pre)
                out["preempted"].append((tick, name, len(pre)))
        before = [e.stats["prefills"] for e in session.engines]
        router.step()
        out["admits"].append((tick, tuple(
            e.stats["prefills"] - b for e, b in zip(session.engines, before))))
        out["draining"].append((tick, tuple(e.draining
                                            for e in session.engines)))
        tick += 1
        check(tick < 2000, "serving did not converge")
    out.update(streams={r.rid: list(r.generated) for r in router.completed},
               ticks=tick, wall=time.perf_counter() - t0)
    return out


def chain_checks(run, clean, n_requests, max_new):
    """(A)'s checks on a `chain_serve` run through `DENSE_CHAIN` against an
    uninterrupted run of the same traffic: every request complete and its
    stream equal; the degradation events preempt nothing; replica 1
    drains, and admits nothing, from the SDC suspicion (tick 8) to its
    clear (tick 14), and only then."""
    got, want = run["streams"], clean["streams"]
    check(len(want) == n_requests
          and all(len(t) == max_new for t in want.values()),
          "the uninterrupted run did not complete every request")
    check(got.keys() == want.keys()
          and all(len(t) == max_new for t in got.values()),
          "not every request completed through the chain")
    diverged = [r for r in want if got[r] != want[r]]
    check(not diverged, f"token streams diverged through the chain: "
          f"{diverged}")
    degraded = [(t, n, p) for t, n, p in run["preempted"]
                if n not in ("FailureEvent", "RecoveryEvent")]
    check(all(p == 0 for _, _, p in degraded),
          f"a degradation event preempted requests: {degraded}")
    for tick, flags in run["draining"]:
        check(flags == (False, 8 <= tick < 14),
              f"tick {tick}: draining {flags}")
    admits = [a[1] for t, a in run["admits"] if 8 <= t < 14]
    check(not any(admits), f"replica 1 admitted while draining: {admits}")


def restore_serve(session, router_cls, request_cls, runtime, path, queued):
    """The restore check: ``session`` (the chain's weights, fresh) takes
    `FailureEvent(domain=1)`, so its replicas run at TP (4, 3), restores
    the checkpoint at ``path`` and serves to the end what it returns and
    the requests ``queued`` at the save ((rid, prompt, generated,
    max_new)). Returns ({rid: tokens}, TP, requests restore returned,
    requests restored into slots)."""
    session.apply(runtime.FailureEvent(domain=1))
    tp = session.replica_tp
    pre = session.restore(path)
    restored = {r.rid for e in session.engines for r in e.in_flight}
    router = router_cls(session)
    router.requeue(pre)
    for rid, prompt, generated, max_new in queued:
        router.submit(request_cls(rid=rid, prompt=prompt, max_new=max_new,
                                  generated=list(generated)))
    router.drain()
    return ({r.rid: list(r.generated) for r in router.completed}, tp,
            len(pre), restored)


def layers_reference(torch, dev, cfg, params, n_layers, enc_input=None,
                     logits_rtol=0.0):
    """The served model's first ``n_layers`` at full width (its tensors
    shared with the served model; an enc-dec model's whole encoder, over
    ``enc_input`` (1, enc_seq, d) on the CPU) on the card against the same
    tensors on the CPU (plain kernel versions): a 32-token prefill and two
    decode steps, each's logits within max(1e-4, ``logits_rtol`` x the
    CPU's max |logit|)."""
    from repro_torch.models.transformer import build_model

    cfg1 = dataclasses.replace(cfg, n_layers=n_layers)
    p1 = dict(params, layers=params["layers"][:n_layers])
    gpu, cpu = build_model(cfg1, device=dev), build_model(cfg1, device="cpu")
    cp = _to(p1, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 32),
                         generator=torch.Generator().manual_seed(8))
    genc = None if enc_input is None else enc_input.to(dev)
    gl, gc = gpu.prefill(p1, toks.to(dev), gpu.init_cache(1, 40, torch.float32),
                         enc_input=genc)
    cl, cc = cpu.prefill(cp, toks, cpu.init_cache(1, 40, torch.float32),
                         enc_input=enc_input)
    errs = [float((gl.cpu() - cl).abs().max())]
    tols = [max(1e-4, logits_rtol * float(cl.abs().max()))]
    check(bool(torch.isfinite(gl).all())
          and gl.shape == (1, 32, cfg.padded_vocab()),
          f"{n_layers}-layer model: non-finite or misshapen logits")
    for pos, t in ((32, 5), (33, 9)):
        nxt = torch.tensor([[t]])
        gd, gc = gpu.decode_step(p1, gc, nxt.to(dev), pos)
        cd, cc = cpu.decode_step(cp, cc, nxt, pos)
        errs.append(float((gd.cpu() - cd).abs().max()))
        tols.append(max(1e-4, logits_rtol * float(cd.abs().max())))
    limit = ("tol 1e-4" if not logits_rtol else
             f"tol max(1e-4, {logits_rtol:g} x max |logit|): "
             + " ".join(f"{t:.3e}" for t in tols) + f"; max |logit| "
             f"{float(cl.abs().max()):.2f}")
    print(f"  {n_layers}-layer full-width {cfg.arch_id} "
          f"{cfg.layer_pattern[:n_layers]}, card vs CPU plain versions: "
          f"prefill max_abs_err {errs[0]:.3e}, decode logits {errs[1]:.3e} "
          f"{errs[2]:.3e} ({limit})", flush=True)
    check(all(e <= t for e, t in zip(errs, tols)),
          f"{n_layers}-layer model disagrees: {errs} against {tols}")
    del cp, cpu, gpu


def dense_chain_part(torch, dev, cfg, directory, ref_layers=DENSE_REF_LAYERS):
    """Phase 15 (A): ``cfg`` (gemma2-9b) served by `DENSE_SERVE_KW`
    sessions (weights from seed 0 on ``dev``) through `DENSE_CHAIN` with
    32 requests (24 + 16 tokens, four a tick over ticks 0-7), telemetry
    recorded; an uninterrupted session on the same weights; the restore
    check from the tick-10 checkpoint (saved without the weights, which
    the sessions share). Checks `chain_checks`, the restore's TP (4, 3)
    and streams, and the telemetry fold (serve percentiles and admissions
    of every request, one `serve.transition` span an event). Returns
    ((launches, flash launches by kind) of the chain run, the
    uninterrupted session, the params count)."""
    from repro_torch import runtime, telemetry
    from repro_torch.kernels import mode
    from repro_torch.launch import telemetry_report
    from repro_torch.serve import Request, Router, ServeSession

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    session = ServeSession.create(cfg, seed=0, device=dev, **DENSE_SERVE_KW)
    params = session.params
    _sync(torch, dev)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"  (A) {cfg.arch_id}: {cfg.n_layers} layers {cfg.layer_pattern} "
          f"(window {cfg.window}), d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, {cfg.n_kv_heads} KV heads, softcaps "
          f"{cfg.attn_softcap}/{cfg.final_softcap}, post-norms "
          f"{cfg.post_norms}: {n_par:,} params f32 ({n_par * 4 / 1e9:.2f} "
          f"GB) drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    layers_reference(torch, dev, cfg, params, min(ref_layers, cfg.n_layers))
    prompts = dense_traffic(cfg)
    path = os.path.join(directory, "serve.npz")
    saved = {}

    def save(s, router):
        ts = time.perf_counter()
        s.save(path, weights=False)
        saved.update(
            queue=[(r.rid, r.prompt, list(r.generated), r.max_new)
                   for r in router.queue],
            done={r.rid for r in router.completed},
            seconds=time.perf_counter() - ts, bytes=os.path.getsize(path))

    sink = telemetry.MemorySink(maxlen=None)
    mode.reset_launches()
    _sync(torch, dev)
    with telemetry.recording(telemetry.Recorder(sinks=[sink])):
        run = chain_serve(session, Router(session), Request, runtime,
                          prompts, save=save)
    _sync(torch, dev)
    launches = (mode.launches(), mode.variant_launches())
    tokens = sum(e.stats["tokens"] for e in session.engines)
    print(f"  chain run: {len(run['streams'])} requests, {tokens} tokens "
          f"in {run['ticks']} ticks, {run['wall']:.2f} s "
          f"({tokens / run['wall']:.1f} tokens/s); events (tick, kind, "
          f"preempted) {run['preempted']}; checkpoint at tick 10: "
          f"{saved['bytes']:,} B in {saved['seconds']:.2f} s, "
          f"{len(saved['done'])} done, {len(saved['queue'])} queued",
          flush=True)
    for t in session.transitions:
        print(f"    {type(t['event']).__name__:19s} replica {t['replica']}: "
              f"{t.get('kind', 'reshard'):8s} TP {t['tp_from']}->"
              f"{t['tp_to']}, preempted {t['preempted']}, rel_speed "
              f"{t.get('rel_speed', 0):.4f}, boost "
              f"{t.get('power_boost', 1):.3f}, draining "
              f"{t.get('draining', False)}, bytes "
              f"{t.get('reshard', {}).get('bytes_moved', 0):,}", flush=True)
        if "reshard" in t and t["tp_from"] and t["tp_to"]:
            _kv_ledger_check(cfg, session.engines[t["replica"]], t["reshard"])

    clean = ServeSession.create(cfg, params=params, device=dev,
                                **DENSE_SERVE_KW)
    _sync(torch, dev)
    want = chain_serve(clean, Router(clean), Request, runtime, prompts,
                       chain={})
    _sync(torch, dev)
    ctok = sum(e.stats["tokens"] for e in clean.engines)
    print(f"  uninterrupted: {want['ticks']} ticks, {want['wall']:.2f} s "
          f"({ctok / want['wall']:.1f} tokens/s)", flush=True)
    chain_checks(run, want, len(prompts), 16)
    print(f"  all {len(prompts)} streams equal to the uninterrupted run; "
          f"degradations preempted nothing; replica 1 drained and admitted "
          f"nothing over ticks 8-13", flush=True)

    doc = telemetry_report.report(sink.events())
    serve, trans = doc.get("serve", {}), doc.get("transitions", {})
    spans = sum(row["count"] for k, row in trans.items()
                if k.startswith("serve.transition:"))
    n_events = sum(1 for name, _ in DENSE_CHAIN.values() if name != "save")
    print(f"  telemetry fold: ttft {serve.get('ttft')}, tpot "
          f"{serve.get('tpot')}, admitted {serve.get('admitted')}, "
          f"rejected {serve.get('rejected')}, preempted "
          f"{serve.get('preempted')}, serve.transition spans {spans}",
          flush=True)
    check(serve.get("ttft", {}).get("count") == len(prompts)
          and serve.get("tpot", {}).get("count") == len(prompts)
          and serve.get("admitted") == len(prompts)
          and serve.get("rejected") == 0,
          f"telemetry fold lacks the serve percentiles or admissions: "
          f"{serve}")
    check(spans == n_events, f"{spans} serve.transition spans, "
          f"{n_events} events")

    rs = ServeSession.create(cfg, params=params, device=dev, **DENSE_SERVE_KW)
    tr = time.perf_counter()
    got, tp, n_pre, restored = restore_serve(rs, Router, Request, runtime,
                                             path, saved["queue"])
    _sync(torch, dev)
    rest = restored | {q[0] for q in saved["queue"]}
    print(f"  restore under TP {tp}: {len(restored)} slots restored, "
          f"{n_pre} returned beyond capacity, {len(saved['queue'])} "
          f"resubmitted; {len(got)} served to the end in "
          f"{time.perf_counter() - tr:.2f} s", flush=True)
    check(tp == (4, 3), f"restore ran at TP {tp}, not (4, 3)")
    check(got.keys() == set(want["streams"]) - saved["done"]
          and rest <= got.keys(),
          f"the restored run served {sorted(got)}")
    diverged = [r for r in got if got[r] != want["streams"][r]]
    check(not diverged, f"restored streams diverged: {diverged}")
    print(f"  all {len(got)} restored streams equal to the uninterrupted "
          f"run", flush=True)
    if dev.type == "cuda":
        print(f"  peak device memory allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del session, rs
    return launches, clean, n_par


def dense_arch_part(torch, dev, cfg):
    """Phase 15 (B) for one arch (full width, its depth cut by the caller):
    the served model against the CPU's plain versions (`layers_reference`),
    then 8 requests (24 + 16 tokens, one a tick) through `DENSE_ARCH_CHAIN`
    (TP 4 -> 3 -> 4) beside an uninterrupted run on the same weights:
    streams equal, every transition's bytes as its plan's KV heads.
    Returns (launches, flash launches by kind) of the fail -> repair run."""
    from repro_torch import runtime
    from repro_torch.kernels import mode
    from repro_torch.serve import Request, Router, ServeSession

    t0 = time.perf_counter()
    session = ServeSession.create(cfg, seed=0, device=dev, **DENSE_ARCH_KW)
    _sync(torch, dev)
    n_par = sum(t.numel() for t in _leaves(session.params))
    print(f"  (B) {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.n_kv_heads} KV "
          f"heads, {cfg.ffn_act}{' gated' if cfg.ffn_gated else ''} d_ff "
          f"{cfg.d_ff}, qk_norm {cfg.qk_norm}, vocab {cfg.vocab_size}: "
          f"{n_par:,} params ({n_par * 4 / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    layers_reference(torch, dev, cfg, session.params, cfg.n_layers)
    prompts = dense_traffic(cfg, n=8)
    mode.reset_launches()
    run = chain_serve(session, Router(session), Request, runtime, prompts,
                      per_tick=1, chain=DENSE_ARCH_CHAIN)
    _sync(torch, dev)
    launches = (mode.launches(), mode.variant_launches())
    clean = ServeSession.create(cfg, params=session.params, device=dev,
                                **DENSE_ARCH_KW)
    want = chain_serve(clean, Router(clean), Request, runtime, prompts,
                       per_tick=1, chain={})
    e = session.engines[0]
    tps = [t["tp_to"] for t in session.transitions]
    moved = [_kv_ledger_check(cfg, e, t["reshard"])
             for t in session.transitions]
    equal = sum(run["streams"].get(r) == want["streams"][r]
                for r in want["streams"])
    print(f"    fail->repair: {e.stats['tokens']} tokens in {run['ticks']} "
          f"ticks, {run['wall']:.2f} s; TP path {tps}, KV heads moved "
          f"{moved}, preemptions {e.stats['preemptions']}; uninterrupted "
          f"{want['ticks']} ticks; streams equal {equal} of "
          f"{len(want['streams'])}", flush=True)
    check(tps == [3, 4], f"TP path {tps} != [3, 4]")
    check(len(want["streams"]) == len(prompts)
          and all(len(t) == 16 for t in want["streams"].values()),
          "the uninterrupted run did not complete every request")
    check(equal == len(prompts), "fail->repair streams diverged: "
          f"{[r for r in want['streams'] if run['streams'].get(r) != want['streams'][r]]}")
    del session, clean, e
    return launches


def dense_serve_widths(arch):
    """(B)'s ``arch``: full width, depth `DENSE_ARCH_LAYERS`."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch), n_layers=DENSE_ARCH_LAYERS)


def dense_serve_rows(torch, F, dev, gemma_kinds, granite_counts):
    """This path's flash_attention shapes in phase 3's form, f32: gemma2-9b's
    served prefill (q (1, 16, 32, 256), kv 8, softcap 50, against
    `flex_attention`; sliding 4096 and global) and granite-3-2b's (q (1, 32,
    32, 64), kv 8, causal, against SDPA). At S 32 the 4096 window cuts no
    pair (S > 4096 is out of reach at max_len 96), so the sliding row is
    the causal row's work under the sliding mask's code. Each row carries
    its own launches on the path: (A)'s flash launches by mask
    (``gemma_kinds``) and granite's (``granite_counts``)."""
    g = torch.Generator(device=dev).manual_seed(1515)
    rows = {}
    for kind, label in (("sliding", "sliding 4096, cuts nothing at S 32,"),
                        ("causal", "causal")):
        row = flash_row(torch, F, dev, g, torch.float32, (1, 16, 8, 32, 256),
                        kind, softcap=50.0, label="gemma2-9b ")
        rows[f"flash_attention gemma2-9b {label} softcap 50"] = dict(
            launches=gemma_kinds.get(f"flash_attention:{kind}", 0), **row)
    row = flash_row(torch, F, dev, g, torch.float32, (1, 32, 8, 32, 64),
                    "causal", label="granite-3-2b ")
    rows["flash_attention granite-3-2b causal"] = dict(
        launches=granite_counts["flash_attention"], **row)
    torch.cuda.empty_cache()
    return rows


def dense_serve_phase(torch, F, dev):
    """Phase 15: (A) gemma2-9b at full width, depth `DENSE_CHAIN_LAYERS`,
    through the lifecycle chain and the restore check, its decode tick
    timed and profiled beside the weight-read floor; (B) granite-3-2b,
    minitron-4b and chameleon-34b at full width, depth 2, through fail ->
    repair; then this path's
    flash_attention rows. One model on the card at a time. Checks every
    kernel of the path launched, flash_attention with the sliding and the
    causal mask. Returns (launches summed over (A)'s chain run and (B)'s
    fail -> repair runs, flash launches by kind, the rows)."""
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    launches, variants = dict.fromkeys(SERVE_KERNELS, 0), {}

    def add(counts, kinds):
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
        for k, n in kinds.items():
            variants[k] = variants.get(k, 0) + n

    cfg = dataclasses.replace(get_arch("gemma2-9b"),
                              n_layers=DENSE_CHAIN_LAYERS)
    directory = scratch_dir()
    try:
        (counts, kinds), clean, n_par = dense_chain_part(torch, dev, cfg,
                                                         directory)
    finally:
        import shutil

        shutil.rmtree(directory, ignore_errors=True)
    add(counts, kinds)
    gemma_kinds = kinds
    print(f"  (A) kernels {json.dumps(counts)} flash by mask "
          f"{json.dumps(kinds)}", flush=True)
    eng = clean.engines[0]
    toks = torch.ones(8, dtype=torch.long, device=dev)
    pos = torch.arange(8, device=dev) + 40
    tick = lambda: eng.model.decode_slots(eng.params, eng.cache,  # noqa: E731
                                          toks, pos)
    tick_ms = time_ms(tick, 10)
    floor_ms = n_par * 4 / MEM_BW * 1e3
    print(f"  decode tick (8 slots, full model): {tick_ms:.3f} ms; "
          f"weight-read floor {floor_ms:.3f} ms ({n_par * 4 / 1e9:.2f} GB at "
          f"3.35 TB/s)", flush=True)
    profile_steps(torch, tick, "decode tick")
    del clean, eng, tick
    torch.cuda.empty_cache()
    print(f"  (A) {time.perf_counter() - t0:.1f} s", flush=True)
    by_arch = {}
    for arch in DENSE_ARCHS:
        counts, kinds = dense_arch_part(torch, dev, dense_serve_widths(arch))
        add(counts, kinds)
        by_arch[arch] = counts
        torch.cuda.empty_cache()
        print(f"  {arch} kernels {json.dumps(counts)} flash by mask "
              f"{json.dumps(kinds)}; {time.perf_counter() - t0:.1f} s so far",
              flush=True)
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"a kernel of the dense serving path never launched: {launches}")
    check(variants.get("flash_attention:sliding", 0) > 0
          and variants.get("flash_attention:causal", 0) > 0,
          f"flash_attention did not run both masks: {variants}")
    rows = dense_serve_rows(torch, F, dev, gemma_kinds,
                            by_arch["granite-3-2b"])
    print(f"  phase 15: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launches)}, flash by mask {json.dumps(variants)}",
          flush=True)
    return launches, rows


HYBRID_SERVE_KW = dict(replicas=1, n1=4, slots=8, max_len=64, prefill_len=16,
                       policy="ntp_pw")
# fail, fail, repair, repair: TP 4 -> 3 -> 2 -> 3 -> 4, by router tick
HYBRID_CHAIN = {3: ("FailureEvent", dict(domain=0)),
                5: ("FailureEvent", dict(domain=0)),
                9: ("RecoveryEvent", dict(domain=0)),
                11: ("RecoveryEvent", dict(domain=0))}
HYBRID_REQ, HYBRID_PROMPT, HYBRID_NEW, HYBRID_PER_TICK = 12, 8, 8, 4
HYBRID_REF_LAYERS = {"recurrentgemma-9b": 3, "whisper-small": 1}
# the held layers' logits: max(1e-4, this x max |logit|) (recurrentgemma's
# tied head puts its prefill logits near 60, where the f32 head product on
# the card alone differs from f64 by ~1.2e-4)
HYBRID_LOGITS_RTOL = 5e-6
# what each model's chain run must launch (kernels, flash by mask)
HYBRID_KERNELS = {"recurrentgemma-9b": ("rmsnorm", "reshard_pack"),
                  "whisper-small": ("reshard_pack", "flash_attention:bidir",
                                    "flash_attention:causal")}


def hybrid_traffic(cfg):
    """`HYBRID_REQ` prompts of `HYBRID_PROMPT` tokens (seed 0) and, for an
    enc-dec config, one seeded (enc_seq, d_model) f32 ``enc_input`` a
    request (seed 1; else None)."""
    import numpy as np

    prompts = dense_traffic(cfg, n=HYBRID_REQ, prompt_len=HYBRID_PROMPT)
    if cfg.encoder is None:
        return prompts, None
    rng = np.random.default_rng(1)
    shape = (cfg.encoder.enc_seq, cfg.d_model)
    return prompts, [(rng.standard_normal(shape) * 0.1).astype(np.float32)
                     for _ in range(HYBRID_REQ)]


def _state_ledger_check(cfg, engine, st):
    """A transition's bytes: for every leaf of the cache, the units its
    family's plan moves times one unit's bytes on that leaf (RG-LRU
    blocks on h/conv, KV heads on the k/v rings, encoder heads on ek/ev),
    as `reshard.state.ShardedState` counts them. Returns the units moved
    by family."""
    from repro_torch.reshard import planner
    from repro_torch.reshard.units import cache_unit_resolver

    res, n1 = cache_unit_resolver(cfg), engine.n1
    want, moved = 0, {}
    for name, t in engine.cache.items():
        spec = res(name)
        plan = planner.transition_plan(
            planner.sync_key(spec.k, n1, st["tp_from"]),
            planner.sync_key(spec.k, n1, st["tp_to"]), spec.k, spec.k)
        unit = t.numel() // t.shape[spec.axis] * spec.unit
        want += plan.n_moved * unit * t.element_size()
        moved[spec.kind] = plan.n_moved
    check(st["bytes_moved"] == want,
          f"TP {st['tp_from']}->{st['tp_to']}: {st['bytes_moved']} B moved, "
          f"the plans' units {moved} make {want} B")
    return moved


def peak_probe(torch, apply, peaks):
    """``apply`` wrapped so that each event appends to ``peaks`` the peak
    device memory allocated since the last reset (the ticks before it) and
    the peak inside the event's transition, in GB."""
    def probed(event):
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        pre = apply(event)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        return pre
    return probed


def hybrid_model_part(torch, dev, cfg, ref_layers):
    """Phase 16 for one model: a session drawn on ``dev`` (seed 0,
    `HYBRID_SERVE_KW`), its first ``ref_layers`` layers (and an enc-dec
    model's encoder) held against the CPU's plain versions
    (`layers_reference`), then `HYBRID_REQ` requests (`hybrid_traffic`,
    `HYBRID_PER_TICK` a tick, `HYBRID_NEW` new tokens each) through
    `HYBRID_CHAIN` beside an uninterrupted session on the same weights.
    Checks: TP path [3, 2, 3, 4] with preemptions; every stream complete
    and equal; each transition's bytes as its plans' (`_state_ledger_check`);
    on the card, each of the model's `HYBRID_KERNELS` launched in the
    chain run (the peak memory of each stage printed). Returns ((launches,
    flash launches by kind) of the chain run, the uninterrupted session,
    the params count)."""
    from repro_torch import runtime
    from repro_torch.kernels import mode
    from repro_torch.serve import Request, Router, ServeSession

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    session = ServeSession.create(cfg, seed=0, device=dev, **HYBRID_SERVE_KW)
    params = session.params
    _sync(torch, dev)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers {cfg.layer_pattern}, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{cfg.n_kv_heads} KV heads, norm {cfg.norm_type}, rope "
          f"{cfg.use_rope}, encoder {cfg.encoder}, vocab {cfg.vocab_size}: "
          f"{n_par:,} params f32 ({n_par * 4 / 1e9:.2f} GB; n_params() "
          f"{cfg.n_params():,}) drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    prompts, enc = hybrid_traffic(cfg)
    tr = time.perf_counter()
    mem = dict(created=torch.cuda.max_memory_allocated() / 1e9) if cuda \
        else {}
    layers_reference(torch, dev, cfg, params, min(ref_layers, cfg.n_layers),
                     None if enc is None else torch.from_numpy(enc[0])[None],
                     logits_rtol=HYBRID_LOGITS_RTOL)
    print(f"    held against the CPU in {time.perf_counter() - tr:.1f} s",
          flush=True)
    peaks = []
    if cuda:
        mem["held against the CPU"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
    mode.reset_launches()
    _sync(torch, dev)
    run = chain_serve(session, Router(session), Request, runtime, prompts,
                      max_new=HYBRID_NEW, per_tick=HYBRID_PER_TICK,
                      chain=HYBRID_CHAIN, enc=enc,
                      apply=peak_probe(torch, session.apply, peaks) if cuda
                      else None)
    _sync(torch, dev)
    launches = (mode.launches(), mode.variant_launches())
    if cuda:
        mem["chain run after its last transition"] = \
            torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
    clean = ServeSession.create(cfg, params=params, device=dev,
                                **HYBRID_SERVE_KW)
    want = chain_serve(clean, Router(clean), Request, runtime, prompts,
                       max_new=HYBRID_NEW, per_tick=HYBRID_PER_TICK, chain={},
                       enc=enc)
    _sync(torch, dev)
    if cuda:
        mem["uninterrupted run (both sessions' caches)"] = \
            torch.cuda.max_memory_allocated() / 1e9
    e = session.engines[0]
    tps = [t["tp_to"] for t in session.transitions]
    moved = [_state_ledger_check(cfg, e, t["reshard"])
             for t in session.transitions]
    equal = sum(run["streams"].get(r) == want["streams"][r]
                for r in want["streams"])
    print(f"    fail->repair: {e.stats['tokens']} tokens in {run['ticks']} "
          f"ticks, {run['wall']:.2f} s; TP path {tps}, preempted "
          f"{[p for _, _, p in run['preempted']]}, prefills "
          f"{e.stats['prefills']}; uninterrupted {want['ticks']} ticks, "
          f"{want['wall']:.2f} s; streams equal {equal} of "
          f"{len(want['streams'])}", flush=True)
    for t, m in zip(session.transitions, moved):
        print(f"      TP {t['tp_from']}->{t['tp_to']}: units moved {m}, "
              f"bytes {t['reshard']['bytes_moved']:,} (as the plans')",
              flush=True)
    check(tps == [3, 2, 3, 4], f"TP path {tps} != [3, 2, 3, 4]")
    check(e.stats["preemptions"] > 0, "the chain preempted nothing")
    check(len(want["streams"]) == len(prompts)
          and all(len(t) == HYBRID_NEW for t in want["streams"].values()),
          "the uninterrupted run did not complete every request")
    check(equal == len(prompts), "fail->repair streams diverged: "
          f"{[r for r in want['streams'] if run['streams'].get(r) != want['streams'][r]]}")
    if cuda:
        ran = {**launches[0], **launches[1]}
        print("    peak device memory allocated (GB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in mem.items()) + "; chain run before / "
            "inside each transition " + ", ".join(
                f"{a:.2f} / {b:.2f}" for a, b in zip(peaks[::2], peaks[1::2])),
            flush=True)
        check(all(ran.get(k, 0) > 0 for k in HYBRID_KERNELS[cfg.arch_id]),
              f"{cfg.arch_id}: a kernel of its serving path never launched: "
              f"{ran}, needs {HYBRID_KERNELS[cfg.arch_id]}")
    del session, e
    return launches, clean, n_par


def admission_ms(torch, clean, prompt, enc_input):
    """Milliseconds of one admission's model work (CUDA events, mean of
    3): the padded prefill (with the encoder) of an attention model, or
    the length-1 prefill and teacher-forced steps of a recurrent one, on
    a fresh one-row cache."""
    eng = clean.engines[0]
    toks = eng._tokens(prompt)
    enc = None if enc_input is None else torch.from_numpy(enc_input)[None].to(
        eng.device)

    def admit():
        cache = eng.model.init_cache(1, eng.max_len, torch.float32)
        if eng._recurrent:
            eng.model.prefill(eng.params, toks[None, :1], cache,
                              enc_input=enc)
            for pos in range(1, len(prompt)):
                eng.model.decode_step(eng.params, cache,
                                      toks[None, pos:pos + 1], pos)
        else:
            padded = torch.zeros((1, eng.prefill_len), dtype=torch.long,
                                 device=eng.device)
            padded[0, :len(prompt)] = toks
            eng.model.prefill(eng.params, padded, cache, enc_input=enc)

    return time_ms(admit, 3)


def hybrid_serve_phase(torch, F, dev):
    """Phase 16: (A) recurrentgemma-9b at full size and (B) whisper-small
    at full size, one on the card at a time, each through
    `hybrid_model_part`; (A)'s admission and decode tick timed (CUDA
    events) and profiled beside the weight-read floor, (B)'s admission
    timed; then flash_attention at whisper's encoder shape (bidir, f32)
    against its plain version and SDPA. Returns
    (launches summed over both chain runs, the row)."""
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    launches, variants = dict.fromkeys(SERVE_KERNELS, 0), {}
    for part, (arch, ref_layers) in zip("AB", HYBRID_REF_LAYERS.items()):
        cfg = get_arch(arch)
        print(f"  ({part})", flush=True)
        (counts, kinds), clean, n_par = hybrid_model_part(torch, dev, cfg,
                                                          ref_layers)
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
        for k, n in kinds.items():
            variants[k] = variants.get(k, 0) + n
        print(f"    kernels {json.dumps(counts)} flash by mask "
              f"{json.dumps(kinds)}", flush=True)
        prompts, enc = hybrid_traffic(cfg)
        ms = admission_ms(torch, clean, prompts[0],
                          None if enc is None else enc[0])
        print(f"    one admission ({HYBRID_PROMPT}-token prompt"
              f"{', token by token' if clean.engines[0]._recurrent else ''}"
              f"{', the encoder over ' + str(cfg.encoder.enc_seq) + ' frames' if enc else ''}"
              f"): {ms:.3f} ms", flush=True)
        if arch == "recurrentgemma-9b":
            eng = clean.engines[0]
            toks = torch.ones(8, dtype=torch.long, device=dev)
            pos = torch.arange(8, device=dev) + 40
            tick = lambda: eng.model.decode_slots(  # noqa: E731
                eng.params, eng.cache, toks, pos)
            tick_ms = time_ms(tick, 10)
            floor_ms = n_par * 4 / MEM_BW * 1e3
            print(f"    decode tick (8 slots, full model): {tick_ms:.3f} ms; "
                  f"weight-read floor {floor_ms:.3f} ms ({n_par * 4 / 1e9:.2f}"
                  f" GB at 3.35 TB/s)", flush=True)
            profile_steps(torch, tick, "decode tick")
            del eng, tick
        del clean
        torch.cuda.empty_cache()
        print(f"    {time.perf_counter() - t0:.1f} s so far", flush=True)
    g = torch.Generator(device=dev).manual_seed(1616)
    row = flash_row(torch, F, dev, g, torch.float32, (1, 12, 12, 1500, 64),
                    "bidir", label="whisper-small encoder ")
    rows = {"flash_attention whisper-small encoder bidir": dict(
        launches=variants["flash_attention:bidir"], **row)}
    torch.cuda.empty_cache()
    print(f"  phase 16: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launches)}, flash by mask {json.dumps(variants)}",
          flush=True)
    return launches, rows


# phase 17: the uniform arch stack trained (`train.steps`, `NTPSession
# .from_arch`), f32, weights from seed 0 on the card; the plain route runs
# no kernel, `make_setup(prefill)` launches these
ARCH_TRAIN_KERNELS = ("rmsnorm", "flash_attention", "ssd_scan")
ARCH_TRAIN_LR = 1e-3        # AdamW's rate in the sessions (a constant one)
ARCH_PROBE_LR = 1e-6        # and in the step-equality probes (iv), (v)
# (name, arch, depth (None: the config's), batch, sequence, session steps,
# the prefill's kernel tolerance (ssd_scan's is 5e-4))
ARCH_TRAIN = (("A", "qwen2-7b", 2, 4, 256, 6, 1e-4),
              ("B", "mamba2-780m", None, 2, 512, 3, 5e-4),
              ("C", "whisper-small", None, 2, 64, 2, 1e-4))


def const_schedule(step):
    return 1.0


def _arch_batch(torch, cfg, batch, seq, dev, step=0):
    """The synthetic stream's batch ``step`` on ``dev``, with a seeded
    (batch, enc_seq, d) ``enc_input`` for an enc-dec config."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

    out = SyntheticLMPipeline(DataConfig(cfg.vocab_size, seq, batch, seed=0),
                              device=dev).batch(step)
    if cfg.encoder is not None:
        g = torch.Generator(device=dev).manual_seed(17)
        out["enc_input"] = 0.1 * torch.randn(
            (batch, cfg.encoder.enc_seq, cfg.d_model), generator=g,
            device=dev)
    return out


def arch_grads_check(torch, su, params, batch, name):
    """(i): the train step's gradient (`Setup.grad_fn`) at ``params`` is
    finite and not all zero in every leaf — no leaf lost its gradient to a
    forward-only kernel."""
    from repro_torch import tree as tr

    (_, ce), grads = su.grad_fn(params, batch)
    bad = [tr.path_key(p) for p, g in tr.leaves_with_path(grads)
           if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
    n = len(tr.leaves(grads))
    print(f"  ({name} i) step 0's gradient: {n - len(bad)} of {n} leaves "
          f"finite and nonzero (loss {float(ce):.4f})", flush=True)
    check(not bad, f"({name}) leaves without a gradient: {bad[:8]}")


def arch_prefill_check(torch, cfg, model, params, batch, seq, tol, name):
    """(ii): `Model.forward`'s last logits (plain route) against
    `make_setup(prefill)`'s (the served model's kernels) within max(tol,
    5e-6 x max |logit|). Returns the prefill's kernel launches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import mode
    from repro_torch.train.steps import make_setup

    b = batch["tokens"].shape[0]
    su = make_setup(cfg, ShapeSpec("prefill", seq, b, "prefill"),
                    param_dtype=torch.float32, device=model.device)
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    with torch.no_grad():
        full = model.forward(params, batch["tokens"],
                             enc_input=batch.get("enc_input"))[0][:, -1]
    torch.cuda.synchronize()
    mode.reset_launches()
    last, cache = su.step_fn(params, inputs)
    torch.cuda.synchronize()
    launches = mode.launches()
    del cache
    err = float((full - last).abs().max())
    lim = max(tol, 5e-6 * float(full.abs().max()))
    print(f"  ({name} ii) forward vs make_setup(prefill) last logits: "
          f"max_abs_err {err:.3e} (tol {lim:.3e}, max |logit| "
          f"{float(full.abs().max()):.2f}); prefill launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(err <= lim, f"({name}) forward and prefill disagree: {err}")
    return launches


def arch_cpu_check(torch, cfg, params, dev):
    """(A iii): step 0's loss and grad_norm of the model's first layer
    (its tensors shared) on a 1 x 64 batch, on the card and on the CPU,
    within max(1e-4, 5e-6 x max |logit|)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.optim import global_norm
    from repro_torch.train.steps import make_setup

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    p1 = dict(params, layers=params["layers"][:1])
    got = []
    for where, p in ((dev, p1), (torch.device("cpu"), _to(p1, "cpu"))):
        su = make_setup(cfg1, ShapeSpec("t", 64, 1, "train"),
                        param_dtype=torch.float32, device=where)
        batch = _arch_batch(torch, cfg1, 1, 64, where)
        (_, ce), grads = su.grad_fn(p, batch)
        with torch.no_grad():
            top = float(su.model.forward(p, batch["tokens"])[0].abs().max())
        got.append((float(ce), float(global_norm(grads)), top))
        del grads
    lim = max(1e-4, 5e-6 * got[1][2])
    errs = [abs(a - b) for a, b in zip(got[0][:2], got[1][:2])]
    print(f"  (A iii) depth 1, 1 x 64: loss {got[0][0]:.6f} card / "
          f"{got[1][0]:.6f} CPU, grad_norm {got[0][1]:.6f} / {got[1][1]:.6f}"
          f" (tol {lim:.3e}, max |logit| {got[1][2]:.2f})", flush=True)
    check(max(errs) <= lim, f"(A) card and CPU step 0 disagree: {errs}")


def arch_probes(torch, cfg, batch, seq, dev):
    """(A iv, v): from the seed-0 weights, one step with microbatches=2 and
    one with remat off, each against the plain step (AdamW at
    `ARCH_PROBE_LR`, so a weight whose gradient is rounding noise moves by
    at most ~lr either way): params within 1e-5 and 1e-6, and the first
    moment (the clipped gradients) within 1e-4 and 1e-6 of the plain
    step's largest. Returns the FLOPs `FlopCounterMode` counts in the
    plain step on the card (the dry-run's phase holds the meta count of
    the same step to it)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree as tr
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_setup

    b = batch["tokens"].shape[0]

    def setup(**kw):
        return make_setup(cfg, ShapeSpec("t", seq, b, "train"),
                          param_dtype=torch.float32, device=dev,
                          opt_cfg=AdamWConfig(lr=ARCH_PROBE_LR),
                          lr_schedule=const_schedule, **kw)

    plain = setup()
    p0 = plain.model.init(torch.Generator(device=dev).manual_seed(0))

    def probe(su):
        p = tr.tree_map(torch.clone, p0)
        p, o, _ = su.step_fn(p, adamw_init(p, su.opt_cfg), batch)
        return p, o["m"]

    with FlopCounterMode(display=False) as counter:
        ref_p, ref_m = probe(plain)
    card_flops = counter.get_total_flops()
    top = max(float(m.abs().max()) for m in tr.leaves(ref_m))
    for name, su, ptol, mtol in (("A iv", setup(microbatches=2), 1e-5, 1e-4),
                                 ("A v", setup(remat=False), 1e-6, 1e-6)):
        p, m = probe(su)
        dp = max(float((a - r).abs().max())
                 for a, r in zip(tr.leaves(p), tr.leaves(ref_p)))
        dm = max(float((a - r).abs().max())
                 for a, r in zip(tr.leaves(m), tr.leaves(ref_m))) / top
        what = "microbatches=2" if name == "A iv" else "remat off"
        print(f"  ({name}) {what} vs the plain step: params max_abs_err "
              f"{dp:.3e} (tol {ptol:g}), first moment {dm:.3e} of its "
              f"largest {top:.3e} (tol {mtol:g})", flush=True)
        check(dp <= ptol and dm <= mtol, f"({name}) {what} differs")
        del p, m
    del p0, ref_p, ref_m
    torch.cuda.empty_cache()
    return card_flops


def arch_train_part(torch, dev, name, arch, depth, batch, seq, steps, tol):
    """One model of phase 17 through `NTPSession.from_arch` (AdamW at
    `ARCH_TRAIN_LR`, remat on); checks (i), (ii), and for (A) (iii)-(vi).
    Returns the prefill's launches, and for (A) the plain step's FLOPs on
    the card and the step ms (else None)."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import mode
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import NTPSession

    cfg = get_arch(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    data = [_arch_batch(torch, cfg, batch, seq, dev, i) for i in range(steps)]
    counted = None
    if name == "A":
        counted = {"flops": arch_probes(torch, cfg, data[0], seq, dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = NTPSession.from_arch(cfg, ShapeSpec("t", seq, batch, "train"),
                             device=dev, opt_cfg=AdamWConfig(lr=ARCH_TRAIN_LR),
                             lr_schedule=const_schedule)
    n_par = sum(p.numel() for p in tr.leaves(s.params))
    torch.cuda.synchronize()
    print(f"  ({name}) {cfg.arch_id}: {cfg.n_layers} layers, {n_par:,} "
          f"params ({n_par * 4 / 1e9:.2f} GB f32), batch {batch} x {seq}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    arch_grads_check(torch, s.setup, s.params, data[0], name)
    if name == "A":
        arch_cpu_check(torch, cfg, s.params, dev)
    mode.reset_launches()
    losses, ms = [], []
    for i in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        m = s.step(data[i])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    trained = mode.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  ({name}) {steps} steps: losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; step ms "
          + ", ".join(f"{x:.1f}" for x in ms) + f"; peak {peak:.2f} GB "
          f"allocated; kernel launches in training "
          f"{sum(trained.values())}", flush=True)
    check(all(v == 0 for v in trained.values()),
          f"({name}) the training route launched kernels: {trained}")
    check(all(map(math.isfinite, losses)), f"({name}) non-finite loss")
    if name == "A":
        check(losses[-1] < losses[0],
              f"(A vi) the loss did not fall: {losses}")
        print(f"  (A vi) loss at step {steps - 1} {losses[-1]:.4f} < step 0 "
              f"{losses[0]:.4f}", flush=True)
        profile_steps(torch, lambda: s.step(data[-1]), "step", ticks=1)
    launches = arch_prefill_check(torch, cfg, s.setup.model, s.params,
                                  data[0], seq, tol, name)
    del s
    torch.cuda.empty_cache()
    if counted is not None:
        counted["ms"] = ms
    return launches, counted


def arch_train_phase(torch, dev):
    """Phase 17. Returns the launch counts of the prefill steps, summed,
    and (A)'s plain step's FLOPs on the card and step ms."""
    total = dict.fromkeys(ARCH_TRAIN_KERNELS, 0)
    for name, arch, depth, batch, seq, steps, tol in ARCH_TRAIN:
        launches, counted = arch_train_part(torch, dev, name, arch, depth,
                                            batch, seq, steps, tol)
        if name == "A":
            a_step = counted
        want = (("rmsnorm", "ssd_scan") if arch == "mamba2-780m" else
                ("flash_attention",) if arch == "whisper-small" else
                ("rmsnorm", "flash_attention"))
        check(all(launches[k] > 0 for k in want),
              f"({name}) the prefill did not launch {want}: {launches}")
        for k in total:
            total[k] += launches[k]
    return total, a_step


def arch_train_only(torch):
    """``--arch-train``: build the kernels and run phase 17 alone, then exit
    (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    t0 = time.perf_counter()
    launches, _ = arch_train_phase(torch, torch.device("cuda"))
    print(f"  phase 17: {time.perf_counter() - t0:.1f} s; prefill launches "
          f"{launches}", flush=True)
    return 0


# phase 18: sharded execution of the uniform arch stack (`make_setup` on a
# `launch.mesh.RankMesh`): qwen2-7b at full width on a (2, 2) mesh of 4
# gloo processes on cuda:0, held to the one-device step run first in the
# parent (phase 17's parity rate); prefill and decode launch these
ARCH_RANKS_KERNELS = ("rmsnorm", "flash_attention")
# (arch, depth, batch, sequence, steps, AdamW rate, prefill tokens, decode
# steps); the mesh is (2, 2)
ARCH_RANKS = ("qwen2-7b", 2, 4, 256, 2, ARCH_PROBE_LR, 64, 8)
# a decode step's logits against the one-device decode's: both attend a
# bf16 cache whose K/V the two runs round from f32 values computed by
# different matmul shapes, so a few entries round the other way (the
# bf16-cache tolerance of tests/test_torch_arch_ranks.py)
ARCH_RANKS_DECODE_TOL = 2e-2


def _arch_ranks_setups(torch, cfg, run, mesh, dev):
    """The train, prefill and decode `Setup`s of phase 18's ``run`` (an
    `ARCH_RANKS` tuple) on ``mesh`` (None: one device)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import make_setup

    _, _, batch, seq, _, lr, prompt, new = run
    kw = dict(param_dtype=torch.float32, device=dev)
    return (make_setup(cfg, ShapeSpec("t", seq, batch, "train"), mesh,
                       opt_cfg=AdamWConfig(lr=lr),
                       lr_schedule=const_schedule, **kw),
            make_setup(cfg, ShapeSpec("p", prompt + new, batch, "prefill"),
                       mesh, **kw),
            make_setup(cfg, ShapeSpec("d", prompt + new, batch, "decode"),
                       mesh, **kw))


def _arch_ranks_serve(torch, run, pf, dc, params, dev):
    """A prefill of seeded prompts and greedy decode steps: (the prefill's
    last logits, the decoded tokens (batch, new), each decode step's
    logits (new, batch, vocab) on the host, the kernel launches of the
    prefill, those of the decode, and the collectives' (calls, bytes) by
    (op, group) of the prefill and of the first decode step). On a mesh
    the logits and tokens are this replica's rows, and each step's tokens
    are gathered over ``data`` into the global batch the next step takes
    (outside the counted step)."""
    from repro_torch.core import collectives as C
    from repro_torch.core.collectives import all_gather_units
    from repro_torch.kernels import mode

    mesh = pf.mesh

    def whole(tok):
        if mesh is None:
            return tok
        return all_gather_units(tok, mesh.data).reshape(-1, 1)

    batch, prompt, new = run[2], run[6], run[7]
    g = torch.Generator(device=dev).manual_seed(1818)
    prompts = torch.randint(0, pf.cfg.vocab_size, (batch, prompt),
                            generator=g, device=dev, dtype=torch.int32)
    mode.reset_launches()
    C.reset_counts()
    last, cache = pf.step_fn(params, {"tokens": prompts})
    _sync(torch, dev)
    pre = mode.launches()
    counts = {"prefill": C.counts()}
    mode.reset_launches()
    tok, toks, steps = last.argmax(-1)[:, None], [], []
    for i in range(new):
        toks.append(tok)
        batch_i = {"tokens": whole(tok), "pos": torch.tensor(prompt + i)}
        C.reset_counts()
        logits, cache = dc.step_fn(params, cache, batch_i)
        if i == 0:
            counts["decode"] = C.counts()
        tok = logits.argmax(-1)[:, None]
        steps.append(logits)
    _sync(torch, dev)
    dec = mode.launches()
    return (last, torch.cat(toks, 1), torch.stack(steps).cpu(), pre, dec,
            counts)


def arch_ranks_reference(torch, dev, cfg, run, directory):
    """Phase 18, the parent: the one-device steps from the seed-0 weights,
    then the prefill and greedy decode on the trained weights; the trained
    params go to ``directory`` (one .npy a leaf, flatten order) for the
    processes to read their slices. Returns what the checks need, on the
    host."""
    import numpy as np

    from repro_torch import tree as tr

    batch, seq, steps = run[2:5]
    su, pf, dc = _arch_ranks_setups(torch, cfg, run, None, dev)
    params = su.model.init(torch.Generator(device=dev).manual_seed(0))
    opt = su.init_opt_state(params)
    out = {"loss": [], "grad_norm": [], "step_ms": []}
    for i in range(steps):
        data = _arch_batch(torch, cfg, batch, seq, dev, i)
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, m = su.step_fn(params, opt, data)
        out["loss"].append(float(m["loss"]))
        _sync(torch, dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norm"].append(float(m["grad_norm"]))
    del opt, m, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    last, toks, dec, _, _, _ = _arch_ranks_serve(torch, run, pf, dc,
                                                 params, dev)
    out["prefill"], out["tokens"], out["decode"] = last.cpu(), toks.cpu(), dec
    for i, leaf in enumerate(tr.leaves(params)):
        np.save(os.path.join(directory, f"{i}.npy"), leaf.cpu().numpy())
    del params, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def arch_rank_worker(cfg, run, directory, device):
    """Phase 18, one (replica, rank) process: `NTPSession.from_arch` on the
    mesh from the seed-0 weights (drawn whole on the device, then placed),
    the steps (host clock after a device sync, collectives counted), every
    leaf's first moment after step 0 (its clipped gradient), the param
    shards against the one-device params read from ``directory``, then
    the sharded prefill and greedy decode."""
    import numpy as np

    import torch

    from repro_torch import tree as tr
    from repro_torch.core import collectives as C
    from repro_torch.kernels import mode
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import NTPSession
    from repro_torch.sharding.specs import local_shard

    batch, seq, steps = run[2:5]
    mesh = make_test_mesh(2, 2, backend="gloo", device=device)
    dev, cuda = mesh.device, mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    su, pf, dc = _arch_ranks_setups(torch, cfg, run, mesh, dev)
    s = NTPSession.from_arch(
        cfg, su.shape, mesh, opt_cfg=su.opt_cfg, lr_schedule=const_schedule,
        generator=torch.Generator(device=dev).manual_seed(0))
    if cuda:
        torch.cuda.empty_cache()
    _sync(torch, dev)
    out = {"at": (mesh.replica, mesh.rank),
           "setup_s": time.perf_counter() - t0, "loss": [], "grad_norm": [],
           "step_ms": [], "counts": []}
    mode.reset_launches()
    for i in range(steps):
        data = _arch_batch(torch, cfg, batch, seq, dev, i)
        C.reset_counts()
        _sync(torch, dev)
        t0 = time.perf_counter()
        m = s.step(data)
        out["loss"].append(float(m["loss"]))
        _sync(torch, dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norm"].append(float(m["grad_norm"]))
        out["counts"].append(C.counts())
        if i == 0:
            moments = tr.leaves_with_path(s.opt_state["m"])
            out["no_grad"] = [
                tr.path_key(p) for p, g in moments
                if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
            out["leaves"] = len(tr.leaves(s.opt_state["m"]))
    out["train_launches"] = mode.launches()
    out["param_err"] = max(
        float((p - torch.from_numpy(np.array(local_shard(
            np.load(os.path.join(directory, f"{i}.npy"), mmap_mode="r"),
            spec, mesh))).to(dev)).abs().max())
        for i, (p, spec) in enumerate(zip(tr.leaves(s.params),
                                          tr.leaves(su.param_specs))))
    del data, m
    if cuda:
        torch.cuda.empty_cache()
    last, toks, logits, pre, dec, counts = _arch_ranks_serve(
        torch, run, pf, dc, s.params, dev)
    out.update(prefill=last.cpu().numpy(), tokens=toks.cpu().numpy(),
               decode=logits.numpy(), prefill_launches=pre,
               decode_launches=dec, serve_counts=counts,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
               else 0.0)
    return out


def arch_ranks_phase(torch, dev, cfg=None, run=ARCH_RANKS):
    """Phase 18. Returns the processes' prefill and decode launches,
    summed, and each process's executed collectives by (replica, rank):
    ``{"train": [each step's], "prefill": ..., "decode": the first
    step's}``, (calls, bytes) by (op, group). ``cfg`` (default: ``run``'s arch at its depth), ``run`` and a
    CPU ``dev`` let the phase be rehearsed small on the CPU."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.launch.spawn import spawn

    t_phase = time.perf_counter()
    arch, depth, batch, seq, steps, lr, prompt, new = run
    cfg = cfg or dataclasses.replace(get_arch(arch), n_layers=depth)
    cuda = dev.type == "cuda"
    tmp = scratch_dir()
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    try:
        t0 = time.perf_counter()
        ref = arch_ranks_reference(torch, dev, cfg, run, tmp)
        free = (f"; card memory free before the spawn "
                f"{torch.cuda.mem_get_info(dev)[0] / 1e9:.2f} GB" if cuda
                else "")
        print(f"  one device: {cfg.arch_id}, {cfg.n_layers} layers, {steps} "
              f"steps at {batch} x {seq}, AdamW lr {lr:g}: losses "
              + ", ".join(f"{x:.6f}" for x in ref["loss"]) + ", grad_norm "
              + ", ".join(f"{x:.6f}" for x in ref["grad_norm"]) + ", step ms "
              + ", ".join(f"{x:.1f}" for x in ref["step_ms"])
              + f"; prefill {batch} x {prompt} and {new} greedy steps; "
              f"{time.perf_counter() - t0:.1f} s with the params written"
              + free, flush=True)
        # four processes share the card (as phase 10's)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = RANK_ALLOC_CONF
        t0 = time.perf_counter()
        ranks = spawn(arch_rank_worker, 4, backend="gloo", device=dev.type,
                      deadline_s=600, args=(cfg, run, tmp, dev.type))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    print(f"  4 processes on a (2, 2) mesh, gloo on {dev.type}: spawned, run "
          f"and joined in {wall:.1f} s; set-up (draw, place) "
          f"{max(r['setup_s'] for r in ranks):.1f} s", flush=True)
    top = float(ref["prefill"].abs().max())
    lim = max(1e-4, 5e-6 * top)
    launches = dict.fromkeys(ARCH_RANKS_KERNELS, 0)
    for r in ranks:
        d = r["at"][0]
        lerr = max(abs(a - b) for a, b in zip(r["loss"], ref["loss"]))
        gerr = max(abs(a - b) / b for a, b in zip(r["grad_norm"],
                                                  ref["grad_norm"]))
        rows = slice(d * batch // 2, (d + 1) * batch // 2)
        perr = float((torch.from_numpy(r["prefill"])
                      - ref["prefill"][rows]).abs().max())
        same = bool((torch.from_numpy(r["tokens"])
                     == ref["tokens"][rows]).all())
        derr = float((torch.from_numpy(r["decode"])
                      - ref["decode"][:, rows]).abs().max())
        used = {n: c for n, c in r["prefill_launches"].items() if c}
        dused = {n: c for n, c in r["decode_launches"].items() if c}
        print(f"  process {r['at']}: |loss - one device| {lerr:.3e} (tol "
              f"1e-5), grad_norm {gerr:.3e} relative (tol 1e-5), param "
              f"shards {r['param_err']:.3e} (tol 2e-6), "
              f"{r['leaves'] - len(r['no_grad'])} of {r['leaves']} leaves "
              f"with a gradient; prefill logits {perr:.3e} (tol {lim:.3e}, "
              f"max |logit| {top:.2f}); {new} greedy tokens "
              f"{'equal' if same else 'DIFFER'}, their logits {derr:.3e} "
              f"(tol {ARCH_RANKS_DECODE_TOL:g}, bf16 cache); launches: "
              f"training {sum(r['train_launches'].values())}, prefill "
              f"{used}, decode "
              f"{dused}; peak {r['peak_gb']:.2f} GB allocated", flush=True)
        check(lerr <= 1e-5, f"process {r['at']}: loss off by {lerr}")
        check(gerr <= 1e-5, f"process {r['at']}: grad_norm off by {gerr}")
        check(r["param_err"] <= 2e-6,
              f"process {r['at']}: param shards off by {r['param_err']}")
        check(not r["no_grad"], f"process {r['at']}: leaves without a "
              f"gradient {r['no_grad'][:8]}")
        check(perr <= lim, f"process {r['at']}: prefill logits off by {perr}")
        check(same, f"process {r['at']}: greedy tokens differ")
        check(derr <= ARCH_RANKS_DECODE_TOL,
              f"process {r['at']}: decode logits off by {derr}")
        check(all(v == 0 for v in r["train_launches"].values()),
              f"process {r['at']}: training launched {r['train_launches']}")
        check(not cuda or (all(used.get(n) for n in ARCH_RANKS_KERNELS)
                           and dused.get("rmsnorm")),
              f"process {r['at']}: prefill {used}, decode {dused}")
        for n in launches:
            launches[n] += (r["prefill_launches"][n]
                            + r["decode_launches"][n])
    for i in range(steps):
        ms = max(r["step_ms"][i] for r in ranks)
        counts = ", ".join(f"{op}/{g} {c} calls {b:,} B" for (op, g), (c, b)
                           in sorted(ranks[0]["counts"][i].items()))
        print(f"  step {i}: {ms:.1f} ms (max over processes; one device "
              f"{ref['step_ms'][i]:.1f}); process (0, 0): {counts}",
              flush=True)
    for what in ("prefill", "decode"):
        counts = ", ".join(f"{op}/{g} {c} calls {b:,} B" for (op, g), (c, b)
                           in sorted(ranks[0]["serve_counts"][what].items()))
        print(f"  {what}{' (one step)' if what == 'decode' else ''}: "
              f"process (0, 0): {counts}", flush=True)
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    executed = {r["at"]: dict(r["serve_counts"], train=r["counts"])
                for r in ranks}
    return launches, executed


def arch_ranks_only(torch):
    """``--arch-ranks``: build the kernels and run phase 18 alone, then
    exit (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    arch_ranks_phase(torch, torch.device("cuda"))
    return 0


# phase 19: the dry-run (`launch.dryrun`): one process plays each process of
# phase 18's (2, 2) mesh on meta tensors over the counting-only fake groups,
# and the one-device step of phase 17 (A); another gives one production
# record. Both run in processes of their own (the fake world is a default
# group), started with the script and read after phase 18.
DRYRUN_PRODUCTION = ("gemma2-9b", "train_4k")
DRYRUN_TIMEOUT_S = 600


def _dryrun_shapes(run=ARCH_RANKS):
    """The dry-run shapes of phase 18's steps, by kind."""
    _, _, batch, seq, _, _, prompt, new = run
    return {"train": f"train:{batch}x{seq}",
            "prefill": f"prefill:{batch}x{prompt}+{new}",
            "decode": f"decode:{batch}x{prompt}+{new}"}


def start_dryruns(directory):
    """Start `launch.dryrun` on phase 18's cell (every process of its (2,
    2) mesh and the one-device step, f32, at its depth) and on
    `DRYRUN_PRODUCTION` at the 16 x 16 mesh, each writing its records
    under ``directory`` and its output to a log there. Returns {name:
    (process, log path, start time on the wall clock)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    arch, depth = ARCH_RANKS[:2]
    cmds = {
        "phase18": ["--arch", arch, "--layers", str(depth), "--param-dtype",
                    "float32", "--mesh", "2x2,one", "--all-ranks",
                    "--shape", ",".join(_dryrun_shapes().values())],
        "production": ["--arch", DRYRUN_PRODUCTION[0], "--shape",
                       DRYRUN_PRODUCTION[1]],
    }
    procs = {}
    for name, args in cmds.items():
        out = os.path.join(directory, name)
        log = open(os.path.join(directory, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", out], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=root), log.name, time.time())
        log.close()
    return procs


def _record(directory, name, arch, shape, mesh, at=(0, 0)):
    tag = "" if at == (0, 0) else f"__r{at[0]}_{at[1]}"
    with open(os.path.join(directory, name, f"{arch}__"
                           f"{shape.replace(':', '-')}__{mesh}{tag}.json")) as f:
        return json.load(f)


def _kernel_meta_calls(torch):
    """Each kernel's wrapper called on meta tensors at its main shape:
    nothing launches, the output has the kernel's shape and dtype, and the
    dry launch's cost is its cost function's."""
    from repro_torch.kernels import mode
    from repro_torch.kernels.bucket import (bucket_cost, bucket_pack,
                                            bucket_unpack)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost)
    from repro_torch.kernels.reshard_pack import reshard_pack_cost, \
        reshard_pack_ranks
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cost
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_cost

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    calls = {
        "rmsnorm": (lambda: rmsnorm(m(8, 3584), m(3584)), (8, 3584),
                    rmsnorm_cost(8, 3584, 4)),
        "flash_attention": (lambda: flash_attention(
            m(1, 28, 32, 128), m(1, 4, 32, 128), m(1, 4, 32, 128)),
            (1, 28, 32, 128), flash_attention_cost(1, 28, 4, 32, 128, 4)),
        "reshard_pack": (lambda: reshard_pack_ranks(
            m(4, 5, 1024), m(4, 4, 1, dtype=torch.int32)), (4, 4, 1, 1024),
            reshard_pack_cost(16, 1024, 4, 16)),
        "bucket_pack": (lambda: bucket_pack([m(400, 458752)] * 2),
                        (400, 917504), bucket_cost(400, 917504, 4)),
        "bucket_unpack": (lambda: bucket_unpack(m(400, 917504),
                                                (458752, 458752))[0],
                          (400, 458752), bucket_cost(400, 917504, 4)),
        "ssd_scan": (lambda: ssd_scan(m(192, 2048, 64), m(192, 2048), m(192),
                                      m(4, 2048, 128), m(4, 2048, 128)),
                     (192, 2048, 64), ssd_scan_cost(192, 4, 2048, 256, 64,
                                                    128)),
    }
    before = mode.launches()
    for name, (call, shape, cost) in calls.items():
        mode.reset_dry_launches()
        out = call()
        dry = mode.dry_launches()[name]
        check(out.is_meta and tuple(out.shape) == shape
              and out.dtype == torch.float32,
              f"{name}: a meta call gave {out.shape} {out.dtype}")
        check((dry["calls"], dry["flops"], dry["bytes"])
              == (1, cost.flops, cost.bytes), f"{name}: dry launch {dry}")
    check(mode.launches() == before, "a meta call launched a kernel")
    print(f"  a meta call of each of {', '.join(calls)}: no launch, the "
          "kernel's output shape and dtype, its cost function's FLOPs and "
          "bytes counted as a dry launch", flush=True)


def dryrun_phase(torch, procs, directory, executed, a_step, smi):
    """Phase 19. Waits for `start_dryruns`' processes, then: (a) every
    process of phase 18's mesh, predicted against executed: the dry-run's
    (calls, bytes) by (op, group) equal to what phase 18's process (at
    the same (replica, rank)) executed, in each train step, the prefill
    and the first decode step; (b) the one-device meta FLOPs of phase 17
    (A)'s step equal to `FlopCounterMode`'s count of it on this card, and
    its f32 roofline share: the predicted compute seconds at 67 TFLOP/s
    against the measured step; (c) the production record; (d) a meta call
    of each kernel launches nothing."""
    for name, (proc, log, t0) in procs.items():
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log) as f:
            tail = f.read().strip().splitlines()
        print(f"  dry-run {name}: rc {rc}, {len(tail)} lines, its last "
              f"written {os.path.getmtime(log) - t0:.1f} s after its start; "
              f"{tail[-1] if tail else ''}", flush=True)
        check(rc == 0, f"dry-run {name} failed:\n" + "\n".join(tail[-20:]))
    arch = ARCH_RANKS[0]
    shapes = _dryrun_shapes()
    for at, ex in sorted(executed.items()):
        for kind, shape in shapes.items():
            rec = _record(directory, "phase18", arch, shape, "fake2x2", at)
            check(rec["ok"], f"dry-run {shape} at {at}: {rec.get('error')}")
            want = {(c["op"], c["group"]): (c["calls"], c["bytes"])
                    for c in rec["calls"]}
            runs = ex["train"] if kind == "train" else [ex[kind]]
            for i, got in enumerate(runs):
                keys = sorted(set(want) | set(got))
                print(f"  process {at} {kind}{f' step {i}' if kind == 'train' else ''}: "
                      + "; ".join(
                          f"{op}/{g} predicted {want.get((op, g), (0, 0))[0]} "
                          f"calls {want.get((op, g), (0, 0))[1]:,} B, "
                          f"executed {got.get((op, g), (0, 0))[0]} calls "
                          f"{got.get((op, g), (0, 0))[1]:,} B"
                          for op, g in keys), flush=True)
                check(dict(got) == want, f"process {at} {kind} {i}: "
                      f"predicted {want} != executed {got}")
    one = _record(directory, "phase18", arch, shapes["train"], "one")
    meta = one["hlo_flops_per_device"]
    print(f"  phase 17 (A)'s step, one device: meta FLOPs {meta:,.0f}, "
          f"FlopCounterMode on this card {a_step['flops']:,}; "
          f"{'equal' if meta == a_step['flops'] else 'DIFFER'}", flush=True)
    check(meta == a_step["flops"] and not one["kernels"],
          f"meta FLOPs {meta} != the card's {a_step['flops']}")
    compute_ms = one["roofline"]["compute_s"] * 1e3
    step_ms = statistics.median(a_step["ms"])
    print(f"  f32 roofline share of that step on {smi}: predicted compute "
          f"{compute_ms:.1f} ms at 67 TFLOP/s against the measured "
          f"{step_ms:.1f} ms (the median of phase 17 (A)'s steps): "
          f"{compute_ms / step_ms:.3f}", flush=True)
    arch, shape = DRYRUN_PRODUCTION
    rec = _record(directory, "production", arch, shape, "pod16x16")
    check(rec["ok"] and rec["chips"] == 256,
          f"the production record failed: {rec.get('error')}")
    r, mem = rec["roofline"], rec["memory"]
    print(f"  production record {arch} {shape} on 16 x 16 (rank (0, 0), "
          f"bf16): {rec['chips']} chips, {rec['hlo_flops_per_device']:.4e} "
          f"FLOPs, {rec['hlo_bytes_per_device']:.4e} B (eager, unfused), "
          f"{rec['collective_bytes_per_device']:.4e} B moved by collectives "
          f"a device; roofline compute {r['compute_s'] * 1e3:.1f} ms, memory "
          f"{r['memory_s'] * 1e3:.1f} ms, collective "
          f"{r['collective_s'] * 1e3:.1f} ms, dominant {r['dominant']}; "
          f"useful {rec['useful_flops_ratio']:.3f}; arguments "
          f"{mem['argument_bytes'] / 1e9:.2f} GB, saved for backward "
          f"{mem['temp_bytes'] / 1e9:.2f} GB; traced in {rec['trace_s']} s",
          flush=True)
    _kernel_meta_calls(torch)


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


def gloo_probe_worker():
    """One rank of `gloo_probe`: seconds of a 512 MB all-reduce of CUDA and
    of CPU tensors (mean of 2) and of a 512 MB all-to-all of CUDA tensors
    over the whole group."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}
    for where in ("cuda", "cpu"):
        x = torch.ones(128 * 2**20, device=where)
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(2):
            dist.all_reduce(x)
        torch.cuda.synchronize(dev)
        out[f"all_reduce {where}"] = (time.perf_counter() - t0) / 2
    x = torch.ones(128 * 2**20, device=dev)
    y = torch.empty_like(x)
    dist.barrier()
    t0 = time.perf_counter()
    dist.all_to_all_single(y, x)
    torch.cuda.synchronize(dev)
    out["all_to_all cuda"] = time.perf_counter() - t0
    return out


def gloo_p2p_worker(where):
    """One of 2 ranks of `gloo_probe`'s send/recv line: rank 0 sends a
    29 MB activation-sized tensor on ``where`` to rank 1 (mean seconds of
    2, the receive checked), and rank 1 returns whether it arrived."""
    import torch
    import torch.distributed as dist

    x = torch.full((2, 256, 3584, 4), 1.0 + dist.get_rank(), device=where)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(2):
        if dist.get_rank() == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 2, bool((x == 1.0).all())


def gloo_probe():
    """``--gloo-probe``: gloo's rate on this card between 2 and among 4
    processes (`gloo_probe_worker`, slowest rank), then what its `send` /
    `recv` take: CPU tensors, and CUDA tensors in a run of their own (a
    refusal or a wrong receive is reported, not raised), then exit."""
    from repro_torch.launch.spawn import RankError, spawn

    for world in (2, 4):
        ranks = spawn(gloo_probe_worker, world, backend="gloo",
                      device="cuda", deadline_s=300)
        print(f"  gloo, {world} processes on cuda:0, 512 MB: " + ", ".join(
            f"{k} {max(r[k] for r in ranks):.3f} s" for k in ranks[0]),
            flush=True)
    for where in ("cpu", "cuda"):
        try:
            ranks = spawn(gloo_p2p_worker, 2, backend="gloo", device="cuda",
                          deadline_s=120, args=(where,))
            took = (f"taken, {max(r[0] for r in ranks):.4f} s a 29 MB send"
                    f", received {'right' if ranks[1][1] else 'WRONG'}")
        except RankError as e:
            took = (f"refused: rank {e.rank} failed (exit code "
                    f"{e.exitcode}): "
                    + e.detail.strip().splitlines()[-1][:200])
        except TimeoutError as e:
            took = f"refused: {e}"
        print(f"  gloo send/recv of {where} tensors: {took}", flush=True)
    return 0


def pp_ranks_only(torch):
    """``--pp-ranks``: build the kernels and run phase 11 alone, then
    exit (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    pp_ranks_phase(torch, torch.device("cuda"))
    return 0


def moe_only(torch):
    """``--moe``: build the kernels and run phase 12 alone, then exit (no
    kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    moe_phase(torch, torch.device("cuda"))
    return 0


def moe_serve_only(torch, F):
    """``--moe-serve``: build the kernels and run phase 13 alone, then exit
    (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    moe_serve_phase(torch, F, torch.device("cuda"))
    return 0


def dense_serve_only(torch, F):
    """``--dense-serve``: build the kernels and run phase 15 alone, print
    its kernel rows, then exit (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    _, rows = dense_serve_phase(torch, F, torch.device("cuda"))
    for name, row in rows.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in row.items()),
              flush=True)
    return 0


def hybrid_serve_only(torch, F):
    """``--hybrid-serve``: build the kernels and run phase 16 alone, print
    its kernel row, then exit (no kernels table and no device line)."""
    from repro_torch.kernels import build

    print(f"  built in {build.build_all():.1f} s", flush=True)
    _, rows = hybrid_serve_phase(torch, F, torch.device("cuda"))
    for name, row in rows.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in row.items()),
              flush=True)
    return 0


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
    if sys.argv[1:2] == ["--gloo-probe"]:
        return gloo_probe()
    if sys.argv[1:2] == ["--pp-ranks"]:
        return pp_ranks_only(torch)
    if sys.argv[1:2] == ["--moe"]:
        return moe_only(torch)
    if sys.argv[1:2] == ["--allocator"]:
        return allocator_only(torch)
    if sys.argv[1:2] == ["--arch-train"]:
        return arch_train_only(torch)
    if sys.argv[1:2] == ["--arch-ranks"]:
        return arch_ranks_only(torch)
    import torch.nn.functional as F

    if sys.argv[1:2] == ["--moe-serve"]:
        return moe_serve_only(torch, F)
    if sys.argv[1:2] == ["--dense-serve"]:
        return dense_serve_only(torch, F)
    if sys.argv[1:2] == ["--hybrid-serve"]:
        return hybrid_serve_only(torch, F)

    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # a stop from outside unwinds the phases, so `spawn` kills and joins
    # its ranks and the scratch directories go
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    t_start = time.perf_counter()
    marks = [t_start]

    def phase(title):
        now = time.perf_counter()
        if len(marks) > 1:
            print(f"  ({now - marks[-1]:.1f} s; {now - t_start:.1f} s in "
                  f"all; this process {_host_rss_gb():.2f} GB resident)",
                  flush=True)
        marks.append(now)
        print(title, flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # the dry-run's processes run beside the build and the phases; phase 19
    # reads them, and they are stopped however the script ends
    dry_dir = scratch_dir()
    dryruns = start_dryruns(dry_dir)
    try:
        phase("phase 2: build kernels")
        secs = build.build_all()
        print(f"  built {', '.join(build.SOURCES)} in {secs:.1f} s", flush=True)
        for name, info in build.ptxas_info.items():
            for line in info.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

        phase("phase 3: kernels against their plain versions")
        rows = kernel_phase(torch, F, dev)

        phase("phase 4: serve full-size qwen2-7b through fail->repair")
        reference_phase(torch, dev)
        serve_launches = serve_phase(torch, dev)
        torch.cuda.empty_cache()
        print(f"  device memory after freeing the served model "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

        phase("phase 5: full-size mamba2-780m: batched prefill through ssd_scan, "
              "serving through fail->repair")
        mamba_launches = mamba_phase(torch, dev)
        check(all(mamba_launches[k] > 0 for k in MAMBA_KERNELS),
              f"a kernel of the Mamba-2 path never launched: {mamba_launches}")
        mamba_launcher_phase()
        torch.cuda.empty_cache()

        phase("phase 6: train the NTP prototype at qwen2-7b widths through "
              "fail->repair")
        train_launches, pp1_transitions = train_phase(torch, dev)

        phase("phase 7: trace-driven NTP-PW training at qwen2-7b widths through "
              "failure, link, SDC quarantine and straggler")
        trace_launches = trace_phase(torch, dev)

        phase("phase 8: pp=2 NTP training at qwen2-7b widths: stage-local "
              "failures and repairs, microbatches, and a trace under NTP-PW")
        pp2_launches = pp2_phase(torch, dev, pp1_transitions)

        phase("phase 9: the training launcher")
        launcher_phase()
        torch.cuda.empty_cache()

        phase("phase 10: ranks as processes: NTP training at qwen2-7b widths (1 "
              "layer) on a (2, 2) mesh of 4 processes, gloo on this card, through "
              "fail->repair, then the lifecycle with overlap on")
        ranks_launches, rank_rows = ranks_phase(torch, dev, qwen_widths(1))

        phase("phase 11: pp=2 ranks as processes: NTP training at qwen2-7b "
              "widths, one layer a stage, on a pp=2 x (2, 2) staged mesh of 8 "
              "processes, gloo on this card, through a stage-1 fail->repair")
        pp_ranks_launches = pp_ranks_phase(torch, dev)

        phase("phase 12: NTP-MoE (the expert as the partition unit): (A) "
              "llama4-scout widths on the emulated mesh through fail->repair, "
              "(B) arctic-480b widths on every other training route, (C) the "
              "MoE FFN at llama4-scout's widths")
        moe_launches, expert_row = moe_phase(torch, dev)

        phase("phase 13: MoE serving at full width: llama4-scout (4 layers, "
              "chunked + global attention) and arctic-480b (1 layer, 128 "
              "experts) through fail->repair")
        moe_serve_launches, moe_serve_table = moe_serve_phase(torch, F, dev)

        phase("phase 14: the global repack allocator: spares at pp=2 at qwen2-7b "
              "widths through fail->fail->repair->repair")
        alloc_launches = allocator_phase(torch, dev)

        phase("phase 15: the serving lifecycle at full width: gemma2-9b through "
              "failure, straggler, SDC quarantine, save, link and repairs, then "
              "restored under TP (4, 3); granite-3-2b, minitron-4b and "
              "chameleon-34b at full width through fail->repair")
        dense_serve_launches, dense_serve_table = dense_serve_phase(torch, F, dev)

        phase("phase 16: hybrid and encoder-decoder serving at full size: "
              "recurrentgemma-9b (RG-LRU + sliding MQA) and whisper-small "
              "(encoder, cross-attention, LayerNorm) through fail->repair")
        hybrid_launches, hybrid_table = hybrid_serve_phase(torch, F, dev)

        phase("phase 17: train the uniform arch stack: qwen2-7b at full width "
              "(2 layers), mamba2-780m and whisper-small at full size, through "
              "NTPSession.from_arch")
        arch_launches, arch_step = arch_train_phase(torch, dev)

        phase("phase 18: sharded execution of the uniform arch stack: qwen2-7b "
              "at full width (2 layers) on a (2, 2) mesh of 4 processes, gloo on "
              "this card, trained, prefilled and decoded")
        arch_ranks_launches, executed = arch_ranks_phase(torch, dev)

        phase("phase 19: the dry-run: phase 18's collectives and phase 17 (A)'s "
              "FLOPs predicted on meta tensors against the executed ones, and a "
              "production record")
        dryrun_phase(torch, dryruns, dry_dir, executed, arch_step, smi)

        phase("phase 20: kernels table")
        paths = ((serve_launches, SERVE_KERNELS), (train_launches, TRAIN_KERNELS),
                 (mamba_launches, MAMBA_KERNELS),
                 (trace_launches, TRACE_KERNELS), (pp2_launches, PP2_KERNELS),
                 (ranks_launches, RANKS_KERNELS),
                 (pp_ranks_launches, PP_RANKS_KERNELS),
                 (moe_launches, MOE_KERNELS),
                 (moe_serve_launches, SERVE_KERNELS),
                 (alloc_launches, ALLOC_KERNELS),
                 (dense_serve_launches, SERVE_KERNELS),
                 (hybrid_launches, SERVE_KERNELS),
                 (arch_launches, ARCH_TRAIN_KERNELS),
                 (arch_ranks_launches, ARCH_RANKS_KERNELS))
        table = []
        for name, (src, replaces) in SOURCES.items():
            n = sum(counts[name] for counts, kernels in paths if name in kernels)
            table.append(dict(name=name, route="cuda", source=src,
                              replaces=replaces, launches=n, **rows[name]))
        for name, row in rank_rows.items():
            print(f"  {name} per rank (process path): launches "
                  f"{ranks_launches[name]}, " + ", ".join(
                      f"{k} {v}" for k, v in row.items()), flush=True)
        print(f"  reshard_pack at the expert unit (NTP-MoE, emulated): launches "
              f"{moe_launches['reshard_pack']} on the MoE paths, " + ", ".join(
                  f"{k} {v}" for k, v in expert_row.items()), flush=True)
        for name, row in moe_serve_table.items():
            print(f"  {name} (MoE serving): " + ", ".join(
                f"{k} {v}" for k, v in row.items()), flush=True)
        for name, row in dense_serve_table.items():
            print(f"  {name} (dense serving, phase 15): "
                  + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        for name, row in hybrid_table.items():
            print(f"  {name} (hybrid and enc-dec serving, phase 16): "
                  + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": table}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        import shutil

        for proc, _, _ in dryruns.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(dry_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
