"""Batched prefill, then greedy decode against the cache (the port's twin
of `examples/serve_decode.py`).

Examples:

  # full-size mamba2-780m on one H100: the prefill runs the ssd_scan kernel
  PYTHONPATH=src python -m repro_torch.launch.serve_decode \\
      --arch mamba2-780m --full --batch 4 --prompt-len 2048 --new 32

  # smoke scale on the CPU, with the plain versions of the kernels
  PYTHONPATH=src python -m repro_torch.launch.serve_decode --device cpu

Weights and prompts come from seeded `torch.Generator`s. Prints the
prefill and decode times (host clock, synchronized) and returns them.
"""
import argparse
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m",
                    help="arch config id (reduced/smoke scale unless --full)")
    ap.add_argument("--full", action="store_true",
                    help="run the full-size config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="tokens per prompt; for an SSD arch at most the "
                         "SSD chunk (256 full, 32 reduced) or a multiple of it")
    ap.add_argument("--new", type=int, default=32,
                    help="tokens to generate per prompt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.prompt_len < 1 or args.new < 1:
        ap.error("--batch, --prompt-len and --new must be >= 1")

    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import build_model

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
    )
    cache = model.init_cache(args.batch, args.prompt_len + args.new,
                             torch.float32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
    sync()
    prefill_s = time.perf_counter() - t0
    n_prompt = args.batch * args.prompt_len
    print(f"prefill {args.batch}x{args.prompt_len} ({cfg.arch_id} on {dev}): "
          f"{prefill_s * 1e3:.1f} ms, {n_prompt / prefill_s:.1f} tokens/s",
          flush=True)

    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.new - 1):
        logits, cache = model.decode_step(params, cache, tok,
                                          args.prompt_len + i)
        tok = torch.argmax(logits[:, 0, :cfg.vocab_size], -1)[:, None]
        out.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    steps = max(1, args.new - 1)
    print(f"decoded {args.new} tokens x {args.batch} sequences: "
          f"{decode_s / steps * 1e3:.2f} ms per step, "
          f"{steps * args.batch / max(decode_s, 1e-9):.1f} tokens/s")
    print("sample:", gen[0, :16].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("serve_decode: non-finite logits")
    print("OK")
    return {"prefill_ms": prefill_s * 1e3, "decode_step_ms":
            decode_s / steps * 1e3, "tokens": gen.cpu()}


if __name__ == "__main__":
    main()
