"""The dry-run: one step of every (arch × input shape × mesh) at the
production mesh, counted rather than run — port of
`repro/launch/dryrun.py`.

The reference lowers and compiles ``make_setup(cfg, shape, mesh).step_fn``
at the 16 × 16 (or 2 × 16 × 16) mesh of placeholder devices and reads the
optimized HLO. The port compiles nothing and cannot start 256 processes:
ONE process plays one (replica, rank) of the mesh
(`launch.mesh.make_production_mesh`: ``meta`` tensors, the counting-only
``fake`` process groups) and runs the rank's `make_setup` step once on
its shards' shapes under `launch.op_analysis.analyze_step`: the ATen
ops' FLOPs and bytes, the hand kernels' cost functions (their meta calls
compute nothing, `kernels.mode.dry_launches`) and the collectives' calls
and bytes by (op, group), exactly those a real process of that mesh
issues. Values a step would read on the host (a decode position) are
passed in as host values; nothing is substituted.

Each record keeps the reference's keys that have a meaning here:
``chips``, ``hlo_flops_per_device`` (the name kept for the reference's
readers, `benchmarks/roofline.py`: FLOPs of the port's ops and kernels,
no elementwise op, see `op_analysis`), ``hlo_bytes_per_device`` (eager,
unfused: larger than the reference's HLO bytes for the same step),
``collective_bytes_per_device``, ``collectives``, ``roofline`` (at the
card's peaks below), ``memory`` (``argument_bytes``: the rank's params,
optimizer state, batch and cache, exact from the shapes; ``temp_bytes``:
what the forward saves for the backward; ``output_bytes``),
``model_flops_*``, ``useful_flops_ratio``, ``n_params`` and
``n_active_params``, and adds ``calls`` (every (op, group)'s calls and
bytes), ``kernels``, ``replica`` and ``rank``. The reference's
``lower_s`` and ``compile_s`` are one ``trace_s`` here; ``xla_cost_flops``,
``xla_bytes_accessed``, ``generated_code_bytes`` and
``unknown_trip_count_loops`` have no counterpart.

A config that sharded execution refuses gives ``ok: False`` with the
error's text, which names its ROADMAP row; the sweep goes on and exits 1,
as the reference's does. ``long_500k`` is skipped for an arch without
``supports_long_decode``, with its ``long_decode_note``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.shapes import SHAPES, ShapeSpec, get_shape
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import close_fake_mesh, dp_axes, \
    make_production_mesh
from repro_torch.train.steps import make_setup

# the target card's peaks: NVIDIA H100 SXM 80GB, 700 W, data sheet
PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12     # FLOP/s, f32 on the CUDA cores (TF32 stays off)
HBM_BW = 3.35e12           # bytes/s of HBM3
LINK_BW = 450e9            # bytes/s of NVLink, each way


def peak_flops(param_dtype) -> float:
    """The FLOP peak a step at ``param_dtype`` computes at."""
    return PEAK_FLOPS_F32 if param_dtype == torch.float32 else \
        PEAK_FLOPS_BF16


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def parse_shape(text: str) -> ShapeSpec:
    """A registered shape name, or a cut-to-size one: ``train:BxS`` (B
    sequences of S tokens), ``prefill:BxP+N`` (prompts of P tokens into a
    cache of P+N rows) or ``decode:BxP+N`` (one token at position P of a
    cache of P+N rows; ``+N`` may be left out: N = 0)."""
    if ":" not in text:
        return get_shape(text)
    kind, dims = text.split(":")
    b, rest = dims.split("x")
    p, _, n = rest.partition("+")
    return ShapeSpec(text, int(p) + int(n or 0), int(b), kind)


def _prompt_len(shape: ShapeSpec) -> int:
    """The prompt of a prefill, the position of a decode: P of a
    ``kind:BxP+N`` shape; a registered prefill fills its cache and a
    registered decode writes its last row."""
    _, _, rest = shape.name.partition(":")
    if rest:
        return int(rest.split("x")[1].partition("+")[0])
    return shape.seq_len - (shape.kind == "decode")


def _meta(shp, dtype):
    return torch.empty(shp, dtype=dtype, device="meta")


def step_args(su, shape: ShapeSpec):
    """The meta arguments of ``su``'s step: this process's param shards,
    its optimizer state (train) or cache (decode), and the global batch
    (a decode's position a host int)."""
    params = su.place(su.model.param_shapes())
    batch = {k: _meta(s.shape, s.dtype) for k, s in su.batch_specs.items()
             if k != "pos"}
    if shape.kind == "train":
        return params, su.init_opt_state(params), batch
    pos = _prompt_len(shape)
    if shape.kind == "prefill":
        batch["tokens"] = _meta((shape.global_batch, pos), torch.int32)
        return params, batch
    cache = su.model.init_cache(shape.global_batch, shape.seq_len,
                                torch.bfloat16, specs=su.cache_specs)
    return params, cache, dict(batch, pos=pos)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tr.leaves(tree)
               if isinstance(t, torch.Tensor))


def count_step(cfg, shape: ShapeSpec, mesh=None, *,
               param_dtype=torch.bfloat16) -> Dict:
    """`op_analysis.analyze_step` of one meta step of ``make_setup(cfg,
    shape, mesh)`` (``mesh`` a fake `RankMesh`, or None: one device on
    meta), with the memory and timing fields of a record."""
    t0 = time.perf_counter()
    kw = dict(dp_axes=dp_axes(mesh)) if mesh is not None else \
        dict(device="meta")
    su = make_setup(cfg, shape, mesh, param_dtype=param_dtype, **kw)
    args = step_args(su, shape)
    sizes = op_analysis.group_sizes(mesh) if mesh is not None else {}
    out = op_analysis.analyze_step(su.step_fn, *args, group_sizes=sizes)
    out["memory"] = {"argument_bytes": _nbytes(args),
                     "output_bytes": _nbytes(out.pop("result")),
                     "temp_bytes": out["saved_bytes"]}
    out["trace_s"] = time.perf_counter() - t0
    return out


def record(cfg, shape: ShapeSpec, analysis: Dict, chips: int,
           param_dtype) -> Dict:
    """The reference's record fields from one `count_step`."""
    flops_dev = analysis["flops"]
    mflops = model_flops(cfg, shape)
    return dict(
        ok=True,
        chips=chips,
        trace_s=round(analysis["trace_s"], 2),
        memory=analysis["memory"],
        hlo_flops_per_device=flops_dev,
        hlo_bytes_per_device=analysis["bytes"],
        collective_bytes_per_device=analysis["collective_moved_bytes"],
        collectives=analysis["collectives"],
        calls=[{"op": op, "group": g, "calls": c, "bytes": b}
               for (op, g), (c, b) in sorted(analysis["calls"].items())],
        kernels=analysis["kernels"],
        roofline=op_analysis.roofline(
            flops_dev, analysis["bytes"],
            analysis["collective_moved_bytes"],
            peak_flops=peak_flops(param_dtype), hbm_bw=HBM_BW,
            link_bw=LINK_BW),
        model_flops_total=mflops,
        model_flops_per_device=mflops / chips,
        useful_flops_ratio=(mflops / chips) / flops_dev if flops_dev
        else None,
        n_params=cfg.n_params(),
        n_active_params=cfg.n_active_params(),
    )


def mesh_name(multi_pod: bool, shape=None) -> str:
    if shape == "one":
        return "one"
    if shape is not None:
        return f"fake{shape[0]}x{shape[1]}"
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_one(arch_id: str, shape_name: str, multi_pod: bool = False, *,
            replica: int = 0, rank: int = 0, mesh_shape=None,
            layers: Optional[int] = None,
            param_dtype=torch.bfloat16) -> Dict:
    """The record of one (arch, shape, mesh) for process (``replica``,
    ``rank``): the production mesh, a ``mesh_shape`` (n_data, n_model)
    fake mesh, or ``mesh_shape="one"``: the one-device step on meta (no
    mesh, no collective); ``layers`` cuts the depth (the arch's own by
    default)."""
    cfg = get_arch(arch_id)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = parse_shape(shape_name)
    rec: Dict = {
        "arch": arch_id, "shape": shape_name,
        "mesh": mesh_name(multi_pod, mesh_shape), "kind": shape.kind,
        "replica": replica, "rank": rank, "ok": False,
    }
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        rec.update(skipped=True, reason=cfg.long_decode_note)
        return rec
    if mesh_shape == "one":
        analysis = count_step(cfg, shape, None, param_dtype=param_dtype)
        rec.update(record(cfg, shape, analysis, 1, param_dtype))
        return rec
    mesh = make_production_mesh(multi_pod, replica=replica, rank=rank,
                                shape=mesh_shape)
    try:
        analysis = count_step(cfg, shape, mesh, param_dtype=param_dtype)
    finally:
        close_fake_mesh()
    rec.update(record(cfg, shape, analysis, mesh.n_data * mesh.n_model,
                      param_dtype))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="registered names, or cut-to-size kind:BxS[+N] "
                         "(see parse_shape), comma-separated")
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (2x16x16, pod folded into "
                         "data), both, or comma-separated DxM (a fake D x M "
                         "mesh) and 'one' (the one-device step)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to this depth")
    ap.add_argument("--param-dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--all-ranks", action="store_true",
                    help="play every process of a DxM mesh (default: "
                         "process (0, 0))")
    args = ap.parse_args(argv)

    archs = list(all_archs()) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    if args.mesh in ("single", "multi", "both"):
        meshes = [(mp, None) for mp in
                  {"single": [False], "multi": [True],
                   "both": [False, True]}[args.mesh]]
    else:
        meshes = [(False, "one" if m == "one" else
                   tuple(int(t) for t in m.split("x")))
                  for m in args.mesh.split(",")]
    dtype = getattr(torch, args.param_dtype)

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp, ms in meshes:
                if args.all_ranks and ms is None:
                    ap.error("--all-ranks needs a DxM --mesh")
                ranks = [(0, 0)]
                if args.all_ranks and ms != "one":
                    ranks = [divmod(g, ms[1]) for g in range(ms[0] * ms[1])]
                for replica, rank in ranks:
                    name = mesh_name(mp, ms)
                    tag = "" if (replica, rank) == (0, 0) else \
                        f"__r{replica}_{rank}"
                    path = os.path.join(
                        args.out, f"{arch}__{shape.replace(':', '-')}__"
                        f"{name}{tag}.json")
                    if args.skip_existing and os.path.exists(path):
                        print(f"[skip existing] {path}")
                        continue
                    print(f"=== dryrun {arch} × {shape} × {name} "
                          f"(replica {replica}, rank {rank})", flush=True)
                    try:
                        rec = run_one(arch, shape, mp, replica=replica,
                                      rank=rank, mesh_shape=ms,
                                      layers=args.layers, param_dtype=dtype)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        rec = {
                            "arch": arch, "shape": shape, "mesh": name,
                            "replica": replica, "rank": rank, "ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-2000:],
                        }
                        failures += 1
                        print(rec["error"], file=sys.stderr, flush=True)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    if rec.get("ok"):
                        r = rec["roofline"]
                        print(
                            f"  ok: compute {r['compute_s']*1e3:.2f}ms  "
                            f"memory {r['memory_s']*1e3:.2f}ms  collective "
                            f"{r['collective_s']*1e3:.2f}ms  dominant="
                            f"{r['dominant']}  useful="
                            f"{rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}"
                            f"  traced in {rec['trace_s']} s", flush=True)
                    elif rec.get("skipped"):
                        print(f"  skipped: {rec['reason']}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
