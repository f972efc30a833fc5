"""The port stands alone and never falls back: importing `repro_torch` loads
neither JAX nor the JAX package, and a CUDA-only call without a card
raises instead of running somewhere else."""
import os
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PORT_MODULES = [
    "repro_torch",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint",
    "repro_torch.cluster",
    "repro_torch.cluster.actions",
    "repro_torch.cluster.allocator",
    "repro_torch.cluster.cost",
    "repro_torch.cluster.goodput",
    "repro_torch.cluster.plan",
    "repro_torch.convert",
    "repro_torch.configs",
    "repro_torch.configs.shapes",
    "repro_torch.core.availability",
    "repro_torch.core.collectives",
    "repro_torch.core.failure_model",
    "repro_torch.core.nonuniform",
    "repro_torch.core.ntp_train",
    "repro_torch.core.overlap",
    "repro_torch.core.perf_model",
    "repro_torch.core.policies",
    "repro_torch.core.power",
    "repro_torch.core.reshard",
    "repro_torch.core.resource_manager",
    "repro_torch.core.shard_mapping",
    "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.kernels.bucket",
    "repro_torch.kernels.build",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.mode",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.reshard_pack",
    "repro_torch.kernels.rmsnorm",
    "repro_torch.kernels.ssd_scan",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.dryrun_ntp",
    "repro_torch.launch.mesh",
    "repro_torch.launch.op_analysis",
    "repro_torch.launch.profile",
    "repro_torch.launch.serve",
    "repro_torch.launch.serve_decode",
    "repro_torch.launch.spawn",
    "repro_torch.launch.telemetry_report",
    "repro_torch.launch.train",
    "repro_torch.models.attention",
    "repro_torch.models.common",
    "repro_torch.models.mlp",
    "repro_torch.models.rglru",
    "repro_torch.models.ssm",
    "repro_torch.models.transformer",
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.optim.base",
    "repro_torch.optim.schedule",
    "repro_torch.reshard",
    "repro_torch.reshard.engine",
    "repro_torch.reshard.planner",
    "repro_torch.reshard.state",
    "repro_torch.reshard.transition",
    "repro_torch.reshard.twin",
    "repro_torch.reshard.units",
    "repro_torch.runtime",
    "repro_torch.runtime.events",
    "repro_torch.runtime.orchestrator",
    "repro_torch.runtime.session",
    "repro_torch.serve",
    "repro_torch.serve.kv_shard",
    "repro_torch.sharding",
    "repro_torch.sharding.specs",
    "repro_torch.telemetry",
    "repro_torch.telemetry.export",
    "repro_torch.telemetry.recorder",
    "repro_torch.telemetry.sinks",
    "repro_torch.train",
    "repro_torch.train.steps",
    "repro_torch.tree",
]


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card(no_card):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels.mode import resolve_device
    from repro_torch.launch.serve import main
    from repro_torch.launch.serve_decode import main as decode_main
    from repro_torch.models.transformer import Model
    from repro_torch.serve import ServeSession

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.ntp_train import NTPModelConfig, init_canonical
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime import NTPSession
    from repro_torch.train.steps import make_setup

    cfg = reduced(get_arch("qwen2-7b"))
    shape = ShapeSpec("t", 8, 2, "train")
    ntp = NTPModelConfig(n_layers=1)
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: Model(cfg),
        lambda: ServeSession.create(cfg),
        lambda: params_from_jax({"embed": [[0.0]], "final_norm": {"w": [0.0]}}),
        lambda: main(["--requests", "1"]),
        lambda: decode_main([]),
        lambda: train_main(["--ntp", "--steps", "1"]),
        lambda: NTPSession.create(ntp),
        lambda: init_canonical(ntp),
        lambda: NTPSession.from_arch(cfg, shape),
        lambda: make_setup(cfg, shape),
        lambda: train_main(["--arch", "qwen2-7b", "--reduced", "--steps",
                            "1"]),
        lambda: SyntheticLMPipeline(DataConfig(512, 8, 2)).batch(0),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """Off the CPU and CUDA only meta is taken (shapes only, counted as a
    dry launch, never as a launch); any other device, and tensors on two
    devices, raise."""
    from repro_torch.kernels import mode
    from repro_torch.kernels.bucket import bucket_pack, bucket_unpack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.reshard_pack import reshard_pack
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    from torch_elsewhere import Elsewhere as E

    x = E(4, 8)
    with pytest.raises(ValueError, match="rmsnorm: no kernel for device xpu"):
        rmsnorm(x, E(8))
    q = E(1, 2, 16, 32)
    with pytest.raises(ValueError, match="flash_attention: no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="reshard_pack: no kernel"):
        reshard_pack(x, E(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="bucket_pack: no kernel"):
        bucket_pack([x, x])
    with pytest.raises(ValueError, match="bucket_unpack: no kernel"):
        bucket_unpack(x, (4, 4))
    with pytest.raises(ValueError, match="ssd_scan: no kernel"):
        ssd_scan(E(1, 4, 8), E(1, 4), E(1), E(1, 4, 8), E(1, 4, 8))
    with pytest.raises(ValueError, match="several devices"):
        rmsnorm(torch.zeros(4, 8), torch.empty(8, device="meta"))
    before = mode.launches()
    m = torch.empty((4, 8), device="meta")
    assert rmsnorm(m, torch.empty(8, device="meta")).is_meta
    assert mode.launches() == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
