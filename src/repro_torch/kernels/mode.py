"""Device dispatch and launch counters for the hand-written kernels.

The JAX package resolves Pallas interpret-vs-compiled mode here; the port
has no interpret mode. A kernel wrapper takes its plain PyTorch version
(`kernels.ref`) only when its tensors lie on the CPU, launches the CUDA
kernel when they lie on a CUDA device, and raises otherwise: there is no
override and no fallback.

The CUDA kernels are forward-only: `rmsnorm`, `flash_attention` and
`ssd_scan` call `check_forward_only` before a launch, which raises when
grad mode is on and an input requires grad — the kernel's output would
carry no gradient, and everything upstream would silently get none. (Their
plain versions on the CPU are differentiable; training computes with plain
ops on every device.)

Each wrapper adds one to its kernel's counter where it launches the kernel
and nowhere else, so a run can show that a path really went through the
kernels (`reset_launches` before it, `launches` after it); a wrapper with
variants (`flash_attention`'s mask kinds) also counts the launch under its
variant (`variant_launches`). With telemetry
active, each launch and each call that takes the plain version also counts
into the reference's ``kernels.dispatch`` series (labels ``kernel`` and
``mode``: ``"cuda"`` for a launch, ``"cpu"`` for the plain version); with
telemetry off that costs one attribute check of the active recorder.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch import telemetry

KERNELS = ("rmsnorm", "flash_attention", "reshard_pack", "bucket_pack",
           "bucket_unpack", "ssd_scan")

_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_variants: Dict[str, int] = {}


def count_launch(kernel: str, variant: Optional[str] = None) -> None:
    _launches[kernel] += 1
    if variant is not None:
        key = f"{kernel}:{variant}"
        _variants[key] = _variants.get(key, 0) + 1
    if telemetry._active.enabled:
        telemetry._active.counter("kernels.dispatch", kernel=kernel,
                                  mode="cuda")


def launches() -> Dict[str, int]:
    """Launches per kernel since the last `reset_launches`."""
    return dict(_launches)


def variant_launches() -> Dict[str, int]:
    """Launches per ``kernel:variant`` since the last `reset_launches`."""
    return dict(_variants)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
    _variants.clear()


def on_cpu(*tensors: torch.Tensor, kernel: str) -> bool:
    """True when every tensor lies on the CPU (run the plain version), False
    when all lie on one CUDA device (launch the kernel). Raises for mixed
    devices or any other device type. The common case, every tensor on one
    CUDA device, reads only integer device indices (it runs on every
    launch)."""
    index = tensors[0].get_device()
    if index >= 0:
        for t in tensors:
            if t.get_device() != index or not t.is_cuda:
                break
        else:
            return False
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors lie on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        if telemetry._active.enabled:
            telemetry._active.counter("kernels.dispatch", kernel=kernel,
                                      mode="cpu")
        return True
    raise ValueError(f"{kernel}: no kernel for device {device}")


def check_forward_only(*tensors: torch.Tensor, kernel: str) -> None:
    """Raise a RuntimeError naming ``kernel`` when grad mode is on and any of
    ``tensors`` requires grad (a launch would drop the gradient)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel is forward-only, but grad mode is on "
            "and an input requires grad, so its output would carry no "
            "gradient; run it under torch.no_grad(), or train through the "
            "plain route (models.transformer.Model.forward)"
        )


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and no card is
    present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
