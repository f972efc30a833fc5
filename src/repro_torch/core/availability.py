"""Fleet availability vs failed fraction (paper §2.3, Fig. 3) — the port's
copy of `repro/core/availability.py`.

A scale-up domain is unusable at full TP if any of its GPUs failed; larger
domains amplify the same failed fraction. Analytic: E[clean] = (1-f)^S.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClusterSpec:
    n_gpus: int = 32_768
    domain_size: int = 64          # scale-up domain == TP degree (Fig. 3)
    domains_per_replica: int = 8   # paper §6.1: 8 NVL domains per DP replica


def sample_failed_domains(
    n_gpus: int, domain_size: int, n_failed: int, rng, blast_radius: int = 1
):
    """Failed-GPU count per domain, failures uniform over the cluster.
    blast_radius b: one failure takes out b GPUs of its domain (§6.4)."""
    n_domains = n_gpus // domain_size
    idx = rng.choice(n_gpus, size=n_failed, replace=False)
    dom = idx // domain_size
    counts = np.bincount(dom, minlength=n_domains)
    if blast_radius > 1:
        counts = np.minimum(counts * blast_radius, domain_size)
    return counts


def availability_full_tp(
    spec: ClusterSpec, failed_fraction: float, *, samples: int = 100,
    blast_radius: int = 1, seed: int = 0,
):
    """Fraction of GPUs in fully-clean domains (= usable at TP=domain size).
    Returns (median, min) over samples — Fig. 3 plots median + worst shade."""
    rng = np.random.default_rng(seed)
    n_failed = int(round(failed_fraction * spec.n_gpus))
    n_domains = spec.n_gpus // spec.domain_size
    vals = []
    for _ in range(samples):
        counts = sample_failed_domains(
            spec.n_gpus, spec.domain_size, n_failed, rng, blast_radius
        )
        vals.append((counts == 0).sum() / n_domains)
    vals = np.array(vals)
    return float(np.median(vals)), float(vals.min())


def availability_analytic(domain_size: int, failed_fraction: float) -> float:
    return float((1.0 - failed_fraction) ** domain_size)
