"""Dynamic power allocation model (paper §3.2, Table 1, §6.4) — the port's
copy of `repro/core/power.py`.

The proposed rack re-allocates failed GPUs' power budget to the survivors
(up to +30% TDP). We model achievable speedup as perf ∝ power^β in the boost
region, with β calibrated to Table 1:

  TP30-PW: full batch at 1.15× power, rel iter .978  -> needs 32/30 ≈ 1.067
           speedup:  β = ln(32/30)/ln(1.15) ≈ 0.46
  TP28-PW: full batch at 1.30× power, rel iter .999  -> needs 32/28 ≈ 1.143
           speedup:  β = ln(32/28)/ln(1.30) ≈ 0.51

We use β = 0.5 (sqrt law — consistent with published DVFS curves in the
boost region) and cap boost at 1.3× per §3.2.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BETA = 0.5
MAX_BOOST = 1.30


@dataclass(frozen=True)
class PowerModel:
    beta: float = BETA
    max_boost: float = MAX_BOOST

    def speedup(self, power_mult: float) -> float:
        """Per-GPU compute speedup at power_mult × TDP."""
        return float(np.clip(power_mult, 0.1, self.max_boost) ** self.beta)

    def required_power(self, tp_reduced: int, tp_full: int) -> float:
        """Power multiplier for a TP-reduced domain to match healthy-domain
        iteration time at FULL local batch (NTP-PW). Work per surviving GPU
        scales by tp_full/tp_reduced."""
        need = tp_full / tp_reduced
        return float(need ** (1.0 / self.beta))

    def required_power_for_speedup(self, speedup: float) -> float:
        return float(max(speedup, 1.0) ** (1.0 / self.beta))

    def can_boost(self, tp_reduced: int, tp_full: int) -> bool:
        # §3.2: repurposing the failed GPUs' budget gives (tp_full/tp_reduced)×
        # power available; the rack supports at most max_boost.
        avail = min(tp_full / tp_reduced, self.max_boost)
        return self.required_power(tp_reduced, tp_full) <= avail + 1e-9

    def perf_per_watt_penalty(self, power_mult: float) -> float:
        """§6.4: perf/W loss of running boosted (negative = worse)."""
        return self.speedup(power_mult) / power_mult - 1.0
