"""Failure-trace simulation (the port's copy of
`repro/core/failure_model.py`; numpy only, so its traces are bit-identical
to the reference's for the same config) calibrated to the Llama-3 training report
(paper §2.3, Fig. 4): Poisson failure arrivals, 78% hardware failures with
multi-day recovery, 22% software failures with ~3h recovery.

`simulate_events` is the one sampler: every failure carries its (domain, gpu)
placement and its recovery time, so the same trace drives both the Fig.-4
counts (`simulate_trace`, a thin wrapper) and the live lifecycle replay
(`runtime.orchestrator.TraceRunner`, which needs to know WHERE each failure
lands and when it heals).

Beyond binary fail/repair, the sampler covers the production degradation
taxonomy: STRAGGLER onsets (a domain computing ``slowdown``×
slower until cleared), LINK degradations (scale-up bandwidth at ``bw_frac``
of spec) and SDC suspicion windows — each a Poisson stream at a configurable
multiple of the base failure rate, sampled from its OWN seeded RNG stream
(``default_rng([seed, kind])``) so a mixed trace never perturbs the legacy
binary stream: at the default zero mix rates the output is bit-identical to
the pre-taxonomy sampler.

Scanning is vectorized over the arrival-sorted arrays (merged per-GPU
intervals + searchsorted difference arrays), so generating AND scanning a
100k-GPU multi-week trace takes seconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# Llama-3 (arXiv:2407.21783): 419 unexpected interruptions over 54 days of
# pre-training on 16,384 H100s  ->  per-GPU-hour rate:
LLAMA3_RATE_PER_GPU_HOUR = 419 / (54 * 24 * 16_384)   # ≈ 1.98e-5
HW_FRACTION = 0.78

# TraceEvents.kind codes (degrade/clear pairs share one interval: onset at
# start_h, cleared at end_h)
KIND_FAILURE, KIND_STRAGGLER, KIND_LINK, KIND_SDC = 0, 1, 2, 3
KIND_NAMES = ("failure", "straggler", "link", "sdc")


@dataclass(frozen=True)
class FailureTraceConfig:
    n_gpus: int = 32_768
    domain_size: int = 64               # scale-up domain width for placement
    days: float = 15.0
    rate_per_gpu_hour: float = LLAMA3_RATE_PER_GPU_HOUR
    rate_multiplier: float = 1.0        # §2.3 studies 3× spikes
    hw_fraction: float = HW_FRACTION
    hw_recovery_days: Tuple[float, float] = (3.0, 5.0)  # uniform in range
    sw_recovery_hours: float = 3.0
    dt_hours: float = 1.0
    seed: int = 0
    # --- degradation mix: Poisson onset rates as
    # multiples of the (multiplied) base failure rate; 0.0 = pure binary
    # trace, bit-identical to the pre-taxonomy sampler.
    straggler_rate_mult: float = 0.0
    link_rate_mult: float = 0.0
    sdc_rate_mult: float = 0.0
    straggler_slowdown: Tuple[float, float] = (1.2, 3.0)    # uniform in range
    straggler_duration_hours: Tuple[float, float] = (0.5, 6.0)
    link_bw_frac: Tuple[float, float] = (0.2, 0.9)
    link_duration_hours: Tuple[float, float] = (1.0, 12.0)
    sdc_clear_hours: float = 1.0      # suspicion window until cleared

    @property
    def n_domains(self) -> int:
        return self.n_gpus // self.domain_size

    @property
    def mixed(self) -> bool:
        """True when any degradation kind has a nonzero rate."""
        return bool(
            self.straggler_rate_mult or self.link_rate_mult
            or self.sdc_rate_mult
        )


_MIX_KEYS = {
    "straggler": "straggler_rate_mult",
    "link": "link_rate_mult",
    "sdc": "sdc_rate_mult",
}


def parse_trace_mix(spec: str) -> dict:
    """Parse the launchers' ``--trace-mix straggler=R,link=R,sdc=R`` spec
    into `FailureTraceConfig` kwargs (any subset of kinds, each a rate
    multiplier vs the binary failure base rate). Raises ValueError naming
    the offending segment — the launchers surface it via ``ap.error``."""
    out: dict = {}
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty spec {spec!r} (want KIND=RATE[,KIND=RATE...])")
    for part in parts:
        kind, sep, rate_s = part.partition("=")
        kind = kind.strip()
        key = _MIX_KEYS.get(kind)
        if not sep or key is None:
            raise ValueError(
                f"bad segment {part!r} (want KIND=RATE with KIND one of "
                f"{', '.join(_MIX_KEYS)})")
        if key in out:
            raise ValueError(f"duplicate kind {kind!r}")
        try:
            rate = float(rate_s)
        except ValueError:
            raise ValueError(f"bad rate {rate_s!r} for {kind!r}") from None
        if rate < 0:
            raise ValueError(f"negative rate {rate} for {kind!r}")
        out[key] = rate
    return out


@dataclass(frozen=True)
class TraceEvents:
    """Per-event health trace: each entry is one GPU entering a degraded
    state at ``start_h`` and leaving it at ``end_h`` (hours since the start
    of the observation window; lead-in events have start_h < 0 but may still
    be live inside the window). Sorted by start time.

    ``kind`` (KIND_* codes) distinguishes hard failures from degradations;
    ``severity`` carries the straggler slow factor / link bandwidth fraction
    (0.0 for failure and SDC entries). Both default to ``None`` for
    pre-taxonomy call sites — an all-failure trace."""

    start_h: np.ndarray     # (E,) onset
    end_h: np.ndarray       # (E,) recovery/clear completion
    gpu: np.ndarray         # (E,) global gpu id
    domain: np.ndarray      # (E,) gpu // domain_size
    is_hw: np.ndarray       # (E,) bool — hardware vs software failure
    kind: Optional[np.ndarray] = None       # (E,) int8 KIND_* (None = fail)
    severity: Optional[np.ndarray] = None   # (E,) float per-kind severity

    @property
    def n_events(self) -> int:
        return len(self.start_h)

    def kind_mask(self, kind: int) -> np.ndarray:
        """(E,) bool mask of events of ``kind`` (``kind=None`` arrays are
        all-failure traces)."""
        if self.kind is None:
            return np.full(self.n_events, kind == KIND_FAILURE)
        return self.kind == kind

    def _merged_failures(self):
        """Per-GPU MERGED failure intervals ``(start, end, domain)``.

        Arrivals are sampled independently of GPU state, so a second failure
        can land on a GPU whose first interval is still open — one dead GPU,
        two live intervals. Counting intervals would double-count it;
        merging each GPU's overlapping/touching half-open intervals first
        makes interval counts equal DISTINCT-GPU counts at every t, while staying a pure vectorized pass: lexsort by
        (gpu, start), a segmented running-max of ``end`` via the per-group
        offset trick, and a run-id cut wherever a start exceeds the running
        end. Cached — the trace is frozen."""
        cached = getattr(self, "_merged_cache", None)
        if cached is not None:
            return cached
        fail = self.kind_mask(KIND_FAILURE)
        g = np.asarray(self.gpu)[fail]
        s = np.asarray(self.start_h, dtype=np.float64)[fail]
        e = np.asarray(self.end_h, dtype=np.float64)[fail]
        if len(g) == 0:
            out = (np.empty(0), np.empty(0), np.empty(0, dtype=np.int64))
        else:
            order = np.lexsort((s, g))
            g, s, e = g[order], s[order], e[order]
            # segmented cummax of e within each gpu group: add a per-group
            # offset that dominates the value range, so the global cummax
            # "resets" at every group boundary
            span = float(e.max() - min(e.min(), s.min())) + 1.0
            run_end = np.maximum.accumulate(e + g * span) - g * span
            new_run = np.empty(len(g), dtype=bool)
            new_run[0] = True
            # cut at every gpu change; within a gpu, an interval overlapping
            # or touching the running end merges ([a,b) ∪ [b,c) = [a,c))
            new_run[1:] = (g[1:] != g[:-1]) | (s[1:] > run_end[:-1])
            starts_idx = np.flatnonzero(new_run)
            ms = s[starts_idx]
            me = np.maximum.reduceat(e, starts_idx)
            mg = g[starts_idx]
            out = (ms, me, mg)
        object.__setattr__(self, "_merged_cache", out)
        return out

    def failed_counts_at(self, t_h: float, n_domains: int,
                         domain_size: int) -> np.ndarray:
        """Concurrently-failed DISTINCT GPUs per domain at time ``t_h``
        (single-time view of `failed_counts_scan`; the clip stays as a belt
        against malformed traces)."""
        return self.failed_counts_scan(
            np.asarray([t_h], dtype=np.float64), n_domains, domain_size
        )[0]

    def failed_counts_scan(self, t_h: np.ndarray, n_domains: int,
                           domain_size: int) -> np.ndarray:
        """(T, n_domains) concurrently-failed DISTINCT GPU counts at every
        (ascending) sample time — the vectorized arrival-sorted scan: each
        merged interval contributes +1/−1 at its searchsorted entry/exit
        sample, a cumulative sum folds the difference array. O(E log E +
        E log T + T·D) total instead of O(E·T); bit-identical to the
        per-time unique/bincount scan (merged per-GPU intervals cover
        exactly the instants where ≥1 of that GPU's intervals is live)."""
        t = np.asarray(t_h, dtype=np.float64)
        assert t.ndim == 1 and (len(t) < 2 or bool(np.all(np.diff(t) >= 0))), (
            "failed_counts_scan needs ascending sample times"
        )
        ms, me, mg = self._merged_failures()
        dom = mg // domain_size
        # bincount-compatible width: a trailing partial domain (n_gpus not
        # divisible by domain_size) widens the output past n_domains
        width = max(n_domains, int(dom.max()) + 1 if len(dom) else 0)
        # live at t ⇔ start <= t < end: enters at the first sample >= start,
        # exits at the first sample >= end
        i0 = np.searchsorted(t, ms, side="left")
        i1 = np.searchsorted(t, me, side="left")
        diff = np.zeros((len(t) + 1, width), dtype=np.int64)
        np.add.at(diff, (i0, dom), 1)
        np.add.at(diff, (i1, dom), -1)
        counts = np.cumsum(diff[:-1], axis=0)
        return np.minimum(counts, domain_size)

    def live_total_scan(self, t_h: np.ndarray,
                        kind: int = KIND_FAILURE) -> np.ndarray:
        """(T,) live-INTERVAL counts of ``kind`` at every ascending sample
        time (raw intervals, not distinct GPUs — the Fig.-4 counting). Same
        difference-array scan as `failed_counts_scan`."""
        t = np.asarray(t_h, dtype=np.float64)
        mask = self.kind_mask(kind)
        s = np.asarray(self.start_h, dtype=np.float64)[mask]
        e = np.asarray(self.end_h, dtype=np.float64)[mask]
        diff = np.zeros(len(t) + 1, dtype=np.int64)
        np.add.at(diff, np.searchsorted(t, s, side="left"), 1)
        np.add.at(diff, np.searchsorted(t, e, side="left"), -1)
        return np.cumsum(diff[:-1])


def simulate_events(cfg: FailureTraceConfig) -> TraceEvents:
    """Sample the per-event trace. Memoryless arrivals across the fleet; each
    failure picks an (independent) recovery time by type and lands on a
    uniformly-random GPU. Warm-started by simulating a lead-in window longer
    than the max recovery so the trace starts in steady state.

    The count draws reuse `simulate_trace`'s historical RNG stream (placement
    is drawn after them), so aggregate counts are bit-identical to the old
    count-only sampler at the same seed. Each degradation kind samples from
    its OWN ``default_rng([seed, kind])`` stream, so mixing degradations in
    (or out) never perturbs the binary failure trace.
    """
    rng = np.random.default_rng(cfg.seed)
    lead_h = cfg.hw_recovery_days[1] * 24.0
    total_h = cfg.days * 24.0 + lead_h
    rate_per_hour = cfg.rate_per_gpu_hour * cfg.rate_multiplier * cfg.n_gpus

    n_events = rng.poisson(rate_per_hour * total_h)
    starts = rng.uniform(0.0, total_h, n_events)
    is_hw = rng.random(n_events) < cfg.hw_fraction
    rec = np.where(
        is_hw,
        rng.uniform(*cfg.hw_recovery_days, n_events) * 24.0,
        cfg.sw_recovery_hours,
    )
    gpu = rng.integers(0, cfg.n_gpus, n_events)
    kind = np.zeros(n_events, dtype=np.int8)
    severity = np.zeros(n_events, dtype=np.float64)

    def _degradation_stream(code, rate_mult, duration_h, sev_range):
        if not rate_mult:
            return None
        krng = np.random.default_rng([cfg.seed, code])
        n = krng.poisson(rate_per_hour * rate_mult * total_h)
        s = krng.uniform(0.0, total_h, n)
        if isinstance(duration_h, tuple):
            dur = krng.uniform(*duration_h, n)
        else:
            dur = np.full(n, float(duration_h))
        g = krng.integers(0, cfg.n_gpus, n)
        sev = (
            krng.uniform(*sev_range, n) if sev_range is not None
            else np.zeros(n)
        )
        return (s, s + dur, g, np.zeros(n, dtype=bool),
                np.full(n, code, dtype=np.int8), sev)

    streams = [(starts, starts + rec, gpu, is_hw, kind, severity)]
    for args in (
        (KIND_STRAGGLER, cfg.straggler_rate_mult,
         cfg.straggler_duration_hours, cfg.straggler_slowdown),
        (KIND_LINK, cfg.link_rate_mult, cfg.link_duration_hours,
         cfg.link_bw_frac),
        (KIND_SDC, cfg.sdc_rate_mult, cfg.sdc_clear_hours, None),
    ):
        st = _degradation_stream(*args)
        if st is not None:
            streams.append(st)
    starts, ends, gpu, is_hw, kind, severity = (
        np.concatenate(cols) for cols in zip(*streams)
    )

    order = np.argsort(starts, kind="stable")
    return TraceEvents(
        start_h=starts[order] - lead_h,
        end_h=ends[order] - lead_h,
        gpu=gpu[order],
        domain=gpu[order] // cfg.domain_size,
        is_hw=is_hw[order],
        kind=kind[order] if cfg.mixed else None,
        severity=severity[order] if cfg.mixed else None,
    )


def simulate_trace(cfg: FailureTraceConfig):
    """Returns (t_hours, n_failed) arrays — concurrently-failed GPU counts
    (live failure intervals; degradation kinds are excluded — the Fig.-4
    analytics are about absence). Count-only view over `simulate_events`,
    scanned with the vectorized difference-array pass (bit-identical to the
    old O(events·samples) broadcast)."""
    ev = simulate_events(cfg)
    t = np.arange(0.0, cfg.days * 24.0, cfg.dt_hours)
    return t, ev.live_total_scan(t)


def fraction_time_above(cfg: FailureTraceConfig, frac_threshold: float) -> float:
    """Fig. 4's headline: fraction of time with > threshold of GPUs failed."""
    _, n_failed = simulate_trace(cfg)
    return float((n_failed / cfg.n_gpus > frac_threshold).mean())


def steady_state_failed_fraction(cfg: FailureTraceConfig) -> float:
    """Little's-law mean: rate × mean recovery."""
    mean_rec_h = (
        cfg.hw_fraction * np.mean(cfg.hw_recovery_days) * 24.0
        + (1 - cfg.hw_fraction) * cfg.sw_recovery_hours
    )
    return cfg.rate_per_gpu_hour * cfg.rate_multiplier * mean_rec_h
