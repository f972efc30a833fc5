"""Resilient NTP inference serving (port of `repro.serve`): a
continuous-batching engine, live KV-cache reshard on failure and repair
(`ShardedKV` for a cache of k/v leaves alone),
drain-then-retarget on degradations, an SLO router behind `ServeSession`,
and the analytic serving-goodput model."""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serve.kv_shard import ShardedKV  # noqa: F401
from repro_torch.serve.router import (  # noqa: F401
    SERVE_GEOM, Router, blast_radius_goodput, replica_serve_speed,
    serving_goodput_trace,
)
from repro_torch.serve.session import SERVE_POLICIES, ServeSession  # noqa: F401
