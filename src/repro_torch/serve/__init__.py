"""Resilient NTP inference serving (port of `repro.serve`): a
continuous-batching engine, live KV-cache reshard on failure and repair,
and an SLO router behind `ServeSession`."""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serve.router import (  # noqa: F401
    SERVE_GEOM, Router, replica_serve_speed,
)
from repro_torch.serve.session import SERVE_POLICIES, ServeSession  # noqa: F401
