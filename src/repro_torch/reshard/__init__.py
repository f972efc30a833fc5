"""The partition-unit reshard engine (port of the serving part of
`repro.reshard`): Algorithm-1 planner, unit specs, the rank-buffer reshard
route and `ShardedState`."""
from repro_torch.reshard.state import ShardedState  # noqa: F401
