"""Host-side NTP models (numpy): Algorithm-1 shard mapping, the power model
and the serving policy blends."""
