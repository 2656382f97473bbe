"""parallel layer of foundpose_torch: host-level dataset sharding (the multi-device layer comes later)."""
