"""vis layer of foundpose_torch."""
