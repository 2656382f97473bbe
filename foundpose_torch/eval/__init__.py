"""eval layer of foundpose_torch."""
