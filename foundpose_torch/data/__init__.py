"""data layer of foundpose_torch."""
