"""models layer of foundpose_torch."""
