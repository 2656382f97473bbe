"""pose layer of foundpose_torch."""
