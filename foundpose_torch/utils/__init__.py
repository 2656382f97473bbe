"""utils layer of foundpose_torch."""
