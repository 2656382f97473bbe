"""renderer layer of foundpose_torch."""
