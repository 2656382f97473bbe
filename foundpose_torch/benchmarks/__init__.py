"""benchmarks layer of foundpose_torch."""
