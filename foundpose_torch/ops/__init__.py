"""ops layer of foundpose_torch."""
