"""pipeline layer of foundpose_torch."""
