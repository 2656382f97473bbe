"""Tools that set the benchmark's limits and bounds; no run of a cell uses them."""
