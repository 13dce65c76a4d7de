"""Tools the benchmark's limits and cells were set with; the benchmark's own
runs do not run them."""
