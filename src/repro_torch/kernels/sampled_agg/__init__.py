"""AFC power sums: ``sampled_moments`` (rescan) and ``prefix_power_sums`` (incremental)."""
