"""Data substrate: synthetic block-trace generators."""
