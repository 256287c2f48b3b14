"""Data substrate: synthetic LM pipeline + block-trace generators."""
