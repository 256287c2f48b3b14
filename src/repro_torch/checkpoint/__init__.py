"""Checkpointing in the reference's on-disk format, with async save."""
