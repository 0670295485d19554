"""Checkpoints (``checkpoint``) in the reference's on-disk layout."""
