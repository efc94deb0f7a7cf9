"""Checkpoints -- counterpart of `repro.checkpoint`."""
