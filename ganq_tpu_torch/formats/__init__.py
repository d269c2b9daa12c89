"""Checkpoint formats."""
