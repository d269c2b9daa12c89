"""Configuration and kernel-backend selection."""
