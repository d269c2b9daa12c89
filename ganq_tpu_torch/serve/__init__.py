"""Serving: KV cache, prefill, decode and generation."""
