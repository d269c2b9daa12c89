"""Model configuration, weights, registry, HF import and synthetic builders."""
