"""Generators over the paged KV cache."""
