"""Streaming update generation (paper protocol)."""
