"""Serving support: the latency model behind deadline-driven ingest."""
