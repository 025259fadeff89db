"""Graph store, aggregator algebra, workloads, oracle, state, the host
engines and the device engine."""
from .engine import BatchStats, RecomputeEngine, RippleEngine  # noqa: F401
