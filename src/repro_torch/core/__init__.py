"""Graph store, aggregator algebra, workloads, oracle, state and the
device engine."""
