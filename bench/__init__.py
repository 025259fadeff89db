"""The benchmark of ``repro_torch``: streaming GNN sessions on one card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything the yardstick needs (inputs, the plain reference,
the work formulas, the trace reduction) lives here; from the program it
takes only the session it measures and that session's counters.
"""
