"""Set-up seconds inside the program: the sum of the outermost set-up
stages it timed on the host clock (``repro_torch.tracing.setup_seconds``:
the graph store's CSR halves and edge set, the bootstrap's full pass,
contributors and aux state, the engine's uploads, and its warm-up, which
holds the kernels' build and load).  None where the program keeps no such
record."""


def read(ctx):
    try:
        from repro_torch.tracing import setup_seconds
    except ImportError:
        return None
    stages = setup_seconds(outermost=True)
    return sum(stages.values()) if stages else None
