"""GNN model plumbing: ``repro``'s ``models/gnn/common.py`` (the graph
batch, the scatter family, MLPs, radial bases).  The GNN models
themselves (schnet, pna, nequip, dimenet) are not ported yet (ROADMAP.md,
Queue 1)."""
from .common import GraphBatch  # noqa: F401
