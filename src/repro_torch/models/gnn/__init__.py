"""GNN models of the port, ``repro``'s ``models/gnn``: the plumbing
(``common``: the graph batch, the scatter family, MLPs, radial bases),
SchNet, PNA, NequIP and DimeNet, the host-side neighbour sampler, SchNet
owner-partitioned over ``torch.distributed`` (``partitioned``) and the
weight carry from the reference (``convert``).  Edge gathers are
``index_select``, whose backward is an ``index_add_``: an indexing
gather's backward (a sorted ``index_put_``) took 2.40 of DimeNet's 2.64 s
step at ogb_products on an H100."""
from .common import GraphBatch  # noqa: F401
