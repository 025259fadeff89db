"""Model families of the port: the language models (``models.lm``: dense
GQA, MoE, MLA), DLRM (``models.recsys``) and the GNNs (``models.gnn``:
SchNet, PNA, NequIP, DimeNet, the neighbour sampler and owner-partitioned
SchNet)."""
