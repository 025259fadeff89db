"""Model families of the port: the language models (``models.lm``: dense
GQA, MoE, MLA), DLRM (``models.recsys``) and the GNN plumbing
(``models.gnn.common``).  The GNN models themselves are still to come
(ROADMAP.md, Queue 1)."""
