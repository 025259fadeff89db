"""Model families of the port.  Only the dense-GQA language model
(``models.lm``) is ported so far; the GNN and recsys models of ``repro``
are still to come (ROADMAP.md, Queue 1)."""
