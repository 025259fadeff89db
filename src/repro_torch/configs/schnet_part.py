"""schnet-part: SchNet on ogb_products with OWNER-PARTITIONED push-based
message passing (``models/gnn/partitioned.py``) over a group of P ranks,
at SchNet's published widths (``configs/schnet.py``'s ``HP``).

Capacity assumptions (documented, not silent): e_cap = 1.3x the mean
edges a partition (LDG imbalance slack measured on scaled samples);
halo_cap = 4x the mean per-destination message count; v2's cap2 = 1.5x
the mean edges a (source, destination) pair.  The cells' builders wait
for the dry run (ROADMAP.md Queue 1, item 5.3).
"""
from __future__ import annotations

from .common import cells_not_ported

N, M, D, CLASSES = 2449408, 61859840, 100, 47


def capacities(n_parts: int, n: int = N, m: int = M) -> dict:
    """n_local, e_cap, halo_cap (v1) and cap2 (v2) of the cell over
    ``n_parts`` ranks, for a graph of ``n`` vertices and ``m`` edges (the
    cell's own by default)."""
    n_local = n // n_parts
    if n_local * n_parts != n:
        raise ValueError(f"{n} vertices do not split over {n_parts} ranks")
    e_cap = int(-(-int(m / n_parts * 1.3) // 1024) * 1024)
    halo_cap = int(-(-int(e_cap / n_parts * 4) // 256) * 256)
    cap2 = int(-(-int(m / n_parts ** 2 * 1.5) // 256) * 256)
    return dict(n_local=n_local, e_cap=e_cap, halo_cap=halo_cap, cap2=cap2)

# the dry-run cells: ROADMAP.md Queue 1 item 5.4
__getattr__ = cells_not_ported(__name__)
