"""schnet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10."""
from functools import partial

from repro_torch.models.gnn.schnet import init_schnet, schnet_forward
from .gnn_common import cell_builders, gnn_cells

HP = dict(d_hidden=64, n_interactions=3, n_rbf=300, cutoff=10.0)
INIT = partial(init_schnet, **HP)
FORWARD = partial(schnet_forward, n_rbf=HP["n_rbf"], cutoff=HP["cutoff"])
MOLECULAR, WITH_TRIPLETS, N_LAYERS = True, False, HP["n_interactions"]

CELLS = gnn_cells("schnet", INIT, FORWARD, molecular=MOLECULAR,
                  d_hidden=HP["d_hidden"], n_layers=N_LAYERS)

# reduced smoke config
SMOKE_INIT = partial(init_schnet, d_hidden=16, n_interactions=2, n_rbf=20,
                     cutoff=5.0)
SMOKE_FORWARD = partial(schnet_forward, n_rbf=20, cutoff=5.0)


def cells() -> dict:
    """The four cells' materialising builders, by shape name."""
    return cell_builders("schnet", INIT, FORWARD, molecular=MOLECULAR,
                         d_hidden=HP["d_hidden"], n_layers=N_LAYERS)
