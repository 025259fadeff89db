"""dimenet [arXiv:2003.03123]: 6 blocks d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6 -- triplet directional message passing."""
from functools import partial

from repro_torch.models.gnn.dimenet import dimenet_forward, init_dimenet
from .gnn_common import cell_builders, gnn_cells

HP = dict(d_hidden=128, n_blocks=6, n_bilinear=8, n_spherical=7, n_radial=6,
          cutoff=5.0)
INIT = partial(init_dimenet, **HP)
FORWARD = partial(dimenet_forward, n_spherical=7, n_radial=6, cutoff=5.0)
MOLECULAR, WITH_TRIPLETS, N_LAYERS = True, True, HP["n_blocks"]

CELLS = gnn_cells("dimenet", INIT, FORWARD, molecular=MOLECULAR,
                  with_triplets=WITH_TRIPLETS, d_hidden=HP["d_hidden"],
                  n_layers=N_LAYERS)

SMOKE_INIT = partial(init_dimenet, d_hidden=16, n_blocks=2, n_bilinear=4,
                     n_spherical=4, n_radial=4, cutoff=4.0)
SMOKE_FORWARD = partial(dimenet_forward, n_spherical=4, n_radial=4, cutoff=4.0)


def cells() -> dict:
    """The four cells' materialising builders, by shape name."""
    return cell_builders("dimenet", INIT, FORWARD, molecular=MOLECULAR,
                         with_triplets=WITH_TRIPLETS,
                         d_hidden=HP["d_hidden"], n_layers=N_LAYERS)
