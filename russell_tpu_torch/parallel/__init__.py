"""Multi-rank parallelism on ``torch.distributed``.

Counterpart of ``russell_tpu.parallel``, with its module names and its 12
exported names. The reference runs one controller over a
``jax.sharding.Mesh``: ``shard_map`` and sharding annotations split the
work, and one process gets global arrays back. The port runs SPMD: one
process per rank, each on one device, every rank making the same call on
its own share, with the collectives written out. The mapping:

=================================  =====================================
reference (``russell_tpu.parallel``)  port (``russell_tpu_torch.parallel``)
=================================  =====================================
``initialize_multihost`` over      ``torch.distributed.init_process_group``
``jax.distributed``                with an explicit backend (``nccl`` on
                                   the card, ``gloo`` only for
                                   ``device="cpu"``) and rendezvous
                                   (``tcp://`` from the coordinator
                                   address, or ``file://``); a no-op when
                                   a group exists
``make_mesh`` over ``jax.devices``  a ``DeviceMesh`` over the group's
                                   ranks, on the card (``cuda:{local
                                   rank}``) unless ``device="cpu"``;
                                   raises without a card
``shard_csr_rows``,                the same host plan of padded row slabs;
``dist_mat_vec_mul`` (shard_map)   a rank passes its x segment, x is
                                   all-gathered and the rank's slab summed
                                   per row in a fixed order; returns the
                                   rank's y segment
``batch_factor_solve`` (vmap,      the global (B, nnz) and (B, n), B a
batch axis sharded)                multiple of the ranks; rank r solves
                                   rows [r B/W, (r+1) B/W), the results
                                   all-gathered: (B, n) on every rank
``dist_splu_factorize`` (pairs     each row's pairs cut into one run per
sharded, ``psum``)                 rank, summed by ``splu_pairs`` under
                                   the rank's own chunk schedule, one
                                   ``all_reduce`` per row; the rest of the
                                   row replicated
``dist_gridmf_*`` (node axis       node blocks [a, b) per rank at every
sharded by annotation)             depth the ranks divide (children [2a,
                                   2b) local); the children's Schur
                                   complements all-gathered at the first
                                   depth they do not; x all-gathered
``dist_genmf_*`` (class node axis  node blocks per rank in every class the
sharded by annotation)             ranks divide, its Schur complements
                                   all-gathered before any parent gathers
                                   from them; other classes replicated
``shard_banded_*`` (GSPMD over     each level's odd-row lanes split where
BCR's block axis)                  the ranks divide them, D_o^{-1} F_o and
                                   D_o^{-1} E_o all-gathered for the
                                   neighbour shifts
=================================  =====================================

log|det|, min|pivot|, n_perturbed and the sign of a split stage are
gathered from every rank and folded in rank order (``MeshAxis.combine``),
not all-reduced, so every rank holds the same bits; with one rank every
call returns the single-device result bit for bit. The ``dist_*``
functions take the port's plans (built from the same (n, rows, cols) as
the reference's) and entry values as numpy arrays or tensors.
"""

from russell_tpu_torch.parallel.mesh import make_mesh
from russell_tpu_torch.parallel.dist_sparse import (dist_mat_vec_mul,
                                                    shard_csr_rows)
from russell_tpu_torch.parallel.batch import batch_factor_solve
from russell_tpu_torch.parallel.multihost import (initialize_multihost,
                                                  shard_banded_factorize,
                                                  shard_banded_solve)
from russell_tpu_torch.parallel.dist_splu import dist_splu_factorize
from russell_tpu_torch.parallel.dist_gridmf import (dist_gridmf_factorize,
                                                    dist_gridmf_solve)
from russell_tpu_torch.parallel.dist_genmf import (dist_genmf_factorize,
                                                   dist_genmf_solve)

__all__ = [
    "make_mesh",
    "dist_mat_vec_mul",
    "shard_csr_rows",
    "batch_factor_solve",
    "initialize_multihost",
    "shard_banded_factorize",
    "shard_banded_solve",
    "dist_splu_factorize",
    "dist_gridmf_factorize",
    "dist_gridmf_solve",
    "dist_genmf_factorize",
    "dist_genmf_solve",
]
