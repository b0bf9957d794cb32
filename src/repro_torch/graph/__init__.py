"""Graph containers, generators, edit streams and the fanout sampler."""
from .csr import (  # noqa: F401
    COOEdges,
    CSRGraph,
    ELLGraph,
    add_edges_csr,
    build_csr,
    coo_from_csr,
    ell_from_csr,
    remove_edges_csr,
)
from .sampler import NeighborSampler, SampledBlock  # noqa: F401
