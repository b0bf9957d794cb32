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
