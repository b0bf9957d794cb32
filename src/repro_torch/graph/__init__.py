from .csr import (  # noqa: F401
    CSRGraph,
    ELLGraph,
    add_edges_csr,
    build_csr,
    ell_from_csr,
    remove_edges_csr,
)
