from .csr import (  # noqa: F401
    CSRGraph,
    add_edges_csr,
    build_csr,
    remove_edges_csr,
)
