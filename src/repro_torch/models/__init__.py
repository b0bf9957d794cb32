"""The ported model stacks: DeepFM (``models/recsys.py``) and the GNNs
PNA, GIN, DimeNet and NequIP (``models/gnn.py``)."""
from . import gnn, recsys  # noqa: F401
