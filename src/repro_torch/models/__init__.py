"""The ported model stacks: DeepFM (``models/recsys.py``), the GNNs
PNA, GIN, DimeNet and NequIP (``models/gnn.py``) and the decoder-only LMs
(``models/transformer.py``: GQA, MLA, MoE, KV-cache serving)."""
from . import gnn, recsys, transformer  # noqa: F401
