"""Synthetic data for the ported model stacks (numpy, seeded)."""
from .graphs import load_cora_like, random_molecule_batch  # noqa: F401
from .lm import synthetic_lm_batches  # noqa: F401
from .recsys import synthetic_ctr_batches  # noqa: F401
