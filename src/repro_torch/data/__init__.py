"""Synthetic data for the ported model stacks (numpy, seeded)."""
from .recsys import synthetic_ctr_batches  # noqa: F401
