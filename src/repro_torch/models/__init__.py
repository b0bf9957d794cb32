"""The ported model stacks (so far DeepFM, ``models/recsys.py``)."""
from . import recsys  # noqa: F401
