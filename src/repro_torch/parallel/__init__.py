"""Sharding rules of the port: the reference's partition specs and their
DTensor placements (``sharding``)."""
from . import sharding  # noqa: F401
