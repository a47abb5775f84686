"""Workload generators (numpy only)."""
from . import ycsb  # noqa: F401
