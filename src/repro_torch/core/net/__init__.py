"""Replay witnesses: round traces. The reliable transport and nemesis come
with a later slice."""
from .digest import trace_entry  # noqa: F401
