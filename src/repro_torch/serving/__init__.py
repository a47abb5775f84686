"""Batched serving over a paged KV cache whose (sequence, page) -> slot
index is a DiLi list."""
from .engine import BatchOverflow, Request, ServingEngine  # noqa: F401
from .paged import (PagedKVManager, PagePoolExhausted,  # noqa: F401
                    page_key, paged_decode_step)
