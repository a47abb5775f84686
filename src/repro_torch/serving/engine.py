"""Batched serving engine: admission, prefill, paged decode, live rebalance.

Requests are admitted into a decode batch; prefill fills a contiguous cache
that is copied into DiLi-indexed pages; decode steps run the paged path;
between steps the balancer may split the page index, and the decode keeps
running on the healed snapshot. The decode runs eagerly, one step per call.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.balancer import Balancer
from ..models import transformer as T
from ..models.config import ArchConfig
from .paged import PagedKVManager, paged_decode_step


class BatchOverflow(RuntimeError):
    """Admission past ``max_batch`` (an exception, so it survives
    ``python -O``)."""


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: np.ndarray           # [S] int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def check_servable(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` unless the paged engine serves ``cfg``: the
    dense text family with a float KV cache. The reference's engine
    serves no more (ROADMAP Queue 3 item 6): it admits moe and vlm
    configs and then fails deep in a step, with ``KeyError: 'mlp'`` in
    ``paged_decode_step`` (no MoE FFN) or ``KeyError: 'patch_embeds'``
    at admission."""
    if cfg.family != "dense" or cfg.modality != "text":
        raise ValueError(
            f"{cfg.name}: the paged serving engine runs the dense text "
            f"family, not family {cfg.family!r} / modality "
            f"{cfg.modality!r} (ROADMAP Queue 3 item 6); serve it with "
            f"models.transformer.forward_serve")
    if cfg.kv_quant:
        raise ValueError(
            f"{cfg.name}: the paged serving engine keeps float KV pages; "
            f"the int8 KV cache (kv_quant) runs through "
            f"models.transformer.forward_serve")


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: T.LM, *,
                 page_size: int = 16, num_pages: int = 256,
                 max_batch: int = 8, dili_shards: int = 1,
                 dtype=torch.float32, use_kernel: bool = False,
                 refresh_mode: str = "range", device="cuda"):
        check_servable(cfg)
        self.cfg, self.params = cfg, params
        self.kv = PagedKVManager(cfg, num_pages=num_pages,
                                 page_size=page_size,
                                 dili_shards=dili_shards, dtype=dtype,
                                 device=device)
        self.device = self.kv.device
        self.page_size = page_size
        self.max_batch = max_batch
        self.use_kernel = use_kernel
        if refresh_mode not in ("range", "rescan"):
            raise ValueError(f"refresh_mode={refresh_mode!r} not in "
                             f"('range', 'rescan')")
        # how the page-table snapshot heals after a re-partition:
        # "range" = one RANGE scan per live sequence (DESIGN.md §16),
        # "rescan" = the cluster-wide chain walk (benchmark baseline)
        self.refresh_mode = refresh_mode
        self.active: List[Request] = []
        self.balancer = Balancer(self.kv.backend, split_threshold=64)

    def _pages(self, r: Request) -> int:
        return (len(r.prompt) + r.max_new + self.page_size - 1) \
            // self.page_size

    # --------------------------------------------------------------- admit
    def admit(self, req: Request) -> None:
        if len(self.active) >= self.max_batch:
            raise BatchOverflow(
                f"admit: decode batch is full ({len(self.active)}/"
                f"{self.max_batch}) — finish or evict a sequence first")
        s = len(req.prompt)
        n_pages = self._pages(req)
        self.kv.alloc_pages(req.seq_id, n_pages)
        # prefill with a contiguous cache, then copy into pages
        cache = T.init_cache(self.cfg, 1, n_pages * self.page_size,
                             dtype=self.kv.dtype, device=self.device)
        toks = torch.from_numpy(np.asarray(req.prompt, np.int64)[None, :])
        logits, cache = T.forward_serve(
            self.params, self.cfg, {"tokens": toks.to(self.device)}, cache,
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            decode=False)
        self.kv.write_prefill({"k": cache["k"][:, :1],
                               "v": cache["v"][:, :1]}, [req.seq_id], [s])
        req.out.append(int(torch.argmax(logits[0])))
        self.active.append(req)

    # --------------------------------------------------------------- decode
    def step(self, *, rebalance: bool = False) -> None:
        live = [r for r in self.active if not r.done]
        if not live:
            return
        if rebalance:
            self.balancer.step()
            self.kv.client.drain(600)
            if self.refresh_mode == "range":
                self.kv.refresh_seqs([r.seq_id for r in live])
            else:
                self.kv.refresh_table()
        page_table = self.kv.page_table([r.seq_id for r in live],
                                        [self._pages(r) for r in live])
        seq_lens = np.asarray([len(r.prompt) + len(r.out) - 1 for r in live],
                              np.int32)
        tokens = torch.tensor([[r.out[-1]] for r in live], dtype=torch.int64,
                              device=self.device)
        logits, _, _ = paged_decode_step(
            self.params, self.cfg, tokens, self.kv.k_pages,
            self.kv.v_pages, page_table, seq_lens,
            page_size=self.page_size, use_kernel=self.use_kernel)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, r in enumerate(live):
            r.out.append(int(nxt[i]))
            if len(r.out) >= r.max_new:
                r.done = True
                self.kv.free_seq(r.seq_id, self._pages(r))
        self.active = [r for r in self.active if not r.done]
