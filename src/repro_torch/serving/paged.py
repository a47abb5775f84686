"""Paged KV cache with a DiLi page table (DESIGN.md §3.1, §16).

The page table is a DiLi instance: key = (seq_id << PAGE_BITS) | page_idx,
value = physical page slot. The (seq, page) -> slot index is dynamically
re-partitionable: the balancer splits it between decode steps while the
decode keeps running on a snapshot of it.

The decode step consumes a dense snapshot ``page_table[b, p]`` built on
the host from the manager's cache of the index. Because page keys pack
(seq_id, page) into one sorted key space, a sequence's pages occupy one
contiguous key interval, so healing the snapshot after a re-partition is
one ``RANGE`` scan over ``[seq_id << PAGE_BITS, (seq_id+1) << PAGE_BITS)``
per live sequence (``refresh_seqs``) instead of a rescan of every chain
(``refresh_table``, the slow fallback and the benchmark baseline).
Snapshot misses are a ``-1`` sentinel that the decode step masks: the new
token's KV write skips the row (the mask is computed on the host, before
the upload), and the attention clamps the id to page 0 and hides it with
the length mask. A miss never aliases onto physical slot 0.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..api import DiLiClient, LocalBackend
from ..core.types import DiLiConfig, resolve_device
from ..kernels import ops as K
from ..models import transformer as T
from ..models.attention import decode_attention, qkv_proj
from ..models.config import ArchConfig
from ..models.layers import rms_norm

PAGE_BITS = 12                      # up to 4096 pages per sequence


class PagePoolExhausted(RuntimeError):
    """No free physical page slots (an exception, so it survives
    ``python -O``)."""


def page_key(seq_id: int, page: int) -> int:
    return (seq_id << PAGE_BITS) | page


class PagedKVManager:
    """Host-side page allocation backed by a DiLi cluster; the KV pages
    are one [L, P, S, KH, D] tensor each for K and V on ``device``, updated
    in place."""

    def __init__(self, cfg: ArchConfig, *, num_pages: int, page_size: int,
                 dili_shards: int = 1, dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.dtype = dtype
        self.device = resolve_device(device)
        kh, hd, nl = cfg.n_kv_heads, cfg.hd, cfg.n_layers
        shape = (nl, num_pages, page_size, kh, hd)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.free_slots: List[int] = list(range(num_pages - 1, -1, -1))
        dcfg = DiLiConfig(num_shards=dili_shards,
                          pool_capacity=max(4 * num_pages, 1024),
                          max_sublists=64, max_ctrs=64,
                          max_scan=max(4 * num_pages, 1024),
                          batch_size=32, mailbox_cap=256, move_batch=16,
                          range_scan=True)
        self.backend = LocalBackend(dcfg, device=self.device)
        self.client = DiLiClient(self.backend)
        # the raw cluster stays reachable for tests/tools that inject
        # background commands or inspect chains directly
        self.dili = self.backend.cluster
        self._table: Dict[int, int] = {}   # key -> slot (snapshot cache)
        # authoritative host-side allocation record (key -> slot): the
        # ground truth for "was this page ever allocated", independent of
        # the snapshot cache's staleness during re-partitions
        self._allocated: Dict[int, int] = {}

    # ------------------------------------------------------------ alloc/free
    def alloc_page(self, seq_id: int, page: int) -> int:
        if not self.free_slots:
            raise PagePoolExhausted(
                f"page pool exhausted: all {self.num_pages} physical "
                f"slots are live (alloc seq={seq_id} page={page})")
        slot = self.free_slots.pop()
        key = page_key(seq_id, page)
        fut = self.client.insert(key, value=slot)
        self.client.drain()
        if not fut.result(wait=False):
            self.free_slots.append(slot)
            raise RuntimeError(
                f"alloc_page: key {key} (seq={seq_id} page={page}) is "
                f"already present in the page table — double allocation")
        self._table[key] = slot
        self._allocated[key] = slot
        return slot

    def alloc_pages(self, seq_id: int, n_pages: int) -> List[int]:
        """Allocate ``n_pages`` consecutive pages for one sequence in a
        single batched insert (one drain instead of one per page)."""
        if len(self.free_slots) < n_pages:
            raise PagePoolExhausted(
                f"page pool exhausted: {len(self.free_slots)} free slots "
                f"< {n_pages} requested (alloc seq={seq_id})")
        keys = [page_key(seq_id, p) for p in range(n_pages)]
        slots = [self.free_slots.pop() for _ in keys]
        res = self.client.insert_batch(keys, slots)
        self.client.drain()
        bad = []
        for k, slot, ok in zip(keys, slots, res.results(wait=False)):
            if ok:
                # live in DiLi now — must be tracked even on a partial
                # failure, or its slot could be recycled into an alias
                self._table[k] = slot
                self._allocated[k] = slot
            else:
                self.free_slots.append(slot)
                bad.append(k)
        if bad:
            raise RuntimeError(
                f"alloc_pages: keys {bad[:4]} (seq={seq_id}) already "
                f"present in the page table — double allocation")
        return slots

    def free_seq(self, seq_id: int, num_pages: int) -> None:
        """Remove a sequence's page mappings and recycle their slots, each
        only once its remove is confirmed: a failed remove would leave the
        key live while the slot is reissued to another sequence."""
        keys = [page_key(seq_id, p) for p in range(num_pages)]
        res = self.client.remove_batch(keys)
        self.client.drain()
        for k, ok in zip(keys, res.results(wait=False)):
            if k not in self._allocated:
                continue        # never allocated — nothing to recycle
            if not ok:
                raise RuntimeError(
                    f"free_seq: remove of page key {k} (seq={seq_id}) "
                    f"failed — the key is still live in the page table; "
                    f"recycling its slot would alias another sequence's "
                    f"KV")
            slot = self._allocated.pop(k)
            self._table.pop(k, None)
            self.free_slots.append(slot)

    # -------------------------------------------------------------- lookups
    def refresh_table(self) -> None:
        """Re-snapshot key->slot by walking every owned chain: the slow
        fallback and the benchmark baseline of ``refresh_seqs``."""
        table: Dict[int, int] = {}
        for s in range(self.backend.n):
            for e in self.backend.sublists(s):
                if e["owner"] != s:
                    continue
                for k, _idx, val in self.backend.shard_chain(
                        s, e["head_idx"], include_meta=True):
                    table[k] = val
        self._table = table

    def refresh_seq(self, seq_id: int) -> int:
        """Refresh one sequence's snapshot rows with a single RANGE scan
        over its key interval. Returns the number of live mappings found."""
        return self.refresh_seqs([seq_id])

    def refresh_seqs(self, seq_ids: List[int]) -> int:
        """Refresh several sequences' snapshot rows: the spans are
        disjoint, so every scan is admitted in the same batch and one
        drain resolves them all. Returns the number of mappings found."""
        futs = []
        for sid in seq_ids:
            lo = page_key(sid, 0)
            hi = page_key(sid + 1, 0)
            futs.append((lo, hi, self.client.range(lo, hi,
                                                   limit=1 << PAGE_BITS)))
        self.client.drain()
        n = 0
        for lo, hi, fut in futs:
            items = fut.items(wait=False)
            for k in [k for k in self._table if lo <= k < hi]:
                del self._table[k]
            for k, slot in items:
                self._table[k] = slot
            n += len(items)
        return n

    def page_table(self, seq_ids: List[int], pages_per_seq) -> np.ndarray:
        """Dense int32 [B, PP] slot snapshot for the decode step, on the
        host (``paged_decode_step`` computes its write mask from it before
        uploading it).

        ``pages_per_seq`` is one int or a per-sequence list; rows are
        padded to the max with ``-1``. A page inside a sequence's declared
        count that is missing from the snapshot yields ``-1`` (stale
        snapshot during a re-partition — the decode step masks it) when it
        was ever allocated, and raises when it never was: slot 0 is a real
        page, and defaulting to it serves another sequence's KV.
        """
        if isinstance(pages_per_seq, int):
            pages_per_seq = [pages_per_seq] * len(seq_ids)
        if len(pages_per_seq) != len(seq_ids):
            raise ValueError(f"{len(pages_per_seq)} page counts vs "
                             f"{len(seq_ids)} seq ids")
        pp = max(pages_per_seq, default=0)
        out = np.full((len(seq_ids), pp), -1, np.int32)
        for b, (sid, n) in enumerate(zip(seq_ids, pages_per_seq)):
            for p in range(n):
                key = page_key(sid, p)
                slot = self._table.get(key)
                if slot is None:
                    if key not in self._allocated:
                        raise KeyError(
                            f"page_table: seq {sid} page {p} was never "
                            f"allocated — refusing to alias slot 0")
                    slot = -1       # allocated, snapshot stale: masked
                out[b, p] = slot
        return out

    # ------------------------------------------------------------ KV writes
    @torch.no_grad()
    def write_prefill(self, layer_caches, seq_ids: List[int],
                      seq_lens: List[int]) -> None:
        """Copy contiguous prefill caches [L, B, S, KH, D] into pages."""
        ps = self.page_size
        kc, vc = layer_caches["k"], layer_caches["v"]
        for b, sid in enumerate(seq_ids):
            n_pages = (seq_lens[b] + ps - 1) // ps
            for p in range(n_pages):
                slot = self._table[page_key(sid, p)]
                k_blk = kc[:, b, p * ps:(p + 1) * ps]
                v_blk = vc[:, b, p * ps:(p + 1) * ps]
                self.k_pages[:, slot, :k_blk.shape[1]] = k_blk.to(self.dtype)
                self.v_pages[:, slot, :v_blk.shape[1]] = v_blk.to(self.dtype)


@torch.no_grad()
def paged_decode_step(params: T.LM, cfg: ArchConfig, tokens, k_pages,
                      v_pages, page_table, seq_lens, *, page_size: int,
                      use_kernel: bool = True):
    """One decode step for dense-family models over paged KV.

    ``tokens`` [B, 1] on the model's device; ``page_table`` int32 [B, PP]
    and ``seq_lens`` int32 [B] (tokens already in cache) on the host, as
    numpy arrays or CPU tensors. The new token's K/V is written into its
    page of ``k_pages``/``v_pages`` ([L, P, S, KH, D]) in place; rows whose
    page is the ``-1`` sentinel are skipped. Returns (logits [B, V],
    k_pages, v_pages). ``use_kernel`` attends through the
    ``paged_attention`` kernel; otherwise through a gather and
    ``decode_attention`` with sentinel pages zeroed.
    """
    pt = np.asarray(page_table, np.int32)
    sl = np.asarray(seq_lens, np.int32)
    dev = params.embed.device
    b, pp = pt.shape
    # which rows write their new KV, and where — on the host, before the
    # upload; a -1 slot must never clamp onto page 0. A position past the
    # table reads its last column, as the reference's clamped gather.
    col = np.minimum(sl // page_size, max(pp - 1, 0))
    slot = pt[np.arange(b), col] if pp else np.full((b,), -1, np.int32)
    rows = np.nonzero(slot >= 0)[0]
    host = np.concatenate([np.maximum(pt, 0).reshape(-1), sl,
                           (pt >= 0).reshape(-1).astype(np.int32), rows,
                           slot[rows], (sl % page_size)[rows]]).astype(
                               np.int32)
    dv = torch.from_numpy(host).to(dev, non_blocking=True)
    n = b * pp
    pt_dev = dv[:n].reshape(b, pp)
    sl_dev = dv[n:n + b]
    live = dv[n + b:2 * n + b].reshape(b, pp).bool()
    nr = rows.shape[0]
    w_rows, w_slot, w_off = (dv[2 * n + b + i * nr:2 * n + b + (i + 1) * nr]
                             .long() for i in range(3))

    h = params.embed[tokens]
    positions = sl_dev[:, None]
    lens1 = sl_dev + 1
    hd, nh, kh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    for i, blk in enumerate(params.blocks):
        x = rms_norm(h, blk.ln1, cfg.norm_eps)
        q, k, v = qkv_proj(blk.attn, x, cfg, positions)
        kp, vp = k_pages[i], v_pages[i]
        kp[w_slot, w_off] = k[w_rows, 0].to(kp.dtype)
        vp[w_slot, w_off] = v[w_rows, 0].to(vp.dtype)
        if use_kernel:
            attn = K.paged_attention(q[:, 0].contiguous(), kp, vp, pt_dev,
                                     lens1, page_size=page_size)[:, None]
        else:
            # gather clamps -1 -> 0: zero sentinel pages instead of
            # serving page 0's (another sequence's) KV
            m = live[:, :, None, None, None]
            kc = torch.where(m, kp[pt_dev.long()], 0).reshape(b, -1, kh, hd)
            vc = torch.where(m, vp[pt_dev.long()], 0).reshape(b, -1, kh, hd)
            attn = decode_attention(q, kc, vc, lens1)
        h = h + attn.reshape(b, 1, nh * hd) @ blk.attn.wo
        h = h + blk.mlp(rms_norm(h, blk.ln2, cfg.norm_eps))
    h = rms_norm(h[:, -1:], params.final_norm, cfg.norm_eps)
    logits = (h @ params.head(cfg))[:, 0]
    return logits, k_pages, v_pages
