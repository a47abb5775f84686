"""The plain reference that decides ``correct``: a sorted set, and a check
that a run's answers are ones a sorted set could have given.

DiLi promises linearizable FIND / INSERT / REMOVE: each op takes effect at
one instant between its submission and its answer, and the answers are
those of a plain sorted set applying the ops in that order. A run's clock
is its rounds: an op submitted before round ``a`` and answered by round
``b`` may take effect anywhere in rounds ``a..b``, and ops that take
effect in one round may do so in any order. Ops of different keys never
constrain one another, so the check runs key by key on one bit, "present".

Per key the check first tries the order in which every op takes effect in
the round that answered it; that is the order a correct program shows. If
it fails, an exact search over every placement in ``a..b`` decides (see
``_search``). The final key sets, read from every server after the drain,
must be the ones that order leaves, each key held by one server.

This module imports numpy only: nothing of the program, so that what the
program gets wrong cannot be repeated here.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .ycsb import OP_FIND, OP_INSERT, OP_REMOVE

# an op's effect on the bit, from its kind and answer
WRITE_IN, WRITE_OUT, NEEDS_IN, NEEDS_OUT = 0, 1, 2, 3
_INF = 1 << 62


class SortedSet:
    """Sorted-set semantics of find / insert / remove."""

    def __init__(self, keys: Iterable[int] = ()):
        self.keys = set(int(k) for k in keys)

    def apply(self, kind: int, key: int) -> int:
        if kind == OP_FIND:
            return int(key in self.keys)
        if kind == OP_INSERT:
            if key in self.keys:
                return 0
            self.keys.add(key)
            return 1
        if kind == OP_REMOVE:
            if key not in self.keys:
                return 0
            self.keys.remove(key)
            return 1
        raise ValueError(f"unknown op kind {kind}")

    def sorted(self) -> List[int]:
        return sorted(self.keys)


def effect(kind: np.ndarray, res: np.ndarray) -> np.ndarray:
    """Each answered op as what it did to, or needed of, its key's bit: a
    successful INSERT / REMOVE flips it; a FIND, or an INSERT / REMOVE
    that did nothing, needs it to be as the answer says."""
    out = np.full(kind.shape, -1, np.int64)
    out[(kind == OP_INSERT) & (res == 1)] = WRITE_IN
    out[(kind == OP_REMOVE) & (res == 1)] = WRITE_OUT
    out[((kind == OP_FIND) & (res == 1))
        | ((kind == OP_INSERT) & (res == 0))] = NEEDS_IN
    out[((kind == OP_FIND) & (res == 0))
        | ((kind == OP_REMOVE) & (res == 0))] = NEEDS_OUT
    return out


def _round_ok(s: int, n: np.ndarray) -> Optional[int]:
    """One round's ops on a key that starts the round at ``s``, in any
    order: the bit at the round's end, or None if no order gives these
    answers. ``n`` counts the ops by effect. Flips alternate from ``s``;
    a value is seen in the round if the round starts at it or flips."""
    w_in, w_out, need_in, need_out = (int(x) for x in n)
    d = w_in - w_out
    if d not in ((0, 1) if s == 0 else (0, -1)):
        return None
    flips = w_in + w_out
    if need_in and not (s == 1 or flips):
        return None
    if need_out and not (s == 0 or flips):
        return None
    return s ^ (flips & 1)


def _search(ops, final: int, cap: int) -> Optional[bool]:
    """Exact decision for one key: can each op ``(a, b, effect)`` be placed
    in a round of ``a..b`` so that every round passes ``_round_ok`` and
    the last bit is ``final``? Rounds where nothing starts or ends change
    nothing, so only those where something does are visited. Of waiting
    writes of one kind, taking those due first is never worse, so a
    configuration is the bit, the due rounds of the writes still to place,
    and the earliest due round of a waiting read of each value. Returns
    None past ``cap`` configurations."""
    rounds = sorted({a for a, _, _ in ops} | {b for _, b, _ in ops})
    starts = defaultdict(list)
    for a, b, e in ops:
        starts[a].append((b, e))
    configs = {(0, (), (), _INF, _INF)}
    for r in rounds:
        nxt = set()
        for s, p_in, p_out, r_in, r_out in configs:
            p_in, p_out = list(p_in), list(p_out)
            for b, e in starts.get(r, ()):
                if e == WRITE_IN:
                    p_in.append(b)
                elif e == WRITE_OUT:
                    p_out.append(b)
                elif e == NEEDS_IN:
                    r_in = min(r_in, b)
                else:
                    r_out = min(r_out, b)
            p_in.sort()
            p_out.sort()
            due_in = sum(1 for b in p_in if b == r)
            due_out = sum(1 for b in p_out if b == r)
            for k_in in range(due_in, len(p_in) + 1):
                for k_out in ((k_in, k_in - 1) if s == 0
                              else (k_in, k_in + 1)):
                    if not due_out <= k_out <= len(p_out):
                        continue
                    flips = k_in + k_out
                    w_in = _INF if (s == 1 or flips) else r_in
                    w_out = _INF if (s == 0 or flips) else r_out
                    if w_in == r or w_out == r:
                        continue
                    nxt.add((s ^ (flips & 1), tuple(p_in[k_in:]),
                             tuple(p_out[k_out:]), w_in, w_out))
        configs = nxt
        if not configs:
            return False
        if len(configs) > cap:
            return None
    return any(s == final and not p_in and not p_out
               for s, p_in, p_out, _, _ in configs)


def check(kind, key, submitted, answered, res,
          final_sets: Sequence[Iterable[int]], cap: int = 50_000) -> Dict:
    """Holds a run's history against the sorted set.

    ``kind``, ``key``: each op; ``submitted``: the round it was fed to;
    ``answered``: the round that answered it, -1 if none did; ``res``: its
    answer. ``final_sets``: each server's keys after the drain. Returns
    the numbers compared (each must be 0) and the final keys the
    reference's order leaves."""
    kind = np.asarray(kind, np.int64)
    key = np.asarray(key, np.int64)
    a = np.asarray(submitted, np.int64)
    b = np.asarray(answered, np.int64)
    res = np.asarray(res, np.int64)
    done = b >= 0
    eff = effect(kind, res)
    wrong_form = done & (eff < 0)
    # keys with an op that never came back or came back malformed are
    # counted there; their other ops cannot be placed without it
    spoilt = set(key[~done | wrong_form].tolist())

    owners = defaultdict(int)
    for keys in final_sets:
        for k in keys:
            owners[int(k)] += 1
    held = set(owners)
    twice = sum(1 for c in owners.values() if c > 1)

    ok = done & ~wrong_form & ~np.isin(key, list(spoilt))
    order = np.lexsort((b[ok], key[ok]))
    k_s, b_s, a_s, e_s = key[ok][order], b[ok][order], a[ok][order], \
        eff[ok][order]
    bad_keys: List[int] = []
    undecided = 0
    ref = SortedSet()
    cuts = np.flatnonzero(np.diff(k_s)) + 1
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, k_s.size]):
        if lo == hi:
            continue
        k = int(k_s[lo])
        final = int(k in held)
        s = 0
        rb = b_s[lo:hi]
        rcuts = np.flatnonzero(np.diff(rb)) + 1
        for rlo, rhi in zip(np.r_[0, rcuts], np.r_[rcuts, rb.size]):
            n = np.bincount(e_s[lo:hi][rlo:rhi], minlength=4)
            s = _round_ok(s, n)
            if s is None:
                break
        if s == final:
            if s:
                ref.keys.add(k)
            continue
        verdict = _search(list(zip(a_s[lo:hi].tolist(), rb.tolist(),
                                   e_s[lo:hi].tolist())), final, cap)
        if verdict:
            if final:
                ref.keys.add(k)
            continue
        bad_keys.append(k)
        undecided += verdict is None
    touched = set(key.tolist())
    stray = twice + sum(1 for k in held if k not in touched)
    return dict(unanswered=int((~done).sum()),
                error_answers=int(wrong_form.sum()),
                nonlinear_keys=len(bad_keys), stray_keys=stray,
                undecided_keys=undecided, bad_keys=bad_keys,
                reference_keys=len(ref.keys))
