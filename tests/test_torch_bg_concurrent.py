"""The slotted background engine, the port against the reference bit for
bit on the CPU: the workloads of ``tests/test_bg_concurrent.py`` — a
Split, a Move and a Merge in flight on one shard at once (quiet, with
channel delays, with the batched replay off), entry claims, a full slot
table, a MoveSH nack, and a stale delegation through a quarantined chain
while a second batched copy runs. Op results, key sets, stats, round
counts, sublists and per-round state digests agree, and the port passes
the reference test's own checks."""
import pytest

import torch_bg_workloads as W


@pytest.mark.parametrize("delay,move_fastpath", [
    (0.0, True), (0.3, True), (0.3, False)])
def test_concurrent_split_move_merge_matches_reference(delay, move_fastpath):
    ref, got = W.run(W.concurrent_split_move_merge, delay, move_fastpath)
    W.assert_same(ref, got)


@pytest.mark.parametrize("workload", [
    W.entry_claims_are_exclusive, W.no_free_slot_drops_command,
    W.move_nack_frees_slot_and_claim, W.stale_delegation_through_quarantine,
], ids=["claims", "no_free_slot", "nack", "stale_delegation"])
def test_slot_workload_matches_reference(workload):
    ref, got = W.run(workload)
    W.assert_same(ref, got)
