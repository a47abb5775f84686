"""Merge and the balancer's move and merge stages, the port against the
reference bit for bit on the CPU: the workloads of
``tests/test_merge_balancer.py`` (a merge after a split, a merge under
concurrent ops, the balancer end to end at 2 and 4 shards). Op results,
key sets, stats, round counts, sublists, per-round state digests and the
balancer's per-pass command counts agree, and the port passes the
reference test's own checks."""
import pytest

import torch_bg_workloads as W


@pytest.mark.parametrize("workload", [
    W.merge_after_split_roundtrip, W.merge_under_concurrent_ops,
], ids=["roundtrip", "concurrent_ops"])
def test_merge_workload_matches_reference(workload):
    ref, got = W.run(workload)
    W.assert_same(ref, got)


@pytest.mark.parametrize("nshards", [2, 4])
def test_balancer_end_to_end_matches_reference(nshards):
    ref, got = W.run(W.balancer_end_to_end, nshards)
    W.assert_same(ref, got)
    assert got["stats"]["move_hits"] > 0
