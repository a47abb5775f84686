"""The nemesis corpus through the port, held to the reference's traces.

Each crash-free entry of ``tests/nemesis_corpus.json`` runs through the
reference's differential harness (``nemesis_harness.run_differential``,
local backend) and through the port's copy of it on the CPU
(``chip_smoke.nemesis_differential``: same config, seeds, client, balancer
and draws). Both must pass the harness's checks, and the port's
``round_trace`` must equal the reference's line for line — completions,
outbox counts and in-flight frames of every round — with equal final key
sets and equal transport and nemesis counters. The two crash entries are
in ``test_torch_durability.py``.
"""
import importlib.util
import json
import pathlib

import pytest

from nemesis_harness import check, run_differential

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS = json.loads((ROOT / "tests" / "nemesis_corpus.json").read_text())[
    "entries"]
CRASH_FREE = [e for e in CORPUS if not e["config"].get("crashes")]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")


def test_crash_free_entries_are_the_seven_named():
    assert [e["name"] for e in CRASH_FREE] == [
        "mixed-p02", "drop-heavy", "dup-storm", "reorder-storm",
        "partition-heal", "asym-lossy-link", "mixed-p015-range"]


@pytest.mark.parametrize("entry", CRASH_FREE,
                         ids=[e["name"] for e in CRASH_FREE])
def test_corpus_entry_replays_the_reference_trace(entry):
    from repro.core.net import NemesisConfig as RefConfig
    from repro_torch.core.net import NemesisConfig

    repro = f"corpus:{entry['name']} seed={entry['seed']}"
    scan_every = entry.get("scan_every", 0)
    ref = run_differential("local", entry["seed"],
                           RefConfig.from_dict(entry["config"]),
                           n_ops=entry["n_ops"], scan_every=scan_every)
    check(ref, repro)
    got = SMOKE.nemesis_differential(
        entry["seed"], NemesisConfig.from_dict(entry["config"]),
        n_ops=entry["n_ops"], scan_every=scan_every, device="cpu")
    check(got, repro)
    assert len(got["trace"]) == len(ref["trace"]) == got["rounds"]
    for i, (a, b) in enumerate(zip(ref["trace"], got["trace"])):
        assert a == b, f"{repro}: round {i} differs:\n ref  {a}\n port {b}"
    assert got["final_keys"] == ref["final_keys"]
    assert got["net_stats"] == ref["net_stats"]
    assert got["nemesis_stats"] == ref["nemesis_stats"]
    assert got["net_stats"]["sent"] > 0, "the wire was never exercised"
    if scan_every:
        assert got["n_scans"] == ref["n_scans"] > 0
