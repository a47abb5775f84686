"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` reads ``configs/<config>.json`` (the deployment)
and ``traffic/<mix>.json`` (the mix); a per-layer metric ``<name>`` is
read by ``metrics/<name>.py``, whose ``read(record)`` returns a number, or
None where the run has nothing for it to read. A later PR adds a
configuration, a mix or a metric by adding files and entries here, never
by editing one.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CONFIG_KEYS = ("servers", "backend", "dili", "keys", "key_space",
               "load_feed")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, root: pathlib.Path = ROOT):
    """``(workload entry, configuration, mix)`` of the cell ``name``."""
    from .traffic import complete_mix
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; there are {sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = load_json(root / cfg_entry["file"])
    missing = [k for k in CONFIG_KEYS if k not in conf]
    if missing:
        raise ValueError(f"{cfg_entry['file']}: missing {missing}")
    mix_path = HERE / "traffic" / f"{w['traffic']}.json"
    mix = complete_mix(load_json(mix_path), str(mix_path))
    return w, conf, mix


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"dili_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
