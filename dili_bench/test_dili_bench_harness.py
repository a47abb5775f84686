"""CPU tests of the benchmark harness (and one ``gpu`` test).

Run from the repository root:

    PYTHONPATH=src python -m pytest dili_bench -q

The runs here use the cells' own files with the capacities cut to a size
the CPU holds (``tiny``), and a window counted in rounds.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from dili_bench import control, drive, reference, spec, traffic
from dili_bench import run as harness
from dili_bench.ycsb import OP_FIND, OP_INSERT, OP_REMOVE

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# (configuration, mix) pairs the harness runs here: every cell's, and the
# two that wait under PERF.md's Open questions, which the harness still
# drives: the four-server configuration (the program's Move fault; its
# delegation and exchange) and the read-only mix (its spread)
RUNS = sorted({(w["config"], w["traffic"]) for w in BENCH["workloads"]}
              | {("dili_4srv", "ycsb_a"), ("dili_1srv", "ycsb_c")})


def load_mix(name: str) -> dict:
    path = spec.HERE / "traffic" / f"{name}.json"
    return traffic.complete_mix(spec.load_json(path), str(path))
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(run):
    """A ``(configuration, mix)`` pair at a size the CPU runs in seconds:
    small pools, 32 clients per server, 300 keys of 1,200."""
    config, mix = run
    conf = spec.load_json(spec.HERE / "configs" / f"{config}.json")
    mix = load_mix(mix)
    n = conf["servers"]
    conf["dili"].update(pool_capacity=1 << 13, max_sublists=128,
                        max_ctrs=128, max_scan=1 << 13, batch_size=32,
                        mailbox_cap=256)
    conf.update(keys=300, key_space=1200, load_feed=32)
    return conf, dict(mix, clients=32 * n, warm_rounds=2)


def run_tiny(run, seed: int = 5, rounds: int = 12, wrap=None,
             make=drive.program_backend, trace=False, seconds=0.0):
    conf, mix = tiny(run)
    rec = drive.run(conf, mix, seed, seconds, trace,
                    ["cpu"] * conf["servers"], time.perf_counter(),
                    make=make, wrap=wrap,
                    window_rounds=None if trace else rounds,
                    profile_window=_cpu_profile if trace else None)
    return rec, harness.judge(rec)


def _cpu_profile(round_fn, seconds):
    from dili_bench import profiling
    return profiling.profile_window(round_fn, seconds, devices=["cpu"])


# ------------------------------------------------------------ the files

def test_every_cell_finds_its_files_by_name():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert entry["name"] not in names, entry["name"]
            names.add(entry["name"])
    for c in BENCH["configs"]:
        conf = spec.load_json(spec.ROOT / c["file"])
        assert all(k in conf for k in spec.CONFIG_KEYS), c["file"]
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
        assert set(conf["reduced"]) <= set(conf["source_values"])
    for cell in CELLS:
        entry, conf, mix = spec.cell(BENCH, cell)
        assert entry["config"] + "." + entry["traffic"] == cell
        assert mix["clients"] // conf["servers"] <= \
            conf["dili"]["batch_size"]
        for trace in (False, True):
            assert spec.metrics_of(BENCH, cell, trace), (cell, trace)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


# ------------------------------------------------- the loop and reference

@pytest.mark.parametrize("run", RUNS, ids=[".".join(r) for r in RUNS])
def test_loop_agrees_with_reference(run):
    rec, (correct, attempted, failed, cmp, verdict) = run_tiny(run)
    assert correct, cmp
    assert failed == 0 and attempted >= rec["window_ops"] > 0
    assert verdict["undecided_keys"] == 0
    # every op of the mix came back in the window's rounds or the drain
    assert (rec["history"]["answered"] >= 0).all()


def test_reference_flags_a_corrupted_answer():
    rec, (correct, *_rest) = run_tiny(RUNS[0])
    assert correct
    h = rec["history"]
    # flip the last successful write of a key the window wrote: the
    # number of flips changes parity, so no order ends at the final set
    ok = (h["res"] == 1) & np.isin(h["kind"], (OP_INSERT, OP_REMOVE)) \
        & (h["answered"] >= h["answered"].max() - rec["window_rounds"])
    i = int(np.flatnonzero(ok)[-1])
    h["res"][i] = 0
    correct, _, failed, cmp, verdict = harness.judge(rec)
    assert not correct and cmp["nonlinear_keys"][0] >= 1 and failed >= 1
    assert h["key"][i] in verdict["bad_keys"]


def _brute(ops, final):
    """Some order of ``ops`` (a, b, kind, res), each before every op that
    starts after it is answered, gives these answers and ends at
    ``final``."""
    for perm in itertools.permutations(range(len(ops))):
        pos = {j: p for p, j in enumerate(perm)}
        if any(ops[x][1] < ops[y][0] and pos[x] > pos[y]
               for x in range(len(ops)) for y in range(len(ops))):
            continue
        s = reference.SortedSet()
        if all(s.apply(ops[j][2], 9) == ops[j][3] for j in perm) \
                and int(9 in s.keys) == final:
            return True
    return False


def test_reference_matches_brute_force_on_small_histories():
    rng = np.random.default_rng(0)
    seen = {True: 0, False: 0}
    for _ in range(400):
        n = int(rng.integers(1, 6))
        a = rng.integers(0, 4, n)
        b = a + rng.integers(0, 3, n)
        kind = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], n)
        res = rng.integers(0, 2, n)
        final = int(rng.integers(0, 2))
        ops = list(zip(a.tolist(), b.tolist(), kind.tolist(), res.tolist()))
        want = _brute(ops, final)
        got = reference.check(kind, [9] * n, a, b, res,
                              [[9]] if final else [[]])
        assert (got["nonlinear_keys"] == 0) == want, (ops, final)
        seen[want] += 1
    assert min(seen.values()) > 50, seen


def test_reference_counts_keys_held_twice_or_never_written():
    k = [OP_INSERT]
    got = reference.check(k, [5], [0], [0], [1], [[5], [5, 7]])
    assert got["stray_keys"] == 2 and got["nonlinear_keys"] == 0


# ------------------------------------------------------- the result line

def test_result_line_has_the_contract_keys_then_compared():
    rec, (correct, attempted, failed, cmp, _) = run_tiny(RUNS[0])
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 1}
    out = harness.result(BENCH, CELLS[0], False, rec, device, correct,
                         attempted, failed, cmp)
    assert list(out) == CONTRACT_KEYS + ["compared"]
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.metrics_of(BENCH, CELLS[0], False)}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert all(v == {"value": 0, "limit": 0}
               for v in out["compared"].values())
    json.dumps(out)


def test_traced_result_reads_the_span_metrics():
    rec, (correct, attempted, failed, cmp, _) = run_tiny(
        RUNS[0], trace=True, seconds=2.0)
    assert correct, cmp
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 1}
    out = harness.result(BENCH, CELLS[0], True, rec, device, correct,
                         attempted, failed, cmp)
    assert list(out) == CONTRACT_KEYS + ["breakdown", "compared"]
    for name in ("route_ms", "refresh_ms", "prepass_ms", "serial_ms",
                 "bg_ms", "blk_hit_pct"):
        assert out["metrics"][name]["value"] > 0, name
    # no card: nothing ran on a device, so the device's readers are silent
    # or idle, and never a roofline share of 0
    assert "hybrid_search_roofline" not in out["metrics"]
    assert rec["profile"]["hs_calls"] > 0


def test_mix_files_state_only_what_they_change():
    mix = traffic.complete_mix({"read_share": 1.0, "theta": 0.99}, "c")
    assert mix == dict(traffic.DEFAULTS, read_share=1.0, theta=0.99)
    assert traffic.complete_mix(
        {"read_share": 0.5, "theta": 0.0, "clients": 64}, "a")["clients"] \
        == 64
    for bad in ({"theta": 0.99}, {"read_share": 1.5, "theta": 0.5},
                {"read_share": 0.5, "theta": 0.5, "clients": 0}):
        with pytest.raises(ValueError):
            traffic.complete_mix(bad, "bad")


@pytest.mark.parametrize("visible,core", [(None, 7), ("0", 7), ("1,2", 6),
                                          ("3", 4), ("GPU-5a1b", 7),
                                          ("9", 6)])
def test_runs_on_different_cards_keep_to_different_cores(visible, core):
    env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    assert harness.pick_core({0, 1, 2, 3, 4, 5, 6, 7}, env) == core
    assert harness.pick_core({12}, env) == 12


class _Event:
    """A profiler event as ``profiling.read_events`` reads it."""

    def __init__(self, name, start, end, cuda=False, note=False, cid=0,
                 card=0):
        self._v = name, start, end, cuda, note, cid, card

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "cuda" if self._v[3] else "cpu"

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def device_index(self):
        return self._v[6]


def test_profile_leaves_the_benchmarks_own_copies_out_of_busy_time():
    from dili_bench import profiling, roofline
    ev = [_Event("round_prepass", 0, 1000, note=True),
          _Event(roofline.RECORD_SPAN, 100, 200, note=True),
          _Event("cudaMemcpyAsync", 120, 130, cid=7),
          _Event("cudaMemcpyAsync", 150, 160, cid=8),
          _Event("cudaLaunchKernel", 300, 310, cid=9),
          _Event("Memcpy DtoD", 400, 410, cuda=True, cid=7),
          _Event("Memcpy DtoD", 420, 430, cuda=True, cid=8),
          _Event("hybrid_search_kernel(int*)", 500, 600, cuda=True, cid=9),
          _Event("round_prepass", 0, 1000, cuda=True, note=True)]
    out = profiling.read_events(ev, [0], "cuda")
    assert out["busy_s"] == pytest.approx(100e-9)
    assert out["bench_device_s"] == pytest.approx(20e-9)
    assert out["hs_kernel_events"] == 1
    assert [n for n, _ in out["device_ops"]] == ["hybrid_search_kernel(int*)"]


def test_loop_times_its_own_work_apart_from_the_programs():
    rec, (correct, _, _, cmp, _) = run_tiny(RUNS[0], rounds=8)
    assert correct, cmp
    host = rec["host_s"]
    assert set(host) == set(drive.Loop.HOST_PARTS)
    assert host["step"] > 0 and host["submit"] > 0 and host["feed"] > 0
    assert all(v >= 0 for v in host.values())


# ---------------------------------------------------- the process checks

def _env():
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_harness_run_loads_no_jax_module_by_whole_top_level_name():
    script = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from dili_bench import test_dili_bench_harness as t, run\n"
        "rec, verdict = t.run_tiny(t.RUNS[0], rounds=4)\n"
        "assert verdict[0]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n" % str(spec.ROOT))
    p = subprocess.run([sys.executable, "-c", script], env=_env(),
                       capture_output=True, text=True, timeout=600,
                       cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    top, found = p.stdout.strip().splitlines()[-2:]
    top = eval(top)
    assert "repro_torch" in top and "dili_bench" in top
    assert not {"jax", "jaxlib", "flax", "repro"} & set(top), top
    assert found == "[]"


def test_run_fails_without_a_card_or_the_program(tmp_path):
    cmd = [sys.executable, "dili_bench/run.py", "--workload", CELLS[0],
           "--seed", "3000000000", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=300, cwd=spec.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    # a checkout of the benchmark's files alone
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "dili_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


# --------------------------------------------------- control and faults

@pytest.mark.parametrize("run,mode", [(r, m) for r in RUNS
                                      for m in control.BREAKS],
                         ids=[".".join(r) + "-" + m for r in RUNS
                              for m in control.BREAKS])
def test_control_is_not_correct_at_the_cells_size(run, mode):
    config, mix = run
    conf = spec.load_json(spec.HERE / "configs" / f"{config}.json")
    mix = load_mix(mix)
    out = control.run(conf, mix, 11, mode, rounds=20)
    assert not out["correct"]
    assert out["compared"]["nonlinear_keys"] > 0


class _Wrap:
    """The program's backend with its timed path broken from round
    ``arm`` on (the window's first round in a clean run of the seed)."""

    def __init__(self, be, arm):
        self.be = be
        self.arm = arm
        self.rounds = 0

    def __getattr__(self, name):
        return getattr(self.be, name)

    @property
    def armed(self):
        return self.rounds >= self.arm

    def submit(self, s, kinds, keys, values=None):
        return self.be.submit(s, kinds, keys, values)

    def step(self):
        self.rounds += 1
        return self.be.step()


class StateUnchanged(_Wrap):
    def step(self):
        armed = self.armed
        be = self.be
        if hasattr(be, "cluster"):
            c = be.cluster
            keep = list(c.states), list(c.bgs)
            comps = super().step()
            if armed:
                c.states[:], c.bgs[:] = keep
            return comps
        keep = list(be._states), list(be._bgs)
        comps = super().step()
        if armed:
            be._states, be._bgs = keep
            be._host_states = None
        return comps


class HalfBatch(_Wrap):
    fake = -1

    def submit(self, s, kinds, keys, values=None):
        if not self.armed:
            return self.be.submit(s, kinds, keys, values)
        h = (len(kinds) + 1) // 2
        ids = self.be.submit(s, kinds[:h], keys[:h])
        for _ in range(len(kinds) - h):
            ids.append(HalfBatch.fake)
            HalfBatch.fake -= 1
        return ids


class NoExchange(_Wrap):
    def step(self):
        armed = self.armed
        comps = super().step()
        if armed:
            for box in self.be._inbox:
                box.zero_()
        return comps


class AnswerAltered(_Wrap):
    def step(self):
        armed = self.armed
        comps = super().step()
        if armed:
            comps = [(i, 1 - v if j % 7 == 0 else v, s)
                     for j, (i, v, s) in enumerate(comps)]
        return comps


def _can_have(run, fault) -> bool:
    """A read-only mix leaves the state as it found it, so a step that
    returns it unchanged is no fault there; one server exchanges
    nothing."""
    conf, mix = tiny(run)
    if fault is StateUnchanged:
        return mix["read_share"] < 1.0
    return fault is not NoExchange or conf["servers"] > 1


FAULTS = [(r, f) for r in RUNS
          for f in (StateUnchanged, HalfBatch, NoExchange, AnswerAltered)
          if _can_have(r, f)]


@pytest.mark.parametrize("run,fault", FAULTS,
                         ids=[".".join(r) + "-" + f.__name__
                              for r, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(run, fault, monkeypatch):
    monkeypatch.setattr(drive, "DRAIN_ROUNDS", 60)
    monkeypatch.setattr(drive, "SETTLE_PASSES", 3)
    clean, (ok, *_rest) = run_tiny(run, seed=21)
    assert ok
    arm = clean["load_rounds"] + clean["settle_rounds"] \
        + tiny(run)[1]["warm_rounds"]
    rec, (correct, attempted, failed, cmp, _) = run_tiny(
        run, seed=21, wrap=lambda be: fault(be, arm))
    assert not correct, cmp
    assert failed > 0


# ------------------------------------------------------------ on a card

@pytest.mark.gpu
def test_one_cell_runs_correct_on_a_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "dili_bench/run.py", "--workload", CELLS[1],
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        env=_env(), capture_output=True, text=True, timeout=360,
        cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["ops_per_s"]["value"] > 0
