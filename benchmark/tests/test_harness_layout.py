"""BENCHMARK.json against the contract: names, units, keys, cells found by
name, and every metric, configuration, traffic mix and limit file there."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    cells = 24
    assert ((2 + 14 * cells) * (bench["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_needs(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for cell in cells:
        assert any(cell in v for k, v in e2e.items() if k != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]


def test_found_by_name(bench):
    from benchmark import cell, traffic
    from benchmark.metrics import reader

    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(m["name"]))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = cell.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"]
        cell.port_config(cfg)
    for w in bench["workloads"]:
        got, conf = cell.find(bench, w["name"])
        assert got is w and conf["name"] == w["config"]
        mix = traffic.load(w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "benchmark",
                                           f"{mix['kind']}.py"))
        numbers = ({"logit_gap", "logit_rms"} if mix["kind"] == "serve"
                   else {"loss_gap", "grad_gap", "change_gap"})
        assert set(cell.load_limits(w["name"])) == numbers
    with pytest.raises(KeyError):
        cell.find(bench, "no_such.cell")


def test_paths_hold_only_the_benchmark(bench):
    for p in bench["paths"]:
        for dirpath, _, files in os.walk(os.path.join(ROOT, p)):
            rel = os.path.relpath(dirpath, ROOT)
            if "_cache" in rel or "__pycache__" in rel:
                continue
            for f in files:
                assert PATH.match(os.path.join(rel, f))
