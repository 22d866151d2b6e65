"""Every entry of BENCHMARK.json resolves by name to its files, and the
file keeps the contract's shape."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

import pytest

from pb_util import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_bounds():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m for m in b["end_to_end"] if m["name"] == "setup_s"]


@pytest.mark.parametrize("cfg", [c["name"] for c in bench()["configs"]])
def test_config_resolves(cfg):
    c = {e["name"]: e for e in bench()["configs"]}[cfg]
    assert c["file"].startswith("portbench/configs/")
    with open(os.path.join(ROOT, c["file"])) as f:
        data = json.load(f)
    assert data["name"] == cfg and c["reduced"] == []
    from portbench.reference.ynet import build
    build(data)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(cell):
    b = bench()
    w = {e["name"]: e for e in b["workloads"]}[cell]
    assert w["config"] in {c["name"] for c in b["configs"]}
    with open(os.path.join(ROOT, "portbench", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    drv = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    assert hasattr(drv, "Driver")
    with open(os.path.join(ROOT, "portbench", "limits",
                           f"{cell}.json")) as f:
        assert json.load(f)
    e2e = [m["name"] for m in b["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in b["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_reader_resolves(metric):
    path = os.path.join(ROOT, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_layers_named_alike():
    """Metrics of one layer give the same ``layer`` letter for letter."""
    layers = {m["layer"] for m in bench()["per_layer"]}
    assert all("\n" not in x and 0 < len(x) <= 200 for x in layers)


def test_span_files_resolve():
    """Every ``spans/<span>.json`` names functions the program has."""
    from portbench.harness import spans
    targets = spans.load()
    names = {t[2] for t in targets}
    assert {"plan", "engine", "stage", "k1", "loader"} <= names
    for owner, attr, _, kind, _ in targets:
        assert callable(getattr(owner, attr)) and kind in ("call", "iter")


def test_program_ranges_are_spans():
    """A ``record_function`` range the program opens is a span
    ``program:<name>`` while the spans are installed, and only then."""
    import torch

    from portbench.harness.spans import Spans
    s = Spans()
    with s.annotations():
        with torch.profiler.record_function("phase"):
            torch.ones(2).sum()
    with torch.profiler.record_function("phase"):
        pass
    assert s.count("program:phase") == 1 and s.total_s("program:phase") > 0
