"""BENCHMARK.json keeps the shape its readers expect: the keys, names,
units, sources and bounds the benchmark's format allows."""

from __future__ import annotations

import json
import re

from benchmark.spec import REPO_DIR, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_names_and_bounds():
    text = (REPO_DIR / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    b = json.loads(text)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
    for m in b["per_layer"]:
        assert m["source"] in SOURCES and "bound" not in m
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    spec = Spec()
    ends = {m["name"]: m for m in spec.bench["end_to_end"]}
    for w in spec.bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics_for(w["name"], True)
        assert layers
        for m in layers:
            assert w["name"] in ends[m["moves"]].get("workloads",
                                                   [w["name"]])
