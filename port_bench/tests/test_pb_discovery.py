"""The harness finds a configuration, a traffic mix, its arrival law and
entry, and a per-layer metric by the name BENCHMARK.json or the mix
gives, so a later change adds files and edits none; and BENCHMARK.json
itself keeps to its contract."""

import json
import os
import re

import pytest

from port_bench import harness, loadgen

ROOT = harness.REPO


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_new_files_are_found_by_name(tmp_path):
    cfg = harness.load_json(os.path.join(ROOT, "port_bench", "configs",
                                         "fastvlm-1.5b.json"))
    (tmp_path / "new-model.json").write_text(json.dumps(dict(cfg, x=1)))
    traffic = tmp_path / "traffic"
    traffic.mkdir()
    (traffic / "new-mix.json").write_text(json.dumps({"entry": {}}))
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "new.metric_ms.py").write_text(
        "def read(ctx):\n    return 41.5 if ctx else None\n")
    b = {"configs": [{"name": "new-model",
                      "file": str(tmp_path / "new-model.json")}],
         "workloads": [{"name": "new-model.new-mix", "config": "new-model",
                        "traffic": "new-mix", "chips": 1}]}
    cell, c, mix = harness.load_cell(b, "new-model.new-mix", str(traffic))
    assert c["x"] == 1 and mix == {"entry": {}}
    read = harness.metric_reader("new.metric_ms", str(metrics))
    assert read(object()) == 41.5 and read(None) is None
    with pytest.raises(KeyError):
        harness.load_cell(b, "absent", str(traffic))
    entries = tmp_path / "entries"
    entries.mkdir()
    (entries / "new-entry.py").write_text(
        "def build(engine, settings):\n    return (engine, settings)\n")
    build = loadgen.module("entries", "new-entry", str(tmp_path)).build
    assert build("e", {"k": 1}) == ("e", {"k": 1})


def test_every_law_and_entry_of_a_mix_has_its_file():
    for name in os.listdir(os.path.join(ROOT, "port_bench", "traffic")):
        mix = harness.load_json(os.path.join(ROOT, "port_bench", "traffic",
                                             name))
        assert callable(loadgen.module("arrivals",
                                       mix["arrivals"]["law"]).offer)
        assert callable(loadgen.module("entries", mix["entry"]["name"]).build)


def test_every_name_in_benchmark_json_has_its_file():
    b = bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        cell, cfg, mix = harness.load_cell(b, w["name"])
        assert cfg["name"] == w["config"]
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_benchmark_json_keeps_its_contract():
    b = bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert name.match(w["name"]) and name.match(w["traffic"])
        reported = [m["name"] for m in harness.cell_metrics(b, w,
                                                            "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w, "per_layer")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert name.match(m["name"])
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in [x["name"] for x in harness.cell_metrics(
                b, cells[cell], "end_to_end")]
    for m in b["per_layer"]:  # a kernel's roofline beside its step's mfu
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       for x in b["per_layer"])
