"""``BENCHMARK.json`` against the rules it is held to, and every name in it
found as a file of its own."""

import json
import re

import pytest

from rtnr_bench.harness import cell_metrics, find, load_json
from rtnr_bench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return load_json(ROOT / "BENCHMARK.json")


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(manifest["command"]) <= 32
    assert all(LINE.match(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in manifest[group]}) == len(manifest[group])
    metrics = [n for is_metric, n in names if is_metric]
    assert len(set(metrics)) == len(metrics)
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "bound" not in m and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_layers_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        e2e = {m["name"] for m in cell_metrics(manifest, cell, trace=False)}
        layers = cell_metrics(manifest, cell, trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    layer_names = {}
    for m in manifest["per_layer"]:
        layer_names.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layer_names.values()), "one spelling per layer"


def test_every_name_has_its_file(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used, f"configuration {c['name']} has no cell"
        path = ROOT / c["file"]
        assert path == find(ROOT, "configs", c["name"], ".json") and path.is_file()
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in manifest["workloads"]:
        t = json.loads(find(ROOT, "traffic", w["traffic"], ".json").read_text())
        assert find(ROOT, "runners", t["runner"], ".py").is_file()
        assert find(ROOT, "traffic", t["generator"], ".py").is_file()
        cfg = json.loads(find(ROOT, "configs", w["config"], ".json").read_text())
        assert cfg["limits"], "every configuration states the limits of its checks"
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert find(ROOT, "metrics", m["name"], ".py").is_file(), m["name"]
