"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""
import importlib
import json
import re

import pytest

import tiny  # noqa: F401  (puts the benchmark on sys.path)
import common

MAN = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expansion|experts_per)")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(MAN) == KEYS
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    files = [w for w in MAN["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in MAN["paths"]) for f in files)
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_allowed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        body = common.load_json(common.ROOT / c["file"])
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])


def test_workloads():
    assert 1 <= len(MAN["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_what_it_needs(cell):
    e2e = {m["name"] for m in common.end_to_end_metrics(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = common.per_layer_metrics(MAN, cell)
    assert layer
    for m in layer:  # each cell of a per-layer metric reports the metric it moves
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    w = common.find_cell(MAN, cell)
    config, traffic, cell_file = common.cell_files(MAN, w)
    assert config["text_width"] > 0 and config["image_side"] > 0
    importlib.import_module(f"drivers.{traffic['kind']}")
    assert cell_file["limits"]
    for m in common.per_layer_metrics(MAN, cell):
        assert hasattr(importlib.import_module(f"metrics.{m['name'].split('.')[0]}"), "read")


def test_shares_are_percent():
    for m in MAN["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
