"""BENCHMARK.json: names, units and that every name resolves to its files."""

import json

import pytest

from portbench import manifest

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert manifest.NAME.fullmatch(n), n
    for m in METRICS:
        assert manifest.UNIT.fullmatch(m["unit"]), m
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)


def test_metric_workloads_name_cells():
    for m in METRICS:
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)


def test_every_configuration_has_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == used


def test_configuration_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = manifest.read_json(manifest.config_path(c["name"]))
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = manifest.cell(name, BENCH)
    assert cell.config["level"] and cell.traffic["kind"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        mod = manifest.load_metric(m["name"])
        assert callable(mod.read) and isinstance(mod.SPANS, dict)
        assert m["moves"] in e2e


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m


def test_size():
    assert len(json.dumps(BENCH)) < 64 * 1024
