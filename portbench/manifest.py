"""BENCHMARK.json and the files each of its names resolves to.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by its name:

    configs/<config>.json    the deployment: level, map, render config
    traffic/<mix>.json       the parameters the one generator reads
    metrics/<metric>.py      the reader of one per-layer metric

so a cell, a mix or a metric is added with new files and new entries in
BENCHMARK.json, and no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def config_path(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of per-layer metric `name` (metrics/<name>.py):
    SPANS, {span name: [(module, attribute), ...]} to wrap in a traced
    run (may be empty), optionally PROBES, {count name: [(module,
    attribute, probe), ...]} (tracing.Probes), and read(trace) -> float
    or None."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """Workload `name` of BENCHMARK.json with its configuration, traffic
    and the metrics it reports."""
    bench = bench if bench is not None else load()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=read_json(config_path(w["config"])),
        traffic=read_json(traffic_path(w["traffic"])),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
