"""`BENCHMARK.json` and the files it names, resolved by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is the one `configs` gives, the mix is
`traffic/<mix>.json`, and every metric is read by `metrics/<name>.py`.
Adding a cell, a mix or a metric adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, with its "name"
    traffic: dict         # traffic/<mix>.json, with its "name"
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _lists(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, root: str = ROOT,
            manifest: dict | None = None) -> Cell:
    """The cell `cell_name` with its configuration, traffic mix and the
    metrics it reports; raises KeyError for a name the manifest lacks and
    OSError for a file that is missing."""
    m = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell_name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = dict(json.load(f), name=conf["name"])
    with open(os.path.join(root, "wvbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = dict(json.load(f), name=w["traffic"])
    e2e = [x for x in m["end_to_end"] if _lists(x, cell_name)]
    moves = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if ("workloads" in x and cell_name in x["workloads"])
             or ("workloads" not in x and x["moves"] in moves)]
    return Cell(cell_name, int(w["chips"]), config, traffic, e2e, layer)


def reader(name: str, root: str = ROOT):
    """The `read(run)` function of `wvbench/metrics/<name>.py`."""
    path = os.path.join(root, "wvbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "wvbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
