"""The benchmark's description, ``BENCHMARK.json`` at the root of the
checkout, and the files it names.

Every cell, configuration, traffic mix and per-layer metric is found by
its name: a configuration by the ``file`` of its entry, a traffic mix
at ``traffic/<name>.json``, a metric's reader at ``metrics/<name>.py``
and a configuration's correctness limits at ``limits/<config>.json``,
all under this folder.  A later cell, mix or metric is added by adding
files and entries; no file here changes.
"""

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path=None):
    """BENCHMARK.json as a dict, its names checked."""
    spec = json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())
    check(spec)
    return spec


def check(spec):
    """Raises ValueError on a name or unit outside the allowed
    characters, a duplicate name, or a cell whose pieces are missing."""
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            name = entry["name"]
            if not NAME.match(name):
                raise ValueError(f"{group}: bad name {name!r}")
            key = group if group in ("configs", "workloads") else "metrics"
            if (key, name) in seen:
                raise ValueError(f"{group}: duplicate name {name!r}")
            seen.add((key, name))
            if "unit" in entry and not UNIT.match(entry["unit"]):
                raise ValueError(f"{name}: bad unit {entry['unit']!r}")
    for entry in spec["configs"]:
        for key in entry["reduced"]:
            if not NAME.match(key):
                raise ValueError(f"{entry['name']}: bad reduced key {key!r}")
    configs = {c["name"] for c in spec["configs"]}
    for cell in spec["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(cell[key]):
                raise ValueError(f"{cell['name']}: bad {key} {cell[key]!r}")
        if cell["config"] not in configs:
            raise ValueError(f"{cell['name']}: unknown config {cell['config']!r}")


def cell(spec, name):
    for c in spec["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec, name):
    """The configuration file's contents, with ``path`` added."""
    for c in spec["configs"]:
        if c["name"] == name:
            path = ROOT / c["file"]
            return dict(json.loads(path.read_text()), path=str(path))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(config_name):
    return json.loads((HERE / "limits" / f"{config_name}.json").read_text())


def metrics_for(spec, cell_name, kind):
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): every
    entry whose ``workloads`` lists the cell, or that has no such key."""
    return [m for m in spec[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
