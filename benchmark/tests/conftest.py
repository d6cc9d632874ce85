"""Shared pieces of the benchmark's CPU tests: a small copy of the
mono360 rig (192^2 cameras, a 384x192 canvas) as a configuration file."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))



def small_config(tmp_path, name="small", cam=192, canvas=(384, 192)):
    c = copy.deepcopy(json.loads((ROOT / "benchmark" / "configs" / "mono360_4k.json").read_text()))
    c["name"] = name
    c["camera_size"] = [cam, cam]
    for i in c["rig"]["inputs"]:
        i["options"]["width"] = i["options"]["height"] = cam
    c["outputs"][0]["rect"] = [0, 0, *canvas]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(c))
    return dict(c, path=str(path))


@pytest.fixture
def small(tmp_path):
    return small_config(tmp_path)


@pytest.fixture
def bench_dir(tmp_path, monkeypatch):
    """A copy of the benchmark's traffic, metric and limit files in a
    temporary folder that ``benchmark.spec`` reads instead; the small
    configuration is held to the committed limits of ``mono360_4k``."""
    import shutil

    from benchmark import check, deploy, spec

    d = tmp_path / "bench"
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(ROOT / "benchmark" / sub, d / sub)
    shutil.copy(ROOT / "benchmark" / "limits" / "mono360_4k.json", d / "limits" / "small.json")
    monkeypatch.setattr(spec, "HERE", d)
    monkeypatch.setattr(deploy, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(check, "CACHE", tmp_path / "cache" / "reference")
    return d


@pytest.fixture
def cell_spec():
    return _cell_spec


def _cell_spec(config, traffic, metrics=()):
    """A BENCHMARK.json-shaped dict with one cell of ``config`` under
    ``traffic`` and every metric of the real one, plus ``metrics``."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(real)
    spec["configs"] = [{"name": config["name"], "source": "test", "file": config["path"], "reduced": [], "why": "test"}]
    spec["workloads"] = [{"name": "t", "config": config["name"], "traffic": traffic, "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    spec["per_layer"] += list(metrics)
    return spec
