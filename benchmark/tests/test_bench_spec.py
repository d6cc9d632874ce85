"""BENCHMARK.json: its names and units keep to the allowed characters,
and every piece a cell names is found by that name."""

import copy

import pytest

from benchmark import spec


def test_benchmark_json_is_whole():
    s = spec.load()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in s["workloads"]:
        cfg = spec.config(s, c["config"])
        assert cfg["reduced"] == [x for x in s["configs"] if x["name"] == c["config"]][0]["reduced"]
        assert spec.traffic(c["traffic"])["kind"] in ("resident", "live")
        assert set(spec.limits(c["config"])) >= {"y_mae", "uv_mae", "far_share"}
        e2e_here = [m["name"] for m in spec.metrics_for(s, c["name"], "end_to_end")]
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        per_layer = spec.metrics_for(s, c["name"], "per_layer")
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e_here, (c["name"], m["name"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("group,field,value", [
    ("per_layer", "name", "bad name"),
    ("per_layer", "name", "a/b"),
    ("end_to_end", "unit", "tokens per second"),
    ("end_to_end", "unit", "µs"),
    ("workloads", "traffic", "live,16"),
    ("configs", "name", "x" * 65),
])
def test_bad_names_and_units_are_refused(group, field, value):
    s = copy.deepcopy(spec.load())
    s[group][0][field] = value
    with pytest.raises((ValueError, KeyError)):
        spec.check(s)


def test_duplicate_metric_names_are_refused():
    s = copy.deepcopy(spec.load())
    s["per_layer"].append(dict(s["end_to_end"][0]))
    with pytest.raises(ValueError, match="duplicate"):
        spec.check(s)
