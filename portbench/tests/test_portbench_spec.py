"""The benchmark finds its cells, configurations, traffic mixes, loops and
metric readers by name, from data; BENCHMARK.json keeps to its contract."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from portbench import harness, spec
from portbench.tests.conftest import make_tree

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_json_keys_names_and_units():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in cells and ("workloads" not in moved or cell in moved["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_from_data(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    kind = c.kind()
    for fn in ("setup", "window", "check"):
        assert callable(getattr(kind, fn))
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    for name in c.limits:
        assert c.limits[name] > 0


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_preset_as_run(config):
    """Each configuration file's model fields are the port's preset's (no
    width or depth cut: `reduced` is empty)."""
    from deepsee_torch.config import get_preset

    data = json.loads((spec.REPO / config["file"]).read_text())
    assert config["reduced"] == data["reduced"] == []
    preset = dataclasses.asdict(get_preset(data["preset"]).model)
    assert {k: preset[k] for k in data["model"]} == data["model"]
    exp = harness.experiment(data, train=False)
    assert dataclasses.asdict(exp.model) == preset


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tmp_path):
    """A later change adds a cell (a BENCHMARK.json entry, a traffic mix and
    limits) and a per-layer metric (a reader file and an entry): the harness
    runs and reports them with no code edited."""
    bench_path = make_tree(tmp_path)
    root = tmp_path / "portbench"
    (root / "traffic" / "tiny_infer_b2.json").write_text(json.dumps(
        {"kind": "batch_infer", "batch": 2, "in_flight": 2, "pool": 2, "warmup": 1,
         "check_batches": 1}))
    (root / "limits" / "tiny.extra.json").write_text(json.dumps({"worst_mse": 1e-9}))
    (root / "metrics" / "batches.extra.py").write_text(
        "def read(record):\n    return float(record.units)\n")
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "tiny.extra", "config": "tiny", "traffic": "tiny_infer_b2",
                               "chips": 1, "why": "added as data"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny.infer" in m["workloads"]:
            m["workloads"].append("tiny.extra")
    bench["per_layer"].append({"name": "batches.extra", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "infer_img_per_s",
                               "workloads": ["tiny.extra"]})
    bench_path.write_text(json.dumps(bench))
    cell = spec.load_cell("tiny.extra", bench_path, root)
    assert cell.traffic["batch"] == 2 and [m["name"] for m in cell.per_layer] == ["batches.extra"]
    traced = harness.run(cell, 2 ** 31 + 5, 0.5, True, "cpu", log=lambda m: None)
    assert traced.correct
    assert traced.metrics["batches.extra"]["value"] == traced.attempted
    plain = harness.run(cell, 2 ** 31 + 5, 0.5, False, "cpu", log=lambda m: None)
    assert set(plain.metrics) == {"infer_img_per_s", "infer_p95_ms", "setup_s"}


def test_unknown_names_are_refused(tiny):
    bench, root = tiny
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", bench, root)
    with pytest.raises(FileNotFoundError):
        spec.load_module(root / "metrics" / "no_such_metric.py")
