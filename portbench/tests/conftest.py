"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary folder, with tiny configurations and cells added as data
(the configuration of deepsee_torch's tiny_test_experiment, float32)."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

from portbench import spec

TINY_WORKLOADS = ("tiny.infer", "tiny.int8", "tiny.guided")
TINY_TRAIN = ("tiny.train", "tiny.guided.train")


def _tiny_model(**changes) -> dict:
    from deepsee_torch.config import tiny_test_experiment

    m = dataclasses.asdict(tiny_test_experiment().model)
    keys = json.loads((spec.HERE / "configs" / "8x_independent_256x256.json").read_text())["model"]
    return dict({k: m[k] for k in keys}, **changes)


def make_tree(tmp: Path) -> Path:
    """A copy of portbench/ under tmp with the tiny cells; returns the path
    of its BENCHMARK.json (beside the copy)."""
    root = tmp / "portbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    base = {"source": "https://github.com/mcbuehler/DeepSEE", "preset": "tiny_test",
            "reduced": [], "assumed": {}}
    configs = {
        "tiny": dict(base, model=_tiny_model(), int8=None),
        "tiny.int8": dict(base, model=_tiny_model(), int8={"min_ch": 16, "smooth": True}),
        "tiny.guided": dict(base, model=_tiny_model(net_e="fullstyle", guiding_style_image=True,
                                                    noisy_style_scale=0.05), int8=None),
    }
    for name, c in configs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    (root / "traffic" / "tiny_infer.json").write_text(json.dumps(
        {"kind": "batch_infer", "batch": 3, "in_flight": 2, "pool": 3, "warmup": 2,
         "check_batches": 2}))
    (root / "traffic" / "tiny_train.json").write_text(json.dumps(
        {"kind": "train_steps", "batch": 3, "pool": 4, "check_steps": 3}))
    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    for name in configs:
        bench["configs"].append({"name": name, "source": base["source"],
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "tiny CPU test"})
    for cell, config in zip(TINY_WORKLOADS, configs):
        bench["workloads"].append({"name": cell, "config": config, "traffic": "tiny_infer",
                                   "chips": 1, "why": "tiny CPU test"})
        # float32 on both sides: rounding alone, except where int8 levels flip
        limit = 1e-3 if config == "tiny.int8" else 1e-9
        (root / "limits" / f"{cell}.json").write_text(json.dumps({"worst_mse": limit}))
    for cell, config in zip(TINY_TRAIN, ("tiny", "tiny.guided")):
        bench["workloads"].append({"name": cell, "config": config, "traffic": "tiny_train",
                                   "chips": 1, "why": "tiny CPU test"})
        (root / "limits" / f"{cell}.json").write_text(json.dumps(
            {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 5e-2, "fake_mse": 1e-8}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "infer.8x_indep_256.b32" in m["workloads"]:
            m["workloads"] += list(TINY_WORKLOADS)
        if "workloads" in m and "train.32x_guided_512.b8" in m["workloads"]:
            m["workloads"] += list(TINY_TRAIN)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny(tmp_path):
    """(BENCHMARK.json path, portbench root) of a tiny tree."""
    bench = make_tree(tmp_path)
    return bench, tmp_path / "portbench"


@pytest.fixture
def card():
    """Skips unless a CUDA card is here (decided inside the test, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")
