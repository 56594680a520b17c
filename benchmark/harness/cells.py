"""Finding a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic; each lives in a file
of its own, found by that name:

- ``benchmark/configs/<config>.json``: the recipe, its overrides, the model's sizes
  as the reference reads them, the datasets' image sizes and box statistics; and,
  for an architecture other than the VGG16 detector, ``"reference"``, the name of a
  module under ``benchmark/reference/`` that gives the reference's detector and
  steps (``runner.REFERENCE_NAMES``), and ``"counts"``, the name of a module under
  ``benchmark/harness/`` that gives ``iteration_flops`` and ``kernel_launches`` as
  ``harness/counts.py`` does. Without them the configuration runs the VGG16
  reference of ``reference/vgg16.py`` and the counts of ``harness/counts.py``;
- ``benchmark/traffic/<traffic>.json``: the phase, the stored scale and format of
  the images, the tree's seed and size;
- ``benchmark/limits/<workload>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric, a function
  ``read(ctx)`` that returns the value or None where it finds nothing to read.

A cell, configuration, mix or metric is added by adding files and entries; no file
that is there changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import types
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: str


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) in e2e_names if "moves" in metric else True


def load_cell(spec_path: str, name: str, bench_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` of the BENCHMARK.json at ``spec_path``, with its files read
    from ``bench_dir`` (the ``benchmark/`` folder beside this package by default)."""
    bench_dir = bench_dir or BENCH_DIR
    spec = _load_json(spec_path)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {spec_path}; known: "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = found[0]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(
        name=name, workload=w,
        config=_load_json(os.path.join(bench_dir, "configs", w["config"] + ".json")),
        traffic=_load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(bench_dir, "limits", name + ".json")),
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def metric_reader(bench_dir: str, name: str) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def bench_module(bench_dir: str, package: str, name: str):
    """The module ``<bench_dir>/<package>/<name>.py``, imported as a member of a
    package whose path is that directory and whose name is its own for each
    directory, so that the module and its relative imports come from ``bench_dir``
    whatever copy of ``package`` was imported first."""
    root = os.path.join(os.path.abspath(bench_dir), package)
    pkg = f"_bench_{package}_{hashlib.sha1(root.encode()).hexdigest()[:12]}"
    if pkg not in sys.modules:
        mod = types.ModuleType(pkg)
        mod.__path__ = [root]
        sys.modules[pkg] = mod
    return importlib.import_module(f"{pkg}.{name}")
