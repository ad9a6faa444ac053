"""Finding a benchmark's parts by name.

``BENCHMARK.json`` lists the configurations, cells and metrics. Each part
sits in a file of its own, found by its name under the benchmark's
directories (the file's ``paths``, relative to ``BENCHMARK.json``):

- a configuration: the ``file`` its entry names;
- a cell: ``cells/<cell>.json`` (the program's entry, its settings, how
  many steps or answers the check reads, and the limits of ``correct``);
- a traffic mix: ``traffic/<mix>.json``, parameters for the maker its
  ``kind`` names, ``traffic/<kind>.py`` (:mod:`benchmark.generate`);
- a metric: ``metrics/<metric>.py``, a reader with ``read(record)``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
REPO_DIR = PACKAGE_DIR.parent


class Spec:
    def __init__(self, bench_file: str | pathlib.Path | None = None):
        self.file = pathlib.Path(bench_file or REPO_DIR / "BENCHMARK.json")
        self.root = self.file.resolve().parent
        with open(self.file) as f:
            self.bench = json.load(f)
        self.dirs = [self.root / p for p in self.bench["paths"]]

    def find(self, kind: str, name: str, suffix: str) -> pathlib.Path:
        for d in self.dirs:
            path = d / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.file}")

    def cell(self, name: str) -> dict:
        """The workload's entry merged with its cell file."""
        with open(self.find("cells", name, ".json")) as f:
            return {**json.load(f), **self.workload(name)}

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return {**json.load(f), **c}
        raise KeyError(f"no configuration {name!r} in {self.file}")

    def traffic(self, mix: str) -> dict:
        with open(self.find("traffic", mix, ".json")) as f:
            return json.load(f)

    def generator(self, kind: str):
        """The maker of a traffic kind's batches: a module with
        ``pool(mix, arch, g, device)`` and ``samples_per_batch(mix)``."""
        return _load(self.find("traffic", kind, ".py"), "traffic", kind)

    def reader(self, metric: str):
        """The metric's ``read(record) -> float | None``."""
        return _load(self.find("metrics", metric, ".py"), "metric",
                     metric).read

    def metrics_for(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end ones
        (those that list it, or list no cells), or with a trace the
        per-layer ones that list it."""
        if not traced:
            return [m for m in self.bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        return [m for m in self.bench["per_layer"] if cell in m["workloads"]]


def _load(path: pathlib.Path, part: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{part}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
