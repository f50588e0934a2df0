"""`BENCHMARK.json` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, generator,
reference or metric sits in a file of its own under the benchmark's
folder, so a new one is a new file and a new entry, never an edit:

    configs/<file named by the configuration's entry>
    traffic/<traffic name>.json
    generators/<the mix's "generator">.py       build(config, mix, seed, device, ...)
    references/<the configuration's "reference">.py
    metrics/<metric name>.py                     read(run) -> float | None
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
from types import ModuleType


class SpecError(ValueError):
    """A name that `BENCHMARK.json` or the benchmark's folder lacks."""


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_module(path: pathlib.Path, kind: str) -> ModuleType:
    if not path.is_file():
        raise SpecError(f"no {kind} file {path}")
    # a name of its own for each file, so two copies of the benchmark never share a module
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:10]
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """`BENCHMARK.json` at `root` and the benchmark's folder, its first path."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.folder = self.root / self.data["paths"][0]
        self._modules: dict[pathlib.Path, ModuleType] = {}

    def _module(self, path: pathlib.Path, kind: str) -> ModuleType:
        if path not in self._modules:
            self._modules[path] = _load_module(path, kind)
        return self._modules[path]

    def cell(self, name: str) -> dict:
        return _by_name(self.data["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = _by_name(self.data["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        path = self.folder / "traffic" / f"{name}.json"
        if not path.is_file():
            raise SpecError(f"no traffic file {path}")
        return json.loads(path.read_text())

    def generator(self, name: str) -> ModuleType:
        return self._module(self.folder / "generators" / f"{name}.py", "generator")

    def reference(self, name: str) -> ModuleType:
        return self._module(self.folder / "references" / f"{name}.py", "reference")

    def reader(self, metric: str) -> ModuleType:
        return self._module(self.folder / "metrics" / f"{metric}.py", "metric")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (`trace` False) or per-layer ones:
        those that list the cell under `workloads`, or list no cells."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", (cell,))]
