"""Finds a cell's files by the names ``BENCHMARK.json`` gives.

- a configuration ``<c>``: ``configs/<c>/`` beside the file named by
  its ``file`` entry: ``config.json`` (the sizes as run), ``driver.py``
  (builds the port's training step), ``reference.py`` (the plain fp32
  step, which imports nothing of the port) and ``flops.py``;
- a traffic mix ``<t>``: ``hvdbench/traffic/<t>.json``;
- a cell ``<w>``: ``hvdbench/workloads/<w>.json`` (the limits of the
  comparison that decides ``correct``);
- a metric ``<m>``, end-to-end or per layer: ``hvdbench/metrics/<m>.py``,
  whose ``read(run)`` returns the value or ``None`` where it finds
  nothing to read.

So a configuration, mix, cell or metric is added as new files and new
entries, and no file here changes.
"""

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str, name: str):
    """Import the Python file ``path`` as module ``name`` (cached)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, workload: str, root: str = ROOT):
        self.root = root
        self.bench = _read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no cell {workload!r} in BENCHMARK.json "
                           f"(cells: {sorted(cells)})")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        config_file = os.path.join(root, self.config_entry["file"])
        self.config_dir = os.path.dirname(config_file)
        self.config = _read_json(config_file)
        bench_dir = os.path.join(root, "hvdbench")
        self.traffic = _read_json(os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.workload = _read_json(os.path.join(
            bench_dir, "workloads", workload + ".json"))
        self.metrics_dir = os.path.join(bench_dir, "metrics")
        if int(self.traffic["ranks"]) != self.chips:
            raise ValueError(f"{workload}: traffic {self.entry['traffic']} "
                             f"runs {self.traffic['ranks']} ranks on "
                             f"{self.chips} chips")

    def _config_module(self, stem: str):
        tag = self.config_dir.replace(os.sep, "_").replace(".", "_")
        return load_module(os.path.join(self.config_dir, stem + ".py"),
                           f"hvdbench_config{tag}_{stem}")

    @property
    def driver(self):
        return self._config_module("driver")

    @property
    def reference(self):
        return self._config_module("reference")

    @property
    def flops(self):
        return self._config_module("flops")

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it,
        and those with no list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]

    def reader(self, metric: str):
        path = os.path.join(self.metrics_dir, metric + ".py")
        tag = self.metrics_dir.replace(os.sep, "_").replace(".", "_")
        return load_module(path, f"hvdbench_metric{tag}_"
                           + metric.replace(".", "_")).read
