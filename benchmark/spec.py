"""Finding a cell's pieces by name: BENCHMARK.json's entry, the
configuration file, the traffic file (which names the driver), the
cell's limits (`checks/<workload>.json`) and the metric files
(`metrics/<metric>.py`). Nothing here knows a cell: a new cell, config,
traffic mix or metric is new files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass, field

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# TrainConfig's fields outside its sections
_TOP = ("log_every", "checkpoint_dir", "checkpoint_every", "tensorboard_dir", "debug_barriers")


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def cell(bench: dict, workload: str, root=ROOT) -> dict:
    """The workload entry with its config entry, the config, the traffic
    and the limits loaded."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r}; have {[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    root = pathlib.Path(root)
    return {"workload": w, "config_entry": conf,
            "config": load_json(root / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "checks" / f"{workload}.json")}


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in a workload: in those it lists, or
    in every one where it lists none."""
    return workload in metric.get("workloads", [workload])


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


@dataclass
class Job:
    """One run of one cell."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    limits: dict
    device: object
    # a fault planted under the timed path (benchmark/faults.py); identity in a run
    wrap_step: object = field(default=lambda fn: fn)
    # also read the numbers no limit compares (benchmark/control.py)
    readings: bool = False

    @property
    def model(self) -> dict:
        return self.config["model"]

    def train_config(self):
        """The port's TrainConfig as the configuration file states it."""
        from cffm_tpu_torch import config as c

        def section(cls, d):
            return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

        return c.TrainConfig(name=self.config["name"],
                             model=section(c.ModelConfig, self.config["model"]),
                             optim=section(c.OptimizerConfig, self.config["optim"]),
                             data=section(c.DataConfig, self.config["data"]),
                             sharding=section(c.ShardingConfig, self.config["sharding"]),
                             **{k: self.config[k] for k in _TOP if k in self.config})
