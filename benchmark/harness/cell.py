"""A cell as data: the manifest's entry, its configuration file and its
traffic file, read into the port's ``Config`` and the harness's settings.

Nothing here names a cell: ``BENCHMARK.json`` lists the cells, each
naming a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), and a later PR adds a cell by adding entries
and files.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import typing

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
MANIFEST = CHECKOUT / "BENCHMARK.json"


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def workload(name: str, man: dict = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in {MANIFEST}")


def config_file(name: str, man: dict = None) -> dict:
    man = man or manifest()
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((CHECKOUT / c["file"]).read_text())
    raise SystemExit(f"no configuration {name!r} in {MANIFEST}")


def metrics_of(wl: dict, trace: bool, man: dict = None) -> list:
    """The metrics a run of ``wl`` reports: its end-to-end ones with
    tracing off, its per-layer ones with tracing on."""
    man = man or manifest()
    out = []
    for m in man["per_layer" if trace else "end_to_end"]:
        if wl["name"] in m.get("workloads", [wl["name"]]):
            out.append(m)
    return out


def build_dataclass(cls, values: dict):
    """``cls`` from a dict holding every one of its fields (nested
    dataclasses as dicts); a missing or unknown key is an error, so the
    file is the configuration as it is run."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    if set(values) != names:
        raise ValueError(f"{cls.__name__}: missing {sorted(names - set(values))}"
                         f", unknown {sorted(set(values) - names)}")
    kw = {}
    for f in dataclasses.fields(cls):
        v = values[f.name]
        kw[f.name] = (build_dataclass(hints[f.name], v)
                      if dataclasses.is_dataclass(hints[f.name]) else v)
    return cls(**kw)


def port_config(cfg_file: dict, traffic: dict):
    """The port's ``Config`` of a configuration file under a traffic mix
    (the batch shape is the traffic's)."""
    from graphvqa_tpu_torch.config import (
        BatchConfig, Config, ModelConfig, TrainConfig)
    batch = build_dataclass(BatchConfig, traffic["batch"])
    train = build_dataclass(TrainConfig, dict(
        cfg_file["train"], batch_size=batch.num_graphs))
    return Config(model=build_dataclass(ModelConfig, cfg_file["model"]),
                  batch=batch, train=train)
