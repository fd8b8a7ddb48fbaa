"""The cells of ``BENCHMARK.json`` and the files they are made of: the
configuration (``configs/``), the traffic (``traffic/``), the limits of
the comparison (``limits/<cell>.json``), and the description and the
reference of each part of the model (``kinds/``, ``reference/``).  Plain
JSON, no torch, so the cell's environment can be set before torch is
imported."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from . import kinds

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, manifest: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the manifest, with its configuration, traffic
    and limits read from their files; refused, naming the files to add,
    where a part of its model has no description or no reference."""
    bench = _load(manifest)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in {manifest.name}: "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(ROOT / conf["file"])
    missing = kinds.missing(config)
    if missing:
        raise SystemExit(f"{name}: {conf['name']} has parts the benchmark "
                         f"does not describe: add {', '.join(missing)}")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=_load(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_load(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])
