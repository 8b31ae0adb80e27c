"""The manifest and the files it names, found by name.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); its own check lives in
``workloads/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. Adding any of them is adding a file and a manifest
entry: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def manifest(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load(kind: str, name: str, here: Path = HERE) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"{path} not found: the manifest names {kind} "
                         f"{name!r}")
    with open(path) as fh:
        return json.load(fh)


def reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"{path} not found: no reader for metric {name!r}")
    mod_name = "portbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(config: dict):
    """The plain reference the configuration names (``reference``, by
    default ``reference``): the module ``<name>.py`` of the benchmark's
    folder. A configuration whose equations the default does not compute
    (another dimension) brings a module of its own."""
    name = config.get("reference", "reference")
    if not (HERE / f"{name}.py").is_file():
        raise SystemExit(f"{HERE / name}.py not found: the configuration "
                         f"names the reference {name!r}")
    return importlib.import_module(f"portbench.{name}")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    entry: dict          # the manifest's workload entry
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    check: dict          # workloads/<name>.json
    end_to_end: list     # the manifest's end-to-end metrics of this cell
    per_layer: list      # the manifest's per-layer metrics of this cell
    reference: object    # the plain reference module the config names


def cell(name: str, root: Path = REPO, here: Path = HERE) -> Cell:
    man = manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{', '.join(entries)}")
    entry = entries[name]
    e2e = [m for m in man["end_to_end"] if _listed(m, name)]
    e2e_names = {m["name"] for m in e2e}
    # a per-layer metric without a workloads list belongs to every cell
    # that reports the end-to-end metric it moves
    per = [m for m in man["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in e2e_names)]
    config = load("configs", entry["config"], here)
    return Cell(name=name, entry=entry, config=config,
                traffic=load("traffic", entry["traffic"], here),
                check=load("workloads", name, here),
                end_to_end=e2e, per_layer=per, reference=reference(config))
