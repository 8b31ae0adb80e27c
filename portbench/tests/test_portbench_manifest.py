"""The manifest and the files it names: every file parses, is listed, and a
cell added as new files is found with no edit of the harness."""
import json
import re
import shutil

import pytest
import torch

from portbench import ics, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _stems(kind, ext):
    return sorted(p.name[:-len(ext)] for p in (spec.HERE / kind).iterdir()
                  if p.name.endswith(ext))


def test_every_file_parses_and_is_listed():
    man = spec.manifest()
    configs = {c["name"]: c for c in man["configs"]}
    cells = {w["name"]: w for w in man["workloads"]}
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert _stems("configs", ".json") == sorted(configs)
    assert _stems("workloads", ".json") == sorted(cells)
    assert _stems("traffic", ".json") == sorted(
        {w["traffic"] for w in cells.values()})
    assert _stems("metrics", ".py") == sorted(metrics)
    for name, c in configs.items():
        assert c["file"] == f"portbench/configs/{name}.json"
        data = spec.load("configs", name)
        assert data["reduced"] == c["reduced"] and "assumed" in data
        assert data["source"]
    for name in cells:
        cell = spec.cell(name)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert set(cell.check["limits"]) >= {"start_err"}
    for m in metrics:
        assert callable(spec.reader(m))


def test_manifest_keeps_the_contract_shapes():
    man = spec.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.cell(w).end_to_end}
    assert len(json.dumps(man)) < 64 * 1024


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new manifest entries; nothing else changes."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    man = spec.manifest()
    cfg = json.loads((here / "configs" / "sedov-128.json").read_text())
    cfg["problem_args"]["n"] = cfg["ics"]["n_side"] = 96
    cfg["ics"]["kind"] = "sedov_shifted"
    (here / "ics" / "sedov_shifted.py").write_text(
        "from portbench.ics import sedov\n"
        "def build(ic, gen, dtype, device):\n"
        "    return sedov.build(ic, gen, dtype, device)\n")
    (here / "configs" / "sedov-96.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "rungs3.json").read_text())
    traffic["rungs"] = 2
    (here / "traffic" / "rungs2.json").write_text(json.dumps(traffic))
    shutil.copy(here / "workloads" / "sedov128.rungs3.json",
                here / "workloads" / "sedov96.rungs2.json")
    (here / "metrics" / "ticks_per_chunk.sedov.py").write_text(
        "def read(run):\n    c = run.counters\n"
        "    return c['steps'] / c['chunks']\n")
    man["configs"].append({"name": "sedov-96", "source": "x", "reduced": [],
                           "file": "portbench/configs/sedov-96.json",
                           "why": "x"})
    man["workloads"].append({"name": "sedov96.rungs2", "config": "sedov-96",
                             "traffic": "rungs2", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "ticks_per_chunk.sedov", "unit": "ticks",
                             "better": "higher", "source": "program_counter",
                             "layer": "x", "moves": "sim_time_per_s.rungs",
                             "workloads": ["sedov96.rungs2"]})
    for m in man["end_to_end"]:
        if m["name"] == "sim_time_per_s.rungs":
            m["workloads"].append("sedov96.rungs2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = spec.cell("sedov96.rungs2", root=tmp_path, here=here)
    assert cell.config["ics"]["n_side"] == 96 and cell.traffic["rungs"] == 2
    build = ics.builder(cell.config["ics"]["kind"], here=here / "ics")
    made = build(dict(cell.config["ics"], n_side=4),
                 torch.Generator().manual_seed(1), torch.float64, "cpu")
    assert made["pos"].shape == (64, 3) and float(made["vel"].abs().max()) == 0
    assert "ticks_per_chunk.sedov" in [m["name"] for m in cell.per_layer]
    assert "sim_time_per_s.rungs" in [m["name"] for m in cell.end_to_end]
    read = spec.reader("ticks_per_chunk.sedov", here=here)

    class Run:
        counters = {"steps": 32, "chunks": 2}
    assert read(Run()) == 16
    with pytest.raises(SystemExit):
        spec.cell("nope", root=tmp_path, here=here)
    assert spec.reference(cell.config).__name__ == "portbench.reference"
    with pytest.raises(SystemExit):
        spec.reference(dict(cell.config, reference="reference_2d"))
