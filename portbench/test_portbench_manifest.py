"""Discovery: every cell, configuration, traffic mix and metric in
BENCHMARK.json is found by name, and the manifest keeps to the shape the
harness and its check read."""

import json
import re

import pytest

from portbench import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += WORKLOADS + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits the check's 43,200 seconds
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200 \
        <= 43200


def test_command_and_paths_stay_inside():
    assert MANIFEST["paths"] == ["portbench"]
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_found_by_name(workload):
    cell = harness.find_cell(workload)
    assert harness.driver_class(cell.traffic["kind"])
    assert cell.limits and all(v is not None for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in cell.end_to_end:
        assert callable(harness.reader("end_to_end", m["name"]).read)
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.reader("per_layer", m["name"]).read)
    assert cell.chips == 1


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=[c["name"] for c in MANIFEST["configs"]])
def test_config_files_hold_their_frames(entry):
    path = harness.ROOT / entry["file"]
    assert path.parts[len(harness.ROOT.parts)] == "portbench"
    cfg = json.loads(path.read_text())
    for key in entry["reduced"]:
        assert key in cfg and key in cfg["source_values"]
    for frame in cfg["frames"].values():
        assert (harness.ROOT / frame).exists()


def test_per_layer_metrics_name_their_cells_and_layer():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m["workloads"]) <= set(WORKLOADS)
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
