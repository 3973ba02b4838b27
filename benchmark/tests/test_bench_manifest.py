"""BENCHMARK.json against the contract's limits, and every name it holds
found as a file of the benchmark."""
import json
import re

import pytest

from harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = cell.manifest()
ROOT = cell.CHECKOUT


def one_line(text):
    return 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_entries_have_just_the_contract_keys():
    shown = {"workloads": {"name", "config", "traffic", "chips", "why"},
             "end_to_end": {"name", "unit", "better", "bound", "source"},
             "per_layer": {"name", "unit", "better", "source", "layer",
                           "moves"}}
    for section, keys in shown.items():
        for e in MAN[section]:
            extra = set(e) - keys
            assert set(e) >= keys and extra <= {"workloads"}, e["name"]
            if section != "workloads":
                assert "workloads" not in extra or e["workloads"]
    for m in MAN["per_layer"]:
        assert one_line(m["layer"]), m["name"]
    assert all(one_line(w) for w in MAN["command"])


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.fullmatch(n), n


def test_metrics_units_and_sources():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (cell.ROOT / "metrics" / f"{m['name']}.py").is_file()
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


def test_each_metric_reports_where_its_move_is_reported():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moved.get("workloads", cells), (m["name"], w)
        assert m["layer"] and "\n" not in m["layer"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in cell.metrics_of(w, False, MAN)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.metrics_of(w, True, MAN), w["name"]


def test_cells_configs_and_their_files():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        assert one_line(w["why"]), w["name"]
        assert NAME.fullmatch(w["traffic"])
        assert (cell.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        assert (cell.ROOT / "limits" / f"{w['name']}.json").is_file()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["why"]) and one_line(c["source"])
        assert c["file"].startswith("benchmark/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
