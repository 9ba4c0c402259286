"""``BENCHMARK.json`` against the contract's form, and every file it names
found by name."""
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    assert SPEC["command"][1] == "benchmark/run.py" and (ROOT / SPEC["command"][1]).is_file()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in METRICS] + [w["name"] for w in SPEC["workloads"]] \
        + [c["name"] for c in SPEC["configs"]] + [w["traffic"] for w in SPEC["workloads"]] \
        + [w["config"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for group in (METRICS, SPEC["workloads"], SPEC["configs"]):
        assert len({m["name"] for m in group}) == len(group)
    assert all(LINE.match(x["why"]) for x in SPEC["workloads"] + SPEC["configs"])
    assert all(LINE.match(m["layer"]) for m in SPEC["per_layer"])


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(workload):
    from harness import cell as C, check
    cell = C.load_cell(workload)
    w = next(x for x in SPEC["workloads"] if x["name"] == workload)
    assert cell.config["name"] == w["config"] and cell.mix["name"] == w["traffic"]
    assert cell.limits and set(cell.limits) <= set(check.NAMES)
    for m in cell.per_layer:
        module = C.load_metric(m["name"])
        assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES, module.BETTER) == \
            (m["layer"], m["unit"], m["source"], m["moves"], m["better"])
        assert callable(module.read)


def test_every_metric_file_has_an_entry():
    named = {m["name"] for m in SPEC["per_layer"]}
    assert {p.stem for p in (BENCH / "metrics").glob("*.py")} == named


def test_configs_hold_their_published_widths():
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["source"] == c["source"] and config["reduced"] == c["reduced"] == []
        f = config["flags"]
        assert (f["input_size"], f["init_ch"], f["max_ch"], f["output_stride"], f["hid_ch"],
                f["num_classes"], f["batch_size"]) == ([256, 256], 32, 512, 8, 64, 5, 12)
