"""BENCHMARK.json and the files it names, read and cross-checked."""

import ast
import json
import re

import pytest

from portbench import harness, judge

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_one_line_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"] == f"portbench/configs/{conf['name']}.json"
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert (harness.HERE / "routes" / f"{cfg['route']}.py").is_file()
    assert (harness.HERE / "judges" / f"{cfg['judge']}.py").is_file()
    for key in conf["reduced"]:
        assert NAME.match(key) and key in cfg
    # the limits name exactly the numbers that the judge compares
    limits = judge.load_limits(conf["name"])
    assert set(limits) == set(judge.find(cfg["judge"]).NUMBERS)
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert (harness.HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    _c, _conf, e2e, layer = harness.cell_entries(BENCH, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


def test_configuration_and_traffic_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_files(metric):
    assert metric["source"] in SOURCES
    path = harness.HERE / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert ast.get_docstring(tree)
    assert callable(harness.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metrics_move_what_their_cells_report(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    moved_in = set(e2e[metric["moves"]].get("workloads", cells))
    assert set(metric.get("workloads", moved_in)) <= moved_in
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
