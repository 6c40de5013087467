"""BENCHMARK.json parses, keeps to the contract's shapes and characters,
and every configuration, mix, metric and limit it names resolves to its
file."""
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MAN) == KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32
    for w in MAN["command"]:
        assert not w.startswith("/") and ".." not in w


def test_names_units_and_entry_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for text in [c["why"] for c in MAN["configs"] + MAN["workloads"]] + \
            [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_and_reports(w):
    cfg = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert (REPO / cfg["file"]).is_file()
    assert cfg["file"].startswith("benchmark/")
    mix = REPO / "benchmark" / "traffic" / f"{w['traffic']}.json"
    kind = json.loads(mix.read_text())["kind"]
    assert (REPO / "benchmark" / "kinds" / f"{kind}.py").is_file()
    assert (REPO / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    e2e = [m for m in MAN["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    for m in e2e:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    pl = [m for m in MAN["per_layer"]
          if w["name"] in m.get("workloads", [w["name"]])]
    assert pl
    for m in pl:
        assert m["moves"] in [e["name"] for e in e2e]
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_each_config_file_states_what_it_assumed():
    for c in MAN["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]
