"""BENCHMARK.json keeps to the format of the benchmark contract."""

import json
import re

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entries():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for section, keys in KEYS.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.match(e["name"]), e["name"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (REPO / "portbench" / "workloads" / f"{w['name']}.json").is_file()
    assert used == set(configs)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # Every cell that reports the metric reports the end-to-end metric it moves.
        cells = set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))
        assert cells <= set(e2e[m["moves"]].get("workloads", cells))
    for name in list(e2e) + [m["name"] for m in BENCH["per_layer"]]:
        assert any((REPO / "portbench" / "metrics" / f"{n}.py").is_file() for n in (name, name.split(".", 1)[0]))
    for w in BENCH["workloads"]:
        own = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in own} and len(own) >= 2 and layer
