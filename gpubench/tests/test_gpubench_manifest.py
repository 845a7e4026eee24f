"""BENCHMARK.json and the files it names: present, parsed, and within the
manifest's format (names, units, keys, limits of counts and lengths)."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from gpubench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads(Path(ROOT, "BENCHMARK.json").read_text())
GB = Path(ROOT, "gpubench")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", GB / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(Path(ROOT, "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith("gpubench/")
        cfg = json.loads(Path(ROOT, c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        wl = json.loads((GB / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"]
        assert (GB / "traffic" / f"{w['traffic']}.json").exists()
        assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


def test_metrics_and_their_readers():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    seen = set()
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert m["name"] not in seen
            seen.add(m["name"])
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            reader = _reader(m["name"])
            assert callable(reader.read)
            assert set(m.get("workloads", cells)) <= cells
            if kind == "end_to_end":
                allowed = {"name", "unit", "better", "bound", "source",
                           "workloads"}
                assert set(m) <= allowed
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                allowed = {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
                assert set(m) <= allowed and m["source"] in SOURCES
                assert m["moves"] in e2e and _line(m["layer"])
                if m["name"].endswith("_roofline"):
                    assert m["unit"] == "%" and reader.KERNELS
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for c in cells:
        rep = [m["name"] for m in BENCH["end_to_end"]
               if c in m.get("workloads", cells)]
        assert "setup_s" in rep and len(rep) >= 2
        assert any(c in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in GB.rglob("*")
    if p.is_file() and "__pycache__" not in p.parts))
def test_file_names(path):
    assert PATH.match(path)
