"""Every cell of ``BENCHMARK.json`` finds its files, and the manifest
keeps to its contract's shape."""
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["moves"] for m in BENCH["per_layer"]} <= \
        {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(cell):
    from perfbench import harness
    c = harness.load_cell(cell)
    assert c["config"]["name"] == \
        {w["name"]: w for w in BENCH["workloads"]}[cell]["config"]
    from perfbench import check
    assert c["limits"] and set(c["limits"]) <= set(check.NUMBERS)
    if c["traffic"]["hop_codec"]["kind"] != "identity":
        assert "hop_gap" in c["limits"]
    assert c["per_layer"] and len(c["end_to_end"]) >= 2
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for conf in BENCH["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith("perfbench/")
