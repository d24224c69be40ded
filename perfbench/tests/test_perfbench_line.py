"""The last line of a run: its keys, in the contract's order, with the
compared numbers last (a CPU smoke run, past the look for a card)."""
import json
import time

import pytest

from conftest import smoke_cell
from perfbench import harness


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    cell = smoke_cell("gpt-2.7b.train.taco")
    result, lines = harness.run_cell(cell, 5, 0.2, trace,
                                     time.perf_counter(), device="cpu",
                                     smoke=True)
    want = ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["check"]
    assert list(result) == want
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: only what a count or the host clock reads
        assert set(result["metrics"]) <= {"step_mfu_pct", "step_ms_max",
                                          "tp_hop_bytes_per_token"}
    else:
        assert set(result["metrics"]) == {"train_tok_s", "peak_mem_gib",
                                          "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(result["check"]) == list(cell["limits"])
    assert [line.split(":")[0] for line in lines[-len(cell["limits"]):]] \
        == [f"check {k}" for k in result["check"]]
    json.dumps(result)
