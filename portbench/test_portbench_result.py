"""The result line and BENCHMARK.json: the keys the contract asks for, the
metrics each cell reports, and a run that finds no card."""

import json
import re
import subprocess
import sys

import pytest

from portbench import harness, kinds, metrics
from portbench.conftest import CELLS

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_file_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        # the kind the configuration names defines what the harness reaches through it
        kind = kinds.load(cfg["kind"])
        for attr in ("make_data", "QueryStream", "Reference", "check", "least_bytes", "TINY"):
            assert hasattr(kind, attr), (cfg["kind"], attr)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    every = b["end_to_end"] + b["per_layer"]
    for m in every:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in every}) == len(every)
    layers = {m["layer"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert callable(metrics.load(m["name"]).read)
        # every cell a per-layer metric lists reports the end-to-end metric it moves
        moved = e2e[m["moves"]].get("workloads")
        assert moved is None or set(m["workloads"]) <= set(moved), m["name"]
    for layer in layers:
        assert isinstance(layer, str) and 1 <= len(layer) <= 32 and layer.isprintable(), layer
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        # every cell reports setup_s, another end-to-end metric and a per-layer one
        names = {m["name"] for m in harness.cell_metrics(b, w, False)}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(b, w, True)
    assert {"node-8m.text-b32", "batch-8m.search-b32", "batch-8m.bucket-b32"} <= set(CELLS)
    assert len(CELLS) == len(set(CELLS)) == len(b["workloads"])


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(cpu, tiny, traced):
    b = _bench()
    cell = "batch-8m.search-b32"
    result, lines = harness.run_cell(cell, 2**31 + 5, 0.3, traced, cpu, tiny(cell))
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"]: m["unit"] for m in harness.cell_metrics(
        b, next(w for w in b["workloads"] if w["name"] == cell), traced)}
    for name, m in result["metrics"].items():
        assert wanted[name] == m["unit"] and isinstance(m["value"], float)
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device: no device metric is read there
        assert "device_idle_pct.search" not in result["metrics"]
        assert "plan_ms.search" in result["metrics"]
    else:
        assert set(result["metrics"]) == set(wanted)
    assert [ln.split()[1] for ln in lines] == list(result["check"])
    json.dumps(result)


def test_a_listed_metric_that_reads_nothing_fails_the_run(cpu, tiny, monkeypatch):
    from portbench.metrics import plan_ms

    monkeypatch.setattr(plan_ms, "read", lambda run: None)
    with pytest.raises(RuntimeError, match="plan_ms"):
        harness.run_cell("batch-8m.search-b32", 2**31 + 6, 0.3, True, cpu,
                         tiny("batch-8m.search-b32"))


def test_counters_are_the_readers_own(cpu, tiny, monkeypatch):
    from portbench.metrics import host_syncs_per_batch, plan_ms, topk_fallbacks_per_batch

    snap = harness._counters([host_syncs_per_batch, topk_fallbacks_per_batch, plan_ms])
    assert set(snap) == {host_syncs_per_batch.__name__, topk_fallbacks_per_batch.__name__}
    # the harness reads the reader's counter before and after the window
    calls = iter(range(0, 1000, 10))
    monkeypatch.setattr(host_syncs_per_batch, "counter", lambda: next(calls))
    result, _ = harness.run_cell("batch-8m.search-b32", 2**31 + 7, 0.3, True, cpu,
                                 tiny("batch-8m.search-b32"))
    batches = result["attempted"] // 32
    assert result["metrics"]["host_syncs_per_batch.search"]["value"] == pytest.approx(10 / batches)


def test_a_split_name_is_read_by_its_base_reader():
    from portbench.metrics import qps

    assert metrics.load("qps.served") is qps and metrics.load("qps.search") is qps
    with pytest.raises(ModuleNotFoundError):
        metrics.load("no_such_metric.batch")


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_unknown_workload_fails():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such.cell")


def test_a_configuration_without_kind_fails_to_load(tmp_path, monkeypatch):
    b = _bench()
    (tmp_path / "portbench" / "traffic").mkdir(parents=True)
    conf = b["configs"][0]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    del cfg["kind"]
    (tmp_path / "portbench" / "configs").mkdir()
    (tmp_path / conf["file"]).write_text(json.dumps(cfg))
    cell = next(w for w in b["workloads"] if w["config"] == conf["name"])
    traffic = f"portbench/traffic/{cell['traffic']}.json"
    (tmp_path / traffic).write_text((ROOT / traffic).read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(ValueError, match="kind"):
        harness.load_cell(cell["name"])
