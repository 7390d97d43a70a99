"""The harness end to end on the CPU, on small cells made the way a later
change adds one: its result line, the control and the planted faults it must
catch, cells found by name, and what its runs import."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparsebench.spec import ROOT, load_cell
from sparsebench.testing import tiny_root, tiny_run

ENV = dict(os.environ,
           PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                       str(ROOT / "bench")]))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("mix", ["tiny-online", "tiny-offline"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(root, mix, trace):
    line, _ = tiny_run(root, mix, trace=trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = load_cell(f"tiny-ffnn.{mix}", root)
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in wanted}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in wanted:
        if m["name"] in line["metrics"]:
            v = line["metrics"][m["name"]]
            assert set(v) == {"value", "unit"} and v["unit"] == m["unit"]
            assert isinstance(v["value"], float)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["compared"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(line))


@pytest.mark.parametrize("mix", ["tiny-online", "tiny-offline"])
def test_control_fails_the_comparison(root, mix):
    line, _ = tiny_run(root, mix, control="tf32")
    assert line["correct"] is False
    assert line["compared"]["max_err_rel"]["value"] > \
        10 * line["compared"]["max_err_rel"]["limit"]


def test_online_counters_start_with_the_window(root):
    line, out = tiny_run(root, "tiny-online", trace=True)
    waits = out.obs["queue_wait_s"]
    rows, batches = out.obs["batch_rows"]
    submitted = len(out.obs["submit_lateness_s"])
    # every queue wait kept, none of the warm-up's: the rows of the
    # window's batches, no more than it submitted before the stretch
    assert batches > 0 and rows <= len(waits) <= submitted
    assert line["metrics"]["queue_wait_p50_ms.online"]["value"] == \
        pytest.approx(1e3 * float(np.median(waits)))
    assert line["metrics"]["rows_per_batch.online"]["value"] == rows / batches
    late = line["metrics"]["submit_lateness_p95_ms.online"]["value"]
    assert 0.0 <= late < 1e3 * out.info["latency_ms"]["p99"] + 1e3


def _half_left_out(orig):
    def call(self, x):
        x = torch.as_tensor(x)
        half = x.shape[0] // 2
        y = orig(self, x[:half])
        return torch.cat([y, y.new_zeros((x.shape[0] - half, y.shape[1]))])
    return call


def _answer_altered(orig):
    def call(self, x):
        y = orig(self, x).clone()
        y[0, 0] += 1.0
        return y
    return call


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("mix", ["tiny-online", "tiny-offline"])
def test_planted_fault_comes_out_not_correct(root, mix, fault, monkeypatch):
    from repro_torch.engine.plan import ExecutionPlan

    monkeypatch.setattr(ExecutionPlan, "__call__",
                        fault(ExecutionPlan.__call__))
    line, _ = tiny_run(root, mix)
    assert line["correct"] is False
    assert line["failed"] > 0


def _digests(top):
    return {p.relative_to(top): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_new_files_add_a_cell_with_no_edit(tmp_path):
    top = tiny_root(tmp_path)
    # a metric is one more file and one more entry
    (top / "bench" / "metrics" / "tiny_calls.offline.py").write_text(
        "def read(obs):\n"
        "    counts = obs.get('calls_by_batch')\n"
        "    return float(sum(counts)) if counts else None\n")
    bench = json.loads((top / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tiny_calls.offline", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "engine", "moves": "rows_per_s",
        "workloads": ["tiny-ffnn.tiny-offline"]})
    (top / "BENCHMARK.json").write_text(json.dumps(bench))
    line, out = tiny_run(top, "tiny-offline", trace=True)
    assert line["metrics"]["tiny_calls.offline"]["value"] == out.attempted
    # every file of the benchmark is as it was; only entries were added
    before, after = _digests(ROOT / "bench"), _digests(top / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(top / "bench") for p in [
            top / "bench/configs/tiny-ffnn.json",
            top / "bench/traffic/tiny-online.json",
            top / "bench/traffic/tiny-offline.json",
            top / "bench/limits/tiny-ffnn.tiny-online.json",
            top / "bench/limits/tiny-ffnn.tiny-offline.json",
            top / "bench/metrics/tiny_calls.offline.py"]}


def test_every_cell_has_its_files_and_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["reduced"] == []
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    top = tiny_root(tmp_path)
    code = (
        "import sys, json\n"
        "from sparsebench.testing import tiny_run\n"
        "from sparsebench.cli import forbidden_modules\n"
        "from sparsebench.spec import load_cell\n"
        f"top = {str(top)!r}\n"
        "for mix in ('tiny-online', 'tiny-offline'):\n"
        "    line, _ = tiny_run(top, mix, seconds=0.2, trace=True)\n"
        "    assert line['correct'], line\n"
        "for w in json.load(open(top + '/BENCHMARK.json'))['workloads']:\n"
        "    cell = load_cell(w['name'], top)\n"
        "    [cell.reader(m['name']) for m in cell.per_layer]\n"
        "print(json.dumps(forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "bert-ffnn.offline-4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
