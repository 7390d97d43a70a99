"""The whole slice: the port's step-driven server against the reference's.

Both packages build ``serve.py``'s net (sizes (256, 1024, 256), block 32,
density 0.1, gelu, Connection Reordering) and answer the same request
stream; each request's answer agrees within f32 ``rtol = atol = 1e-5``
(the two sides sum in different orders).  The scheduling rules are checked
against the port's own contract with an injected clock.
"""

import numpy as np
import pytest
from conftest import FakeClock

from repro.engine import Engine as JaxEngine
from repro.launch.serve import _make_ffnn_layers
from repro.serving import BucketedPlanSet as JaxPlanSet
from repro.serving import SparseServer as JaxServer
from repro_torch.convert import layers_from_numpy
from repro_torch.engine import Engine
from repro_torch.launch import serve
from repro_torch.serving import (
    BucketedPlanSet,
    SparseServer,
    bucket_sizes,
    percentile,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_plans():
    layers = serve.make_ffnn_layers((64, 128, 64), 0.5, 32)
    engine = Engine(device="cpu", activation="gelu")
    return BucketedPlanSet.compile(layers, engine=engine, max_batch=4).warmup()


def drive_stream(server, rows, burst_sizes):
    """Submit ``rows`` in bursts, polling between bursts; drain; collect."""
    rids, i = [], 0
    for n in burst_sizes:
        for x in rows[i:i + n]:
            rids.append(server.submit(x))
        i += n
        server.poll()
    server.drain()
    return rids, [server.result(r) for r in rids]


@pytest.mark.parametrize("no_fuse", [False, True])
def test_server_answers_same_stream_as_reference(no_fuse):
    jlayers = _make_ffnn_layers((256, 1024, 256), 0.1, 32)
    kw = dict(activation="gelu", reorder=True, reorder_iters=50,
              fuse=not no_fuse)
    jplans = JaxPlanSet.compile(jlayers, engine=JaxEngine(backend="jnp", **kw),
                                max_batch=4).warmup()
    tplans = BucketedPlanSet.compile(layers_from_numpy(jlayers),
                                     engine=Engine(device="cpu", **kw),
                                     max_batch=4).warmup()
    np.testing.assert_array_equal(tplans.base.order, jplans.base.order)
    assert tplans.base.io.to_dict() == jplans.base.io.to_dict()
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((23, 256)).astype(np.float32)
    bursts = [3, 1, 4, 4, 2, 4, 1, 3, 1]
    jrids, jys = drive_stream(JaxServer(jplans, clock=FakeClock()), rows,
                              bursts)
    trids, tys = drive_stream(SparseServer(tplans, clock=FakeClock()), rows,
                              bursts)
    assert trids == jrids == list(range(23))
    for jy, ty in zip(jys, tys):
        assert ty is not None and ty.shape == (256,)
        np.testing.assert_allclose(ty, np.asarray(jy), **TOL)


def test_bucket_sizes_match_reference():
    from repro.serving.bucketing import bucket_sizes as jax_bucket_sizes

    for n in (1, 2, 3, 4, 7, 32, 48):
        assert bucket_sizes(n) == jax_bucket_sizes(n)
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_bucketed_set_pads_to_the_smallest_bucket(port_plans):
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float64)
    y = port_plans(x)
    assert y.shape == (3, 64) and y.dtype == np.float32
    assert port_plans.bucket_for(3) == 4 and port_plans.bucket_calls[4] >= 1
    np.testing.assert_allclose(y, port_plans.base.safe_twin()(
        x.astype(np.float32)).numpy(), **TOL)
    big = port_plans(np.zeros((9, 64), np.float32))   # top-bucket chunks
    assert big.shape == (9, 64)
    assert set(port_plans.warmup_s) == {1, 2, 4}
    assert "SAFE MODE" in port_plans.build_safe_twin().describe()


def test_admission_bound_rejects(port_plans):
    server = SparseServer(port_plans, max_queue=2, clock=FakeClock())
    x = np.zeros(64, np.float32)
    assert server.submit(x) == 0 and server.submit(x) == 1
    assert server.submit(x) is None
    assert server.metrics.rejected == 1 and server.queue_depth == 2
    with pytest.raises(ValueError, match="expected input"):
        server.submit(np.zeros(63, np.float32))


def test_wait_or_fire_policy(port_plans):
    clock = FakeClock()
    server = SparseServer(port_plans, slo_ms=1000.0, clock=clock)
    server._lat_ewma = {}                 # no latency estimate yet
    x = np.zeros(64, np.float32)
    server.submit(x)
    assert not server.should_fire() and server.poll() == 0
    clock.advance(0.26)                   # past max_wait = slo / 4
    assert server.should_fire() and server.poll() == 1
    for _ in range(4):                    # a full batch fires at once
        server.submit(x)
    assert server.poll() == 4
    server.submit(x)
    server._lat_ewma = {1: 0.9}           # deadline - now <= estimate
    clock.advance(0.11)
    assert server.should_fire()
    assert server.drain() == 1
    snap = server.metrics.snapshot()
    assert snap["served"] == 6 and snap["batches"] == 3


def test_results_are_evicted_beyond_capacity(port_plans):
    server = SparseServer(port_plans, result_capacity=2, clock=FakeClock())
    rids = [server.submit(np.zeros(64, np.float32)) for _ in range(3)]
    server.drain()
    assert server.result(rids[0]) is None
    assert server.result(rids[2]) is not None
    assert server.result(rids[2]) is None       # collected once
    assert server.metrics.results_evicted == 1


def test_percentile_is_total():
    assert percentile([], 50) == 0.0
    assert percentile([3.0], 99) == 3.0
    assert percentile([1.0, 2.0, 3.0], 150) == 3.0


def test_serve_entry_point_on_cpu(capsys):
    args = serve.parse_args(["--sparse-ffnn", "--device", "cpu",
                             "--ffnn-sizes", "128", "256", "128",
                             "--block", "32", "--requests", "12",
                             "--reorder-iters", "30", "--weight-dtype", "bf16"])
    report = serve.serve_sparse_ffnn(args)
    out = capsys.readouterr().out
    assert "ExecutionPlan[kernel/fused+bf16 on cpu]" in out
    assert "served 12 sparse-FFNN requests (12 collected)" in out
    assert report.forwards == report.server.metrics.batches
    rids = sorted(report.inputs)
    x = np.stack([report.inputs[r] for r in rids])
    want = report.server.plans.base.safe_twin()(x).numpy()
    got = np.stack([report.outputs[r] for r in rids])
    np.testing.assert_allclose(got, want, **TOL)


CLI_CASES = {
    "pipeline-router": ["--async", "--workers", "2", "--models", "2",
                        "--gate"],
    "http-resilience": ["--http-port", "0", "--http-clients", "3",
                        "--workers", "2", "--metrics-port", "0", "--breaker",
                        "2", "--breaker-cooldown-ms", "100", "--retries", "1",
                        "--batch-timeout-ms", "5000"],
    "safe-mode": ["--safe-mode", "--backend", "torch", "--slo-ms", "20",
                  "--max-queue", "64"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_serve_runtime_flags_on_cpu(case, tmp_path, capsys):
    """The serving runtime's flags end to end on the CPU: every request is
    answered, and each answer equals its model's safe twin."""
    argv = ["--sparse-ffnn", "--device", "cpu", "--ffnn-sizes", "128", "256",
            "128", "--block", "32", "--requests", "16", "--reorder-iters",
            "20", "--plan-store", str(tmp_path / "plans"), "--trace-out",
            str(tmp_path / "trace.json")] + CLI_CASES[case]
    report = serve.serve_sparse_ffnn(serve.parse_args(argv))
    out = capsys.readouterr().out
    assert "plan-store hit" not in out and "trace: " in out
    assert len(report.outputs) == 16
    assert all(y is not None for y in report.outputs.values())
    runtime = report.server
    for key, x in report.inputs.items():
        plans = runtime.servers[key[0]].plans if case == "pipeline-router" \
            else runtime.plans
        want = plans.base.plain()(x[None]).numpy()[0]
        np.testing.assert_allclose(report.outputs[key], want, **TOL)
    if case == "pipeline-router":
        assert "served 16 requests across 2 models (16 collected)" in out
        assert "executor pool: 2 workers" in out
    elif case == "http-resilience":
        assert report.http_codes == {200: 16}
        assert "metrics scrape:" in out and "repro_served 16" in out
        assert "resilience: retries=0" in out and "[+safe twin]" in out
        assert "degraded batches=0" in out
    else:
        assert "safe mode:" in out and "[SAFE MODE]" in out
    # a second run warm-starts from the store
    serve.serve_sparse_ffnn(serve.parse_args(argv + ["--requests", "2"]))
    assert "plan-store hit" in capsys.readouterr().out
