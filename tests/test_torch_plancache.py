"""The port's plan store and manifest layer against the reference's.

Both packages build ``serve.py``'s net at a small width (256 -> 1024 -> 256,
block 32, density 0.1, Connection Reordering) and share one on-disk format:
equal ``plan_cache_key`` strings, byte-identical ``.npy`` files and manifest
array records, and entries that warm-start the other package's store with
zero annealer iterations and a passed self-heal verify.  Narrow weights
(bf16, fp8) cross as raw void records under their logical dtype.
"""

import json
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import read_manifest_dir as jax_read
from repro.checkpoint import write_manifest_dir as jax_write
from repro.engine import Engine as JaxEngine
from repro.engine import Mesh as JaxMesh
from repro.launch.serve import _make_ffnn_layers
from repro.serving import PlanStore as JaxStore
from repro.serving import layers_fingerprint as jax_fingerprint
from repro.serving import plan_cache_key as jax_key
from repro_torch.checkpoint import (
    manifest_exists,
    read_manifest_dir,
    write_manifest_dir,
)
from repro_torch.convert import layers_from_numpy
from repro_torch.engine import Engine, Mesh
from repro_torch.obs import Tracer
from repro_torch.serving.plancache import _artifact_dtypes
from repro_torch.serving import (
    BucketedPlanSet,
    FaultInjector,
    PlanStore,
    layers_fingerprint,
    plan_cache_key,
)

WDTS = ("f32", "bf16", "fp8")
SIZES = (256, 1024, 256)


@pytest.fixture(scope="module")
def nets():
    """The same net in both packages' layer types."""
    jl = _make_ffnn_layers(SIZES, 0.1, 32)
    return jl, layers_from_numpy(jl)


def engines(**kw):
    kw = dict(activation="gelu", reorder=True, reorder_iters=40, **kw)
    return JaxEngine(backend="jnp", **kw), Engine(device="cpu", **kw)


def records(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["arrays"]


# --------------------------------------------------------------------------- #
# keys
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("wdt", WDTS)
def test_cache_keys_equal_the_reference(nets, wdt):
    jl, tl = nets
    assert layers_fingerprint(tl) == jax_fingerprint(jl)
    seen = set()
    for fuse in (True, False):
        for gate in (False, True):
            je, te = engines(weight_dtype=wdt, fuse=fuse, gate=gate)
            key = plan_cache_key(te, tl)
            assert key == jax_key(je, jl)
            seen.add(key)
    je, te = engines(weight_dtype=wdt, seed=3, max_move_span=4)
    assert plan_cache_key(te, tl) == jax_key(je, jl)
    seen.add(plan_cache_key(te, tl))
    assert len(seen) == 5                   # no two settings alias
    # a mesh enters the key as in the reference, and aliases nothing
    for m, d in ((1, 1), (2, 1), (2, 2)):
        key = plan_cache_key(te, tl, mesh=Mesh(m, d))
        assert key == jax_key(je, jl, mesh=JaxMesh(m, d))
        seen.add(key)
    assert len(seen) == 8


# --------------------------------------------------------------------------- #
# entries cross between the packages
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("wdt", WDTS)
def test_reference_entry_warm_starts_the_port(tmp_path, nets, wdt):
    jl, tl = nets
    je, te = engines(weight_dtype=wdt)
    jplan, jhit = JaxStore(str(tmp_path)).get_or_compile(je, jl)
    assert not jhit and jplan.annealer_iters == 40
    tracer = Tracer()
    store = PlanStore(str(tmp_path), tracer=tracer)
    plan, hit = store.get_or_compile(te, tl)
    assert hit and plan.annealer_iters == 0
    assert store.quarantined == 0                      # verify passed
    assert [s.attrs["hit"] for s in tracer.spans()
            if s.name == "store.load"] == [True]
    np.testing.assert_array_equal(plan.order, jplan.order)
    assert plan.io.to_dict() == jplan.io.to_dict()
    cold = engines(weight_dtype=wdt)[1].compile(tl)
    assert cold.annealer_iters == 40
    x = np.random.default_rng(1).standard_normal((5, 256)).astype(np.float32)
    assert torch.equal(plan(x), cold(x))


@pytest.mark.parametrize("wdt", WDTS)
def test_port_entry_warm_starts_the_reference(tmp_path, nets, wdt):
    jl, tl = nets
    je, te = engines(weight_dtype=wdt)
    tplan, thit = PlanStore(str(tmp_path)).get_or_compile(te, tl)
    assert not thit and tplan.annealer_iters == 40
    jstore = JaxStore(str(tmp_path))
    jplan, jhit = jstore.get_or_compile(je, jl)
    assert jhit and jplan.annealer_iters == 0
    assert jstore.quarantined == 0                     # verify passed
    np.testing.assert_array_equal(jplan.order, tplan.order)


@pytest.mark.parametrize("wdt", WDTS)
def test_both_stores_write_the_same_bytes(tmp_path, nets, wdt):
    jl, tl = nets
    je, te = engines(weight_dtype=wdt, gate=True)
    jstore = JaxStore(str(tmp_path / "jax"))
    tstore = PlanStore(str(tmp_path / "port"))
    jstore.get_or_compile(je, jl)
    tstore.get_or_compile(te, tl)
    (key,) = tstore.keys()
    assert jstore.keys() == [key]
    jpath, tpath = jstore.path_for(key), tstore.path_for(key)
    assert records(tpath) == records(jpath)
    names = sorted(os.listdir(tpath))
    assert names == sorted(os.listdir(jpath))
    assert ("flat_qblocks.npy" in names) == (wdt != "f32")
    for name in names:
        if name.endswith(".npy"):
            with open(os.path.join(tpath, name), "rb") as a, \
                    open(os.path.join(jpath, name), "rb") as b:
                assert a.read() == b.read(), name
    if wdt != "f32":
        rec = next(r for r in records(tpath) if r["name"] == "flat_qblocks")
        assert rec["dtype"] == {"bf16": "bfloat16",
                                "fp8": "float8_e4m3fn"}[wdt]


# --------------------------------------------------------------------------- #
# the manifest layer
# --------------------------------------------------------------------------- #

def test_manifest_narrow_dtypes_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    bf = rng.standard_normal(33).astype(ml_dtypes.bfloat16)
    f8 = rng.standard_normal(17).astype(ml_dtypes.float8_e4m3fn)
    ints = rng.integers(0, 8, 64).astype(np.int32)
    # the port writes raw bits under a logical dtype; the reference reads
    # them back as its narrow floats
    path = write_manifest_dir(
        str(tmp_path / "port"),
        {"bf": bf.view(np.uint16), "f8": f8.view(np.uint8), "ints": ints},
        extra={"n": 3}, dtypes={"bf": "bfloat16", "f8": "float8_e4m3fn"})
    arrays, extra = jax_read(path)
    assert extra == {"n": 3}
    assert arrays["bf"].dtype == ml_dtypes.bfloat16
    assert arrays["bf"].tobytes() == bf.tobytes()
    assert arrays["f8"].tobytes() == f8.tobytes()
    np.testing.assert_array_equal(arrays["ints"], ints)
    # the reference's narrow floats come back to the port as raw bits
    path = jax_write(str(tmp_path / "jax"), {"bf": bf, "f8": f8}, {})
    arrays, _ = read_manifest_dir(path)
    assert arrays["bf"].dtype == np.uint16 and arrays["f8"].dtype == np.uint8
    assert arrays["bf"].tobytes() == bf.tobytes()
    assert arrays["f8"].tobytes() == f8.tobytes()
    with pytest.raises(ValueError, match="raw bits"):
        write_manifest_dir(str(tmp_path / "bad"), {"bf": bf.view(np.int16)},
                           dtypes={"bf": "bfloat16"})


def test_manifest_crc_and_atomic_rename(tmp_path):
    path = write_manifest_dir(str(tmp_path / "art"),
                              {"a": np.arange(10, dtype=np.int32)}, {})
    assert manifest_exists(path) and not os.path.exists(path + ".tmp")
    victim = tmp_path / "art" / "a.npy"
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        read_manifest_dir(path)


# --------------------------------------------------------------------------- #
# self-healing
# --------------------------------------------------------------------------- #

def test_corrupt_entry_is_quarantined_then_recompiled(tmp_path, nets):
    _, tl = nets
    te = engines()[1]
    store = PlanStore(str(tmp_path))
    store.get_or_compile(te, tl)
    (key,) = store.keys()
    victim = os.path.join(store.path_for(key), "order.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    assert store.load(te, tl) is None
    assert store.quarantined == 1 and store.keys() == []
    qdir = tmp_path / "quarantine"
    (entry,) = os.listdir(qdir)
    assert "load raised" in (qdir / entry / "QUARANTINE_REASON.txt").read_text()
    plan, hit = store.get_or_compile(te, tl)
    assert not hit and plan.annealer_iters == 40
    assert store.get_or_compile(te, tl)[1] and store.quarantined == 1


def test_drifted_entry_fails_the_verify(tmp_path, nets):
    _, tl = nets
    te = engines(weight_dtype="bf16")[1]
    store = PlanStore(str(tmp_path))
    plan, _ = store.get_or_compile(te, tl)
    arrays = plan.artifact_arrays()
    arrays["flat_rows"] = arrays["flat_rows"][::-1].copy()
    write_manifest_dir(store.path_for(plan_cache_key(te, tl)), arrays,
                       {"format": 1, "io": plan.io.to_dict()},
                       dtypes=_artifact_dtypes(plan))
    assert store.load(te, tl) is None
    assert store.quarantined == 1
    (entry,) = os.listdir(tmp_path / "quarantine")
    assert "self-heal verify failed" in \
        (tmp_path / "quarantine" / entry / "QUARANTINE_REASON.txt").read_text()


def test_load_fault_is_quarantined_and_partial_writes_are_cleaned(tmp_path,
                                                                  nets):
    _, tl = nets
    te = engines()[1]
    inj = FaultInjector()
    store = PlanStore(str(tmp_path), fault_injector=inj)
    path = store.path_for(plan_cache_key(te, tl))
    # a crashed writer's wreckage: a manifest-less final dir and a .tmp
    os.makedirs(path)
    (tmp_path / os.path.basename(path) / "order.npy").write_bytes(b"partial")
    os.makedirs(path + ".tmp")
    assert store.load(te, tl) is None
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    assert store.quarantined == 0
    store.get_or_compile(te, tl)
    inj.inject("store.load", error=IOError("disk read error"), times=1)
    assert store.load(te, tl) is None and store.quarantined == 1
    assert store.get_or_compile(te, tl)[1] is False
    assert store.load(te, tl) is not None


def test_bucketed_compile_through_the_store(tmp_path, nets):
    _, tl = nets
    te = engines()[1]
    store = PlanStore(str(tmp_path))
    cold = BucketedPlanSet.compile(tl, engine=te, max_batch=4,
                                   plan_store=store, safe_twin=True)
    warm = BucketedPlanSet.compile(tl, engine=engines()[1], max_batch=4,
                                   plan_store=store)
    assert not cold.cache_hit and warm.cache_hit
    assert "plan-store hit" in warm.describe()
    assert "[+safe twin]" in cold.describe()
    assert warm.base.annealer_iters == 0
    x = np.random.default_rng(2).standard_normal((3, 256)).astype(np.float32)
    np.testing.assert_array_equal(warm(x), cold(x))


def test_concurrent_callers_pay_one_compile(tmp_path, nets):
    """Four threads warm-starting one network serialize on its key: one
    compiles, the others hit the entry it wrote."""
    _, tl = nets
    store = PlanStore(str(tmp_path))
    hits, mu = [], threading.Lock()

    def build():
        _, hit = store.get_or_compile(engines()[1], tl)
        with mu:
            hits.append(hit)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(hits) == [False, True, True, True]
