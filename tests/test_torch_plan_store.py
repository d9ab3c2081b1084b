"""The port's persistent plan store (``repro_torch.serve.plan_store``).

An entry the reference's ``PlanStore.put`` wrote loads in the port's
``PlanStore.load`` under the same key, with an equal trace and
``program_key`` (and the other way round): the two packages share the
``.npz`` format. Traces of all four algorithm kinds round-trip and run
bit-identically; truncated, garbage, stale-schema and renamed entries load
as misses and are unlinked; and a service restarted on a populated store
serves equal tickets with zero ``compile_program`` calls, on the sync and
the async admit path. CPU only (``device="cpu"``).
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import repro.core as ref_core  # noqa: E402
from repro.serve.plan_store import PlanStore as RefStore  # noqa: E402
from repro_torch.core import (BinaryConvPlan, BinaryMatvecPlan,  # noqa: E402
                              ConvPlan, MatvecPlan, execute)
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.core import compile as port_compile  # noqa: E402
from repro_torch.serve import PlanService, plan_store  # noqa: E402
from repro_torch.serve.plan_store import PlanStore, store_key  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
KINDS = ("binary_matvec", "matvec", "conv", "binary_conv")


class _Port:
    BinaryConvPlan, BinaryMatvecPlan = BinaryConvPlan, BinaryMatvecPlan
    ConvPlan, MatvecPlan = ConvPlan, MatvecPlan


def _plan(mod, kind):
    if kind == "binary_matvec":
        return mod.BinaryMatvecPlan(4, 16, **GEOM)
    if kind == "matvec":
        return mod.MatvecPlan(4, 8, 2, **GEOM)
    if kind == "conv":
        p = mod.ConvPlan(6, 6, 2, 4, **GEOM)
        p.ensure_program(np.array([[1, 2], [2, 1]]))
        return p
    p = mod.BinaryConvPlan(6, 8, 2, **GEOM)
    p.ensure_program(np.array([[1, -1], [-1, 1]]))
    return p


def _same_trace(a, b):
    for name in port_compile._CP_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.rows, a.cols, a.n_cycles, a.W, a.I, a.stats) == \
        (b.rows, b.cols, b.n_cycles, b.W, b.I, b.stats)
    assert (a.schedule is None) == (b.schedule is None)
    if a.schedule is not None:
        assert a.schedule.n_segments == b.schedule.n_segments
        for sa, sb in zip(a.schedule.segments, b.schedule.segments):
            assert (sa.mode, sa.t0, sa.t1, sa.W, sa.spans) == \
                (sb.mode, sb.t0, sb.t1, sb.W, sb.spans)
            for f in ("nops", "gate", "dst", "ins", "sel", "perm"):
                np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))


@pytest.mark.parametrize("kind", KINDS)
def test_reference_entry_loads_in_the_port(kind, tmp_path):
    key = (kind, (8, 16), GEOM["rows"], True, "torch")
    ref_cp = _plan(ref_core, kind).compile()
    ref_store = RefStore(tmp_path / "s", configure_jax_cache=False)
    assert ref_store.put(key, ref_cp)
    store = PlanStore(tmp_path / "s")
    assert store.entry_path(key) == ref_store.entry_path(key)
    cp = store.load(key)
    assert cp is not None and store.hits == 1 and store.corrupt == 0
    _same_trace(cp, ref_cp)
    assert at.program_key(cp) == json.loads(bytes(np.load(
        store.entry_path(key))["__meta__"]).decode())["program_key"]
    # the port's own compile of the same plan is the same trace, and its
    # entry loads in the reference
    mine = _plan(_Port, kind).compile()
    _same_trace(mine, ref_cp)
    key2 = key + ("port",)
    assert store.put(key2, mine)
    back = RefStore(tmp_path / "s", configure_jax_cache=False).load(key2)
    assert back is not None
    _same_trace(back, mine)


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_runs_bit_identically(kind, tmp_path):
    plan = _plan(_Port, kind)
    cp = plan.compile()
    store = PlanStore(tmp_path / "s")
    store.put(("k", kind), cp)
    fresh = _plan(_Port, kind)
    loaded = fresh.adopt_compiled(store.load(("k", kind)))
    mem = np.random.default_rng(1).integers(
        0, 2, size=(3, 64, 256)).astype(np.uint8)
    for backend in ("torch-fused", "torch-unfused"):
        a = execute(cp, mem, backend=backend, device="cpu")
        b = execute(loaded, mem, backend=backend, device="cpu")
        np.testing.assert_array_equal(a.mem, b.mem)
        assert (a.cycles, a.stats) == (b.cycles, b.stats)
    assert loaded.kernel_spec is not None or kind == "binary_conv"


def _mangle(path, how):
    if how == "truncate":
        path.write_bytes(path.read_bytes()[:200])
    elif how == "garbage":
        path.write_bytes(b"not a zip at all")
    else:   # a schema bump
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays["__meta__"]).decode())
        meta["store_schema"] = 99
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, **arrays)


@pytest.mark.parametrize("how", ["truncate", "garbage", "schema"])
def test_bad_entry_is_a_miss_and_unlinked(tmp_path, how):
    store = PlanStore(tmp_path / "s")
    key = ("binary_matvec", (4, 16))
    store.put(key, _plan(_Port, "binary_matvec").compile())
    _mangle(store.entry_path(key), how)
    assert store.load(key) is None
    assert store.corrupt == 1 and store.misses == 1
    assert not store.entry_path(key).exists() and len(store) == 0
    assert store.last_error is not None


def test_renamed_entry_fails_the_plan_key_check(tmp_path):
    store = PlanStore(tmp_path / "s")
    store.put("a", _plan(_Port, "matvec").compile())
    store.entry_path("a").rename(store.entry_path("b"))
    assert store.load("b") is None and "plan-key" in store.last_error
    assert store_key("a") != store_key("b") and len(store_key("a")) == 32


def _traffic(svc, seed):
    rng = np.random.default_rng(seed)
    tickets = [
        svc.submit("binary_matvec", rng.choice([-1, 1], size=(5, 20)),
                   rng.choice([-1, 1], size=20)),
        svc.submit("matvec", rng.integers(0, 16, size=(4, 10)),
                   rng.integers(0, 16, size=10), 4),
        svc.submit("conv", rng.integers(0, 16, size=(9, 9)),
                   rng.integers(0, 16, size=(3, 3)), 4),
        svc.submit("binary_conv", rng.choice([-1, 1], size=(8, 20)),
                   rng.choice([-1, 1], size=(3, 3)))]
    svc.flush()
    return tickets


@pytest.fixture
def compiles(monkeypatch):
    """Counts ``compile_program`` calls made through the plans."""
    import repro_torch.core.plan as plan_mod
    calls = []
    real = plan_mod.compile_program

    def counting(*args, **kwargs):
        calls.append(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(plan_mod, "compile_program", counting)
    return calls


@pytest.mark.parametrize("async_compile", [False, True])
def test_restart_compiles_nothing(tmp_path, compiles, async_compile):
    kw = dict(device="cpu", store=tmp_path / "s",
              async_compile=async_compile, **GEOM)
    cold = PlanService(**kw)
    first = _traffic(cold, 3)
    cold.close()
    assert len(compiles) == cold.stats.misses == 4
    assert cold.stats.store_hits == 0
    # only plans that land from the pool, or from the store, are prewarmed
    assert cold.stats.prewarms == cold.stats.async_compiles
    assert len(cold.store) == 4            # every miss was persisted
    compiles.clear()
    warm = PlanService(**kw)
    assert warm.prewarm                    # on with a store
    second = _traffic(warm, 3)
    warm.close()
    assert compiles == [], "the restarted service compiled"
    s = warm.stats
    assert s.store_hits == s.misses == 4 and s.prewarms == 4
    assert s.hits + s.misses == s.requests
    for a, b in zip(first, second):
        assert (a.kind, a.cycles, a.n_units, a.batch_units) == \
            (b.kind, b.cycles, b.n_units, b.batch_units)
        np.testing.assert_array_equal(np.asarray(a.result),
                                      np.asarray(b.result))


def test_env_default_store(tmp_path, monkeypatch):
    assert plan_store.STORE_ENV == "MATPIM_TORCH_PLAN_STORE"
    monkeypatch.setenv(plan_store.STORE_ENV, str(tmp_path / "env"))
    plan_store.reset_default_store()
    try:
        svc = PlanService(device="cpu", **GEOM)
        assert svc.store is not None and svc.store.path == tmp_path / "env"
        svc.submit("binary_matvec", np.ones((3, 9), int), np.ones(9, int))
        svc.flush()
        assert len(svc.store) == 1
        assert PlanService(device="cpu", store=False, **GEOM).store is None
        store = PlanStore(tmp_path / "other")
        assert PlanService(device="cpu", store=store, **GEOM).store is store
    finally:
        plan_store.reset_default_store()
