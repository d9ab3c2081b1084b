"""CPU tests of the benchmark's harness: finding pieces by name, the
traffic generator, the window's arithmetic, the trace's reduction, the
reference against the program at small sizes, and the import guard.

    python3 -m pytest -q bench/tests
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness, traffic  # noqa: E402

torch = pytest.importorskip("torch")

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab=512)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(name: str, dtype: str = "float32") -> dict:
    cfg = harness.config(name)
    cfg.update(SMALL, dtype=dtype)
    return cfg


def test_every_piece_of_every_cell_is_found_by_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cfg = harness.config(w["config"])
        mix = harness.mix(w["traffic"])
        assert callable(harness.driver(mix["driver"]).run)
        assert harness.limits(w["name"])
        assert callable(harness.reference(cfg["family"]).logits)
        assert harness.reported(bench["end_to_end"], w["name"])
        assert harness.reported(bench["per_layer"], w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric(m["name"]).read)
    for c in bench["configs"]:
        assert (ROOT / c["file"]) == harness.piece("configs", c["name"],
                                                   ".json")
    with pytest.raises(FileNotFoundError):
        harness.mix("no-such-mix")


def test_a_new_mix_in_a_copy_is_picked_up_with_no_edit(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "olmo-1b.short", "config": "olmo-1b",
                               "traffic": "short", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(harness.mix("chat"), prompt_len=[32, 64], output_len=[8, 8])
    (tmp_path / "bench" / "mixes" / "short.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "limits" / "olmo-1b.short.json").write_text(
        json.dumps({"gap_max": 1.0}))
    spec = importlib.util.spec_from_file_location(
        "bench_copy_harness", tmp_path / "bench" / "harness.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    cell = copy.cell(copy.benchmark(), "olmo-1b.short")
    got = copy.mix(cell["traffic"])
    assert got["prompt_len"] == [32, 64]
    assert copy.limits("olmo-1b.short") == {"gap_max": 1.0}
    assert copy.driver(got["driver"]).run
    reqs = traffic.requests(got, copy.config(cell["config"]), 5)
    assert all(32 <= len(next(reqs)[0]) <= 64 for _ in range(40))


@pytest.mark.parametrize("name,traffic_name", [("olmo-1b", "chat"),
                                               ("olmo-1b", "rag")])
def test_traffic_repeats_for_a_seed_and_keeps_its_lengths(name,
                                                           traffic_name):
    cfg, mix = harness.config(name), harness.mix(traffic_name)
    take = lambda seed, n: [next(g) for g in [traffic.requests(  # noqa
        mix, cfg, seed)] for _ in range(n)]
    a, b = take(2 ** 31 + 7, 100), take(2 ** 31 + 7, 100)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    c = take(2 ** 31 + 8, 100)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    k = mix["block"]
    block = sorted(traffic.lengths(mix))
    for reqs in (a, c):
        for i in range(0, len(reqs) - k + 1, k):
            got = sorted((len(p), n) for p, n in reqs[i:i + k])
            assert got == block
    lo, hi = mix["prompt_len"]
    olo, ohi = mix["output_len"]
    for p, n in a:
        assert lo <= len(p) <= hi and olo <= n <= ohi
        assert p.min() >= 0 and p.max() < cfg["vocab"]


def test_quantile_is_numpys_linear_quantile():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200):
        x = rng.normal(size=n).tolist()
        for q in (0.0, 0.5, 0.95, 1.0):
            assert math.isclose(harness.quantile(x, q),
                                float(np.quantile(x, q)), rel_tol=1e-12)
    assert harness.quantile([], 0.5) is None


def test_window_counts_only_what_arrived_in_it():
    drv = harness.driver("serve_closed_loop")
    recs = [{"sent": 0.0, "times": [0.5, 1.5, 2.5, 3.5]},
            {"sent": 1.2, "times": [1.4, 1.6]},
            {"sent": 2.9, "times": [3.3]}]
    got = drv.window_records(recs, 1.0, 3.0)
    assert got["tokens"] == 4                      # 1.5 2.5 1.4 1.6
    assert got["ttft_ms"] == pytest.approx([200.0])
    assert got["itl_ms"] == pytest.approx([1000.0, 1000.0, 200.0])
    assert got["attempted"] == 2
    rec = dict(got, window_s=2.0, kind="serve")
    assert harness.metric("tokens_per_s").read(rec) == 2.0
    assert harness.metric("ttft_p95_ms").read(rec) == pytest.approx(200.0)
    assert harness.metric("itl_p95_ms").read(rec) == pytest.approx(
        harness.quantile([1000.0, 1000.0, 200.0], 0.95))
    assert harness.metric("train_tokens_per_s").read(rec) is None
    rec.update(step_host_ms=[5.0, 7.0, 9.0], decode_ms=[4.0, 4.0, 4.0])
    assert harness.metric("engine_host_ms").read(rec) == 3.0
    # the traced stretch's flops over its kernels' busy time, not over
    # the window's 2 s on the host
    assert harness.metric("mfu.serve").read(rec) is None
    rec.update(trace={"busy_s": 0.02, "window_s": 0.05}, trace_flops=1e12,
               peak_flops=1e15)
    assert harness.metric("mfu.serve").read(rec) == pytest.approx(5.0)


def test_trace_reduction_unions_kernels_and_labels_idle_gaps():
    busy = harness.union([(0, 10), (5, 20), (30, 40), (35, 36), (50, 50)])
    assert busy == [[0, 20], [30, 40]]
    assert list(harness.gaps(busy, (0, 60))) == [(20, 30), (40, 60)]
    spans = [((0, 100), "bench.step"), ((25, 45), "bench.admit")]
    assert harness.host_label(spans, 30) == "bench.admit"
    assert harness.host_label(spans, 10) == "bench.step"
    assert harness.host_label(spans, 200) == "bench.other"
    idle = {"kind": "serve", "trace": {"busy_s": 3.0, "window_s": 4.0}}
    assert harness.metric("device_idle_share.serve").read(idle) == 25.0
    assert harness.metric("device_idle_share.train").read(idle) is None


def test_weights_repeat_for_a_seed_and_scale_by_a_layers_width():
    from repro_torch.models.lm import build_model
    cfg = small("olmo-1b", "bfloat16")
    specs = build_model(harness.model_config(cfg)).specs()
    a = harness.make_params(specs, cfg["dtype"], 2 ** 33 + 1, "cpu")
    b = harness.make_params(specs, cfg["dtype"], 2 ** 33 + 1, "cpu")
    c = harness.make_params(specs, cfg["dtype"], 2 ** 33 + 2, "cpu")
    wq = a["layers"]["sub0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape[0] == cfg["n_layers"]
    assert torch.equal(wq, b["layers"]["sub0"]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"]["sub0"]["attn"]["wq"])
    # a stacked leaf's fan-in is its layer's input width, not the layers;
    # attention's output reads every head; the tied table, the model width
    D, hd = cfg["d_model"], cfg["d_model"] // cfg["n_heads"]
    wo = a["layers"]["sub0"]["attn"]["wo"]
    for w, width in ((wq, D), (wo, cfg["n_heads"] * hd),
                     (a["embed"]["tok"], D),
                     (a["layers"]["sub0"]["mlp"]["wo"], cfg["d_ff"])):
        assert float(w.float().std()) == pytest.approx(1 / math.sqrt(width),
                                                       rel=0.1)
    assert a["final_norm"] == {}


def registry_cfg(name: str, **over) -> dict:
    """A configuration of the port's registry as a file holds it, cut to
    ``over``."""
    import dataclasses
    from repro_torch.configs.registry import REGISTRY
    return dict(dataclasses.asdict(REGISTRY[name]), **over)


def draw(cfg: dict, seed: int) -> dict:
    from repro_torch.models.lm import build_model
    specs = build_model(harness.model_config(cfg)).specs()
    return harness.make_params(specs, cfg["dtype"], seed, "cpu")


def test_expert_leaves_scale_by_their_own_input_width():
    # 32 experts of width 128 over a model width of 256: the experts axis
    # stacks them, as the layers axis does, and is no input width
    D, Ff = 256, 128
    cfg = registry_cfg("granite-moe-1b-a400m", n_layers=2, d_model=D,
                       d_ff=Ff, vocab=512, dtype="bfloat16")
    moe = draw(cfg, 7)["layers"]["sub0"]["moe"]
    assert moe["wi"].shape == (2, 32, D, 2, Ff)
    assert moe["router"].dtype == torch.float32
    for w, width in ((moe["wi"], D), (moe["wo"], Ff), (moe["router"], D)):
        assert float(w.float().std()) == pytest.approx(1 / math.sqrt(width),
                                                       rel=0.1)


def mixers(params) -> list:
    """Every Mamba-2 mixer's leaves in a tree of weights."""
    if not isinstance(params, dict):
        return []
    if "A_log" in params:
        return [params]
    return [m for k in sorted(params) for m in mixers(params[k])]


@pytest.mark.parametrize("name,over", [
    ("mamba2-370m", dict(n_layers=4, d_model=64, d_inner=128,
                         ssm_headdim=16, ssm_state=16, vocab=512)),
    ("jamba-1.5-large-398b", dict(n_layers=8, d_model=64, n_heads=4,
                                  n_kv_heads=2, head_dim=16, d_ff=128,
                                  n_experts=4, d_inner=128, ssm_headdim=16,
                                  vocab=512)),
])
def test_mamba2_A_and_dt_are_drawn_as_published(name, over):
    cfg = registry_cfg(name, dtype="bfloat16", **over)
    a, b, c = (draw(cfg, s) for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    ma, mb, mc = mixers(a), mixers(b), mixers(c)
    assert ma and len(ma) == len(mb) == len(mc)
    A = torch.cat([-torch.exp(m["A_log"]).flatten() for m in ma])
    dt = torch.cat([torch.nn.functional.softplus(m["dt_bias"]).flatten()
                    for m in ma])
    assert A.dtype == dt.dtype == torch.float32
    # A in [-16, -1], dt in [0.001, 0.1], both to float32's rounding
    assert float(A.min()) >= -16 * (1 + 1e-6)
    assert float(A.max()) <= -1 * (1 - 1e-6)
    assert float(dt.min()) >= 0.001 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    # spread over the ranges, not clustered at a zero's A = -1
    assert float(A.max() - A.min()) > 8 and float(dt.max() / dt.min()) > 10
    for x, y, z in zip(ma, mb, mc):
        for k in ("A_log", "dt_bias"):
            assert torch.equal(x[k], y[k]) and not torch.equal(x[k], z[k])


def digest(params, skip=()) -> str:
    """A checksum of every leaf's bytes and path, leaves whose path ends
    in one of ``skip`` left out."""
    import hashlib
    h = hashlib.sha256()

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        elif not any(path[-len(s):] == s for s in skip):
            h.update("/".join(path).encode())
            h.update(tree.contiguous().flatten().view(torch.uint8)
                     .numpy().tobytes())
    walk(params, ())
    return h.hexdigest()


@pytest.mark.parametrize("name,over,skip,want", [
    ("olmo-1b", SMALL, (),
     "2b6ce18d0d0fe637dd2cc7218b94f9238da0237a98a00f3c87e71caa4f8bd81a"),
    ("granite-moe-1b-a400m",
     dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
          vocab=512, n_experts=8, experts_per_tok=2),
     (("moe", "wi"), ("moe", "wo")),
     "78f3c6ef8b0cd39a16d3b0f82f435b6175b0b4532119c20d98bcba4cbd1bf731"),
    ("mamba2-370m",
     dict(n_layers=2, d_model=64, d_inner=128, ssm_headdim=32, ssm_state=16,
          vocab=512),
     (("mamba", "A_log"), ("mamba", "dt_bias")),
     "4205fa6ba0c8cdd849ae48f6c1c6c32ffd7ff2d1bf6b2dadf093f29671245daa"),
])
def test_other_leaves_are_drawn_as_before(name, over, skip, want):
    # checksums of the draws before the experts axis was stacked and
    # Mamba-2's A and dt were drawn: a dense model's weights and every
    # other leaf, the float32 router among them, are unchanged bit for bit
    cfg = (dict(harness.config(name), **over) if name == "olmo-1b"
           else registry_cfg(name, **over))
    cfg["dtype"] = "bfloat16"
    assert digest(draw(cfg, 2 ** 33 + 1), skip) == want


@pytest.mark.parametrize("name", ["olmo-1b"])
def test_reference_equals_the_program_in_float32(name):
    from repro_torch.models.lm import build_model
    cfg = small(name)
    model = build_model(harness.model_config(cfg))
    params = harness.make_params(model.specs(), "float32", 3, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg["vocab"], 64))
    with torch.no_grad():
        got = model.forward(params, {"tokens": toks[None]})[0][0]
        want = harness.reference(cfg["family"]).logits(cfg, params, toks)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def serve_ctx(name: str, traffic_name: str, limits: dict, dtype="float32"):
    mix = dict(harness.mix(traffic_name), clients=4, max_batch=4,
               max_seq=128, prompt_len=[16, 64], output_len=[4, 16],
               ramp_s=0.2, check_requests=3, block=8)
    return {"config": small(name, dtype), "mix": mix, "seed": 2 ** 31 + 5,
            "seconds": 0.5, "trace": False, "device": torch.device("cpu"),
            "t0": time.perf_counter(), "limits": limits}


@pytest.mark.parametrize("name", ["olmo-1b"])
def test_served_tokens_through_the_cache_match_the_reference(name):
    drv = harness.driver("serve_closed_loop")
    rec = drv.run(serve_ctx(name, "chat", {"gap_max": 1e-3}))
    assert rec["correct"] and rec["tokens"] > 0 and rec["sample"]
    assert rec["checks"]["gap_max"]["value"] <= 1e-3
    assert len(rec["decode_ms"]) == len(rec["step_host_ms"]) > 0
    assert len(rec["sample"]) == 3
    assert rec["peak_flops"] > 0


def test_no_source_reads_the_jax_package_or_its_benchmarks():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)\b"
                     r"|benchmarks/|BENCH_", re.M)
    for path in (ROOT / "bench").rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        assert not bad.search(path.read_text()), path


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert harness.foreign_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.foreign_modules() == ["jaxlib", "repro"]


def test_a_run_loads_no_foreign_module():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from bench import harness\n"
            "import bench.run\n"
            "from repro_torch.models.lm import build_model\n"
            "from repro_torch.serve.engine import Engine\n"
            "from repro_torch.train.train_step import make_train_step\n"
            "for kind, name in [('drivers', 'serve_closed_loop'),"
            " ('drivers', 'train_steps'), ('reference', 'dense')]:\n"
            "    harness.load_module(harness.piece(kind, name, '.py'))\n"
            "print(harness.foreign_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "olmo-1b.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "olmo-1b.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
