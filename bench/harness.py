"""Shared pieces of the benchmark: finding a cell's files by name, weights
and tokens from the seed, the statistics, the device trace's reduction and
the checks that guard a run.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric or reference is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``bench/configs/<config>.json``: the sizes as they are run;
* ``bench/mixes/<traffic>.json``: the mix's parameters, and ``driver``;
* ``bench/drivers/<driver>.py``: ``run(ctx) -> records``;
* ``bench/metrics/<metric>.py``: ``read(records) -> float | None``;
* ``bench/reference/<family>.py``: the plain float32 reference;
* ``bench/limits/<workload>.json``: the limits of the cell's checks.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# modules that may never be loaded by a run: the JAX stack and the JAX
# package the port was made from (compared by top-level name, whole)
FOREIGN = ("jax", "jaxlib", "flax", "repro")

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


# -- finding files by name ---------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the Python file at ``path`` under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    name = "bench_" + "_".join(path.relative_to(BENCH).with_suffix("")
                               .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def piece(kind: str, name: str, suffix: str) -> Path:
    """``bench/<kind>/<name><suffix>``; raises if it is not there."""
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} "
                                f"({path.relative_to(ROOT)})")
    return path


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(piece("configs", name, ".json"))


def mix(name: str) -> dict:
    return load_json(piece("mixes", name, ".json"))


def driver(name: str):
    return load_module(piece("drivers", name, ".py"))


def metric(name: str):
    return load_module(piece("metrics", name, ".py"))


def reference(family: str):
    return load_module(piece("reference", family, ".py"))


def limits(workload: str) -> dict:
    return load_json(piece("limits", workload, ".json"))


def reported(metrics: Sequence[dict], workload: str) -> List[dict]:
    """The metrics a cell reports: those that list it, or list none."""
    return [m for m in metrics
            if workload in m.get("workloads", [workload])]


# -- the system under test ----------------------------------------------------

def model_config(cfg: dict):
    """The program's ``ModelConfig`` holding the file's sizes (the file's
    other keys, such as its source, are for the reader and the
    reference)."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def make_params(specs, default_dtype: str, seed: int, device):
    """The weights of a spec tree, made on ``device`` from ``seed`` in the
    type they are served in: one ``torch.Generator`` draw per dtype for
    every normal leaf together, each leaf a view of it scaled by
    ``1/sqrt(fan_in)`` (:func:`fan_in`); zeros and ones as the spec says,
    but for Mamba-2's ``A_log`` and ``dt_bias``, drawn as published
    (:func:`ssm_init`). The same seed gives the same weights.

    The spec's own ``scale`` is not used: it puts the token table at 1.0,
    and a random model whose tied head reads a table at 1.0 repeats the
    token it was fed and ignores its context, so that no served token
    depends on the cache."""
    import torch
    from repro_torch.models.spec import torch_dtype
    leaves = _spec_leaves(specs)
    dtype = lambda s: torch_dtype(s.dtype or default_dtype)  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draws, at = {}, {}
    for dt in sorted({dtype(s) for s in leaves if s.init == "normal"},
                     key=str):
        n = sum(math.prod(s.shape) for s in leaves
                if s.init == "normal" and dtype(s) == dt)
        draws[dt] = torch.randn(n, generator=gen, dtype=dt, device=device)
        at[dt] = 0

    def make(s):
        dt = dtype(s)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        n = math.prod(s.shape)
        t = draws[dt][at[dt]:at[dt] + n].view(s.shape)
        at[dt] += n
        return t.mul_(1.0 / math.sqrt(max(fan_in(s), 1)))
    return ssm_init(_map_sorted(make, specs), seed, device)


# Mamba-2's published initialisation (``mamba_ssm/modules/mamba2.py``):
# A uniform in [1, 16], dt log-uniform in [0.001, 0.1]
A_RANGE = (1.0, 16.0)
DT_RANGE = (0.001, 0.1)
SSM_SEED = 0x5D5D_0A11       # set apart from the seed's own stream


def ssm_init(params, seed: int, device):
    """``params`` with every Mamba-2 mixer's ``A_log`` and ``dt_bias``
    drawn as published, in place of the spec's zeros: ``A_log = log A``
    and ``dt_bias = softplus⁻¹(dt) = dt + log(-expm1(-dt))``, so that a
    head keeps its state for ``1 / (A·dt)`` tokens, up to a thousand;
    zeros (A = 1, dt ≈ 0.7) halve it every token. The draws come from a
    generator of their own, seeded from ``seed``, leaf by leaf in the
    tree's sorted order, so that every other leaf is what it would be
    without them."""
    import torch
    leaves = [m for m in _dicts(params) if "A_log" in m and "dt_bias" in m]
    if not leaves:
        return params
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) + SSM_SEED) % 2 ** 64)
    for m in leaves:
        u = torch.rand((2,) + m["A_log"].shape, generator=gen,
                       dtype=torch.float64, device=device)
        lo, hi = A_RANGE
        a = lo + (hi - lo) * u[0]
        lo, hi = (math.log(x) for x in DT_RANGE)
        dt = torch.exp(lo + (hi - lo) * u[1])
        m["A_log"] = torch.log(a).to(m["A_log"].dtype)
        m["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(
            m["dt_bias"].dtype)
    return params


def _dicts(tree) -> list:
    """Every dict of a tree of dicts, itself first, keys sorted."""
    if not isinstance(tree, dict):
        return []
    return [tree] + [d for k in sorted(tree) for d in _dicts(tree[k])]


# axes that stack copies of a weight, each with its own input width
STACKED = ("layers", "experts")


def fan_in(spec) -> int:
    """A weight's input width, from its logical axes, the ``layers`` and
    ``experts`` that stack it left out (an expert's ``wi`` reads the
    model's width, its ``wo`` the expert's width): a token table's
    ``embed`` width (the table is also the tied head, which reads the
    model's width); a projection from the model's width (first axis
    ``embed``) its first dim; any other, such as attention's output
    ``(heads, head_dim, embed)``, the product of all dims but the last.
    The program's own ``init_params`` takes the first dim of a stacked
    leaf, the layer count, which leaves its weights ``sqrt(width /
    layers)`` times a unit variance init (11x for olmo-1b) and its
    attention a hard argmax."""
    dims = [(n, a) for n, a in zip(spec.shape, spec.axes)
            if a not in STACKED]
    axes = [a for _, a in dims]
    if "vocab" in axes:
        return dims[axes.index("embed")][0]
    if axes and axes[0] == "embed":
        return dims[0][0]
    return math.prod(n for n, _ in dims[:-1])


def _spec_leaves(tree) -> list:
    """The specs of a tree of dicts, keys sorted."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


def _map_sorted(fn, tree):
    """``fn`` of every leaf of a tree of dicts, visited keys sorted (the
    order of :func:`_spec_leaves`), keeping the tree's structure."""
    if isinstance(tree, dict):
        out = {k: _map_sorted(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn(tree)


# -- set-up -------------------------------------------------------------------

def setup_parts(t0: float, marks: Sequence[Tuple[str, float]]) -> dict:
    """Seconds of each part of a run's set-up: ``marks`` are ``(part, the
    host time it ended)`` in order, from the process's start ``t0``."""
    out, at = {}, t0
    for name, t in marks:
        out[f"{name}_s"] = t - at
        at = t
    return out


def cuda_ready(device) -> None:
    """Create the device's context now, so that set-up reads it apart."""
    import torch
    if device.type == "cuda":
        torch.empty(0, device=device)
        torch.cuda.synchronize(device)


# -- statistics ---------------------------------------------------------------

def quantile(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q`` quantile of ``values``, interpolated linearly between the
    order statistics (numpy's default); ``None`` for no values."""
    xs = sorted(values)
    if not xs:
        return None
    at = q * (len(xs) - 1)
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def median(values: Iterable[float]) -> Optional[float]:
    return quantile(values, 0.5)


# -- the device trace ---------------------------------------------------------

NAME_CHARS = 160      # a kernel's name is cut to this many characters


class Tracer:
    """``torch.profiler`` over a stretch of a run, with the benchmark's own
    host spans (``span(name)``) in it. Outside a stretch every span is a
    no-op."""

    WINDOW = "bench.window"

    def __init__(self):
        self.prof = None

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def stretch(self, device):
        """Profile the body; the device is synchronised at both ends."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=acts) as prof:
            self.prof = prof
            with torch.profiler.record_function(self.WINDOW):
                yield
                torch.cuda.synchronize(device)
        self.prof = None
        self.events = prof.events()

    def summary(self, top: int = 10) -> dict:
        """From the last stretch: the traced window's length, the seconds
        in which a kernel ran, the kernels with the most time, and the idle
        time of the device summed by the innermost host span of the
        benchmark's that was open when each gap began."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        kernels, spans, window = [], [], None
        for e in self.events:
            tr = (e.time_range.start, e.time_range.end)
            if e.name.startswith("bench."):
                # the host's spans; their copies on the device are no kernel
                if e.device_type == cuda:
                    continue
                if e.name == self.WINDOW:
                    window = tr
                else:
                    spans.append((tr, e.name))
            elif e.device_type == cuda:
                kernels.append((tr, e.name))
        if window is None or not kernels:
            return {}
        busy = union([(max(a, window[0]), min(z, window[1]))
                      for (a, z), _ in kernels if z > window[0]
                      and a < window[1]])
        by_name: Dict[str, float] = {}
        for (a, z), n in kernels:
            n = n[:NAME_CHARS]
            by_name[n] = by_name.get(n, 0.0) + (z - a) / 1e6
        idle: Dict[str, float] = {}
        for a, z in gaps(busy, window):
            label = host_label(spans, a)
            idle[label] = idle.get(label, 0.0) + (z - a) / 1e6
        busy_s = sum(z - a for a, z in busy) / 1e6
        return {"busy_s": busy_s, "window_s": (window[1] - window[0]) / 1e6,
                "device_ops": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(idle.items(),
                                    key=lambda kv: -kv[1])[:top]}


def union(intervals: Iterable[Tuple[float, float]]) -> List[list]:
    """The union of ``(start, end)`` intervals, as sorted disjoint
    ``[start, end]`` pairs (``launch/train_profile.py::busy_ms``'s
    sweep)."""
    out: List[list] = []
    for a, z in sorted(intervals):
        if z <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return out


def gaps(busy: List[list], window: Tuple[float, float]):
    """The stretches of ``window`` that ``busy`` (sorted, disjoint) leaves
    uncovered."""
    at = window[0]
    for a, z in busy:
        if a > at:
            yield at, a
        at = max(at, z)
    if window[1] > at:
        yield at, window[1]


def host_label(spans: List[tuple], t: float) -> str:
    """The name of the innermost span open at time ``t`` (the latest to
    start of those that cover it), ``"bench.other"`` if none is."""
    best = None
    for (a, z), name in spans:
        if a <= t < z and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else "bench.other"


# -- guards -------------------------------------------------------------------

def foreign_modules() -> List[str]:
    """The top-level names of loaded modules that a run may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FOREIGN))


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions, restored after."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def device_info(device, count: int) -> dict:
    """What the result line says of the device; the peak of allocated
    memory is read by the driver once its window has closed."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# -- controls -----------------------------------------------------------------

FP8_MAX = 448.0       # the largest finite float8_e4m3fn


def fp8_matmul(a, b):
    """``a @ b`` with both operands rounded to float8 (e4m3, one scale per
    operand that maps its largest magnitude to the format's largest) and
    the products summed in float32: the reference computed in the nearest
    precision below bfloat16, the control of a bfloat16 configuration.
    Under autograd the products of the backward take the rounded
    operands too."""
    import torch

    def fp8(t):
        # a rounded operand passes its gradient straight through, as in
        # fp8 training (a cast back from float8 would round the gradient)
        with torch.no_grad():
            s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
            q = (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
        return t + (q - t).detach() if t.requires_grad else q
    return fp8(a) @ fp8(b)
