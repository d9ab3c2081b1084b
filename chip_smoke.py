"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``; imports nothing of JAX or of the reference package. Phases,
each printing one JSON line per record:

1. build   — compile every CUDA source of the port (one ``nvcc`` each, all
             started together) and print the build seconds and ptxas report;
             read the card's integer rates at the max SM clock
             ``nvidia-smi`` reports: XOR and add at 64 per SM per clock,
             population count at 16.
2. kernels — every kernel against its plain PyTorch version on the card, at
             the main path's shape (integer-valued inputs: exact, tolerance
             0) and at the reference's test shapes (float inputs, the
             reference's tolerances), for the float convs at shapes that
             stress the redesigned tiling (1000 small images, a 514×514
             image with 256×256 reference tiles, odd widths, kh ≠ kw, bf16,
             5×5 kernels whose halo tiles are staged), for the two matvec
             kernels at the other served buckets, a bf16/f32 mix, an M that
             is not a multiple of the plan's rows a CTA and views at odd
             offsets, and for binary_conv2d at two images far above the
             launch floor (514×514×256 and 258×258×1024, k 3), 25 taps on
             260×260×256, 3-word rows and the ops path's image at 1 and 3
             words off 16 bytes, each also timed under the other staging
             choices of its plan (record ``bconv_modes``);
             the compared call's launch count; kernel, plain and library
             times from CUDA events — per call, and for the kernel and the
             library also per launch replayed from a CUDA graph, without the
             host — and the bound, the largest of the bytes' time (3.35
             TB/s) and each kind of operations' time (float multiply-adds as
             2 flops at 67 TFLOP/s; XOR and add at the INT32 rate,
             population count at the popcount rate). The library call is a
             yardstick the port never calls: ``torch.matmul`` of the unpacked
             ±1 operands (binary_matmul), ``torch.mv`` / ``torch.matmul``
             (splitk_matvec), ``F.conv2d`` with ``groups=B`` (the convs) and
             ``F.conv2d`` of the unpacked ±1 floats (binary_conv2d); TF32 is
             off for both matmul and cuDNN. For ``conv2d_shift``,
             ``splitk_matvec`` and ``binary_matmul`` at their served shapes
             and ``binary_conv2d`` at the ops path's, also the host time of
             each step of the wrapper (records ``conv_host``,
             ``matvec_host`` and ``bconv_host``; ``time.perf_counter_ns``
             over 10⁴ calls each).
3. engine  — ``BinaryMatvecPlan(1024, 416)`` (565 cycles) at B ∈ {1, 20,
             33}, ``MatvecPlan(1024, 39, 8)`` (9474 cycles) at B ∈ {1, 27},
             ``ConvPlan(64, 8, 3, 8)`` (9800 cycles; one kernel per
             instance) at B ∈ {1, 63}, and ``BinaryConvPlan(64, 64, 3)``
             (515 cycles) and ``(128, 64, 5)`` (1818) at B ∈ {1, 33}, on
             ``torch-fused``, ``torch-unfused`` and ``kernels`` (binary conv:
             labelled ``kernels:fallback-torch``): all decode identically
             and equal the numpy oracle (``sign(A @ x)``, ``A @ x mod
             2^16``, the correlation mod 2^8, the sign of the ±1
             correlation). Wall times of a first and a warm run.
4. serve   — the slice's path: ``PlanService(device="cuda")`` at the
             paper's 1024×1024 geometry on ``backend="kernels"`` and
             ``"torch"``, one flush of ±1 matvec (4096×2048, 1024×384,
             300×500), 8-bit matvec (1024×1024, 300×500), a 16-bit matvec
             (256×256, over the kernels' f32 bound: labelled
             ``kernels:fallback-torch`` on the kernels service), 8-bit
             conv (two 128×128 with distinct kernels: one plan, one batch;
             100×60) and ±1 binary conv (two 128×128 with one 3×3 kernel:
             one plan, one batch; 100×60 with a 5×5 kernel; labelled
             ``kernels:fallback-torch`` on the kernels service) requests.
             Launch counts are zeroed just before the kernels service runs
             and read just after. Every ticket must equal its numpy oracle,
             with the tiles, cycles and reduce depth the reference gives.
   serve_auto_store — the same requests on ``PlanService(backend="auto",
             store=<tmp dir>, tunings=TuningTable(<tmp file>))``: a cold
             flush (plans compiled and stored, each bucket tuned inline), a
             warm one, a cold one on a fresh service over the same store and
             file (every plan loaded from the store: ``compile_program``,
             counted by a wrapper installed here, runs zero times), and one
             on an ``async_compile=True`` service. Buckets the kernels
             compute must resolve to ``auto:kernels``, the 16-bit matvec and
             the binary convs off it; the three kernels' launch counts,
             zeroed just before the first service and read after its warm
             flush, must rise. One record: each flush's wall, compiles, span
             totals and labels, the services' stats.
5. ops     — ``kernels.ops`` on CUDA tensors: ``matvec``, ``conv2d``,
             ``conv2d(tiled=True)``, ``conv2d_binary`` and ``binary_dense``
             each equal their plain versions exactly, and raise their
             kernels' launch counts, zeroed just before and read just after.

Then the per-kernel summary line ``{"kernels": [...]}`` (``launches`` from
the serve phase for binary_matmul, splitk_matvec and conv2d_shift, from the
ops phase for conv2d_shift_tiled and binary_conv2d; the other numbers from
each kernel's main-path row, ``library_graph_ms`` the library yardstick
replayed from a CUDA graph), the card's name and power limit from
``nvidia-smi``, and the last line ``{"ok": true, "device": {...}}``. Any
failed check raises: the script exits non-zero and prints no result line.
Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet rates: HBM bandwidth, and the 67 TFLOP/s float32 rate
# outside the tensor cores (an FMA counted as two flops). Integer work is
# counted per SM per clock at the card's max SM clock (int_rates): 32-bit
# XOR and add at 64, population count at 16 (the CUDA C++ Programming
# Guide's arithmetic-instruction throughput table, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT32_OPS_PER_SM_CLOCK = 64
POPC_PER_SM_CLOCK = 16

RECORDS = []


def emit(phase: str, **kw) -> None:
    rec = {"phase": phase, **kw}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, trials: int = 21, per_trial: int = 20) -> float:
    """Median over ``trials`` of CUDA-event time for ``per_trial``
    back-to-back calls, per call (warmed up first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_trial):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_trial)
    return float(np.median(times))


def graph_ms(torch, fn, trials: int = 21, per_graph: int = 20) -> float:
    """Device time per call with the host out of the way: ``per_graph``
    calls captured in one CUDA graph, median over ``trials`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(torch, graph.replay, trials=trials, per_trial=1) \
        / per_graph


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    check(bool(out), f"nvidia-smi printed nothing for {query}")
    return out


def int_rates(torch) -> dict:
    """The card's integer rates, per second: XOR and add (``int32``, 64
    per SM per clock) and population count (``popc``, 16), × SMs × the max
    SM clock ``nvidia-smi`` reports."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"int32": INT32_OPS_PER_SM_CLOCK * sms * mhz * 1e6,
             "popc": POPC_PER_SM_CLOCK * sms * mhz * 1e6}
    emit("rates", sms=sms, max_sm_clock_mhz=mhz,
         int32_ops_per_s=rates["int32"], popc_per_s=rates["popc"],
         f32_flops_per_s=F32_FLOPS_PER_S, hbm_bytes_per_s=HBM_BYTES_PER_S)
    return rates


def xnor_work(rates, outputs: int, words: int) -> list:
    """The operations of ``outputs`` ±1 dot products over ``words`` words
    each: an XOR and an add per word and one epilogue op per output at the
    INT32 rate, a population count per word at the popcount rate."""
    return [(outputs * (2 * words + 1), rates["int32"]),
            (outputs * words, rates["popc"])]


def phase_build() -> None:
    from repro_torch import kernels
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = dict(zip(sources, pool.map(kernels.build, sources)))
    seconds = time.perf_counter() - t0
    for src in sources:
        kernels.load_library(src)
    emit("build", sources=sources, seconds=seconds,
         ptxas={s: [ln for ln in logs[s].splitlines() if "ptxas" in ln]
                for s in sources})


def kernel_row(torch, name, shape, kernel, plain, library, args, nbytes,
               work, tol=None, counter=None):
    """Run ``kernel`` once against ``plain`` on the same CUDA inputs (exact
    when ``tol`` is None, else ``(rtol, atol)``), then time the kernel, its
    CUDA graph replay, the plain version and the library yardstick, per
    call and replayed from a CUDA graph. ``work`` lists ``(operations,
    rate per second)``: the bound is the largest of the bytes' time and
    each kind of operations' time.
    ``counter`` is the wrapper that counts launches (``kernel`` itself
    unless that is a closure around it)."""
    counter = counter or kernel
    counter.launches = 0
    got = kernel(*args)
    launches = counter.launches
    want = plain(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {shape}: {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if tol is None:
        check(torch.equal(got, want), f"{name} != plain at {shape}")
    else:
        rtol, atol = tol
        check(bool((diff <= atol + rtol * want.double().abs()).all()),
              f"{name} outside rtol {rtol} atol {atol} at {shape}: "
              f"max abs err {err}")
    check(launches == 1, f"{name} launched {launches} times for one call")
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(ops / rate for ops, rate in work) * 1e3
    row = {
        "shape": shape, "max_abs_err": err,
        "tolerance": 0 if tol is None else {"rtol": tol[0], "atol": tol[1]},
        "launches": launches,
        "ms": cuda_ms(torch, lambda: kernel(*args)),
        "graph_ms": graph_ms(torch, lambda: kernel(*args)),
        "plain_ms": cuda_ms(torch, lambda: plain(*args)),
        "library_ms": cuda_ms(torch, library),
        "library_graph_ms": graph_ms(torch, library),
        "bytes": nbytes, "ops": [ops for ops, _ in work],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit("kernels", kernel=name, **row)
    return row


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def at_offset(torch, t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` elements past a
    16-byte boundary (a view into a larger buffer)."""
    flat = t.new_empty(offset + t.numel())
    flat[offset:] = t.reshape(-1)
    view = flat[offset:].view(t.shape)
    check(view.data_ptr() % 16 == offset * t.element_size() % 16
          and torch.equal(view, t), "at_offset")
    return view


def binary_operands(torch, seed, B, M, N, Kw):
    """±1 floats A (M, 32·Kw) and B (N, 32·Kw), with a leading batch axis
    when B > 0, and their packed words."""
    from repro_torch.kernels.ref import pack_bits
    rng = np.random.default_rng(seed)
    lead = (B,) if B else ()
    af = torch.from_numpy(rng.choice([-1.0, 1.0], size=lead + (
        M, 32 * Kw)).astype(np.float32)).cuda()
    bf = torch.from_numpy(rng.choice([-1.0, 1.0], size=lead + (
        N, 32 * Kw)).astype(np.float32)).cuda()
    return af, bf, pack_bits(af), pack_bits(bf)


def rows_binary_matmul(torch, rates):
    from repro_torch.kernels.binary_matmul import (binary_matmul,
                                                   binary_matmul_plain)
    # (B, M, N, Kw, word offset of A): the main path's shape first — 20
    # tiles of 1024 rows, one 416-bit x per tile packed to 13 words — then
    # the reference test shapes (M, N, K) = (8, 8, 32), (128, 128, 256),
    # (64, 256, 512); the other two served buckets (1024×384 and 300×500 ±1
    # requests), an M that is not a multiple of the plan's 128 rows a CTA,
    # and the main path's A at an odd word offset
    rows = []
    for i, (B, M, N, Kw, off) in enumerate([
            (20, 1024, 1, 13, 0), (0, 8, 8, 1, 0), (0, 128, 128, 8, 0),
            (0, 64, 256, 16, 0), (2, 1024, 1, 13, 0), (2, 512, 1, 13, 0),
            (20, 1000, 1, 13, 0), (20, 1024, 1, 13, 1)]):
        af, bf, ap, bp = binary_operands(torch, i, B, M, N, Kw)
        if off:
            ap = at_offset(torch, ap, off)
        dense = torch.matmul(af, bf.transpose(-1, -2)).to(torch.int32)
        check(torch.equal(binary_matmul(ap, bp), dense),
              f"binary_matmul != the dense ±1 product at {(B, M, N, Kw)}")
        nb = max(B, 1)
        rows.append(kernel_row(
            torch, "binary_matmul",
            [B, M, N, Kw] + ([f"offset {off}"] if off else []),
            binary_matmul, binary_matmul_plain,
            lambda af=af, bf=bf: torch.matmul(af, bf.transpose(-1, -2)),
            (ap, bp), _nbytes(ap, bp, dense), xnor_work(rates, nb * M * N, Kw)))
    return rows


def rows_splitk(torch):
    from repro_torch.kernels.splitk_matvec import (splitk_matvec,
                                                   splitk_matvec_plain)
    g = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    # the served shape: 27 tiles of MatvecPlan(1024, 39, 8), 8-bit integers
    # in float32 (the bridge's exact case)
    a = torch.randint(0, 256, (27, 1024, 39), generator=g,
                      device="cuda").float()
    x = torch.randint(0, 256, (27, 39), generator=g, device="cuda").float()
    cases = [([27, 1024, 39, "f32"], a, x, None)]
    for M, K, dt in [(256, 512, torch.float32), (512, 1024, torch.bfloat16),
                     (1024, 4096, torch.bfloat16), (256, 2048, torch.float32)]:
        bf16 = dt == torch.bfloat16
        cases.append(([0, M, K, "bf16" if bf16 else "f32"],
                      torch.randn((M, K), generator=g, device="cuda").to(dt),
                      torch.randn((K,), generator=g, device="cuda").to(dt),
                      (2e-2, 0.5) if bf16 else (1e-5, 1e-3)))

    def ints(shape, hi=256, dtype=torch.float32):
        return torch.randint(0, hi, shape, generator=g,
                             device="cuda").to(dtype)

    # the 300×500 request's bucket (14 tiles of 512 rows); a bf16 A with an
    # f32 x at K 39 (8-bit integers are exact in bf16); an M that is not a
    # multiple of the plan's 128 rows a CTA; odd-offset views of the served
    # shape (short rows) and of a long-row shape
    cases += [
        ([14, 512, 39, "f32"], ints((14, 512, 39)), ints((14, 39)), None),
        ([27, 1024, 39, "bf16 a, f32 x"], ints((27, 1024, 39),
                                               dtype=torch.bfloat16),
         ints((27, 39)), None),
        ([27, 1000, 39, "f32"], ints((27, 1000, 39)), ints((27, 39)), None),
        ([27, 1024, 39, "f32 offset 1"],
         at_offset(torch, ints((27, 1024, 39)), 1),
         at_offset(torch, ints((27, 39)), 3), None),
        ([0, 1024, 4096, "bf16 offset 3"],
         at_offset(torch, ints((1024, 4096), 16, torch.bfloat16), 3),
         at_offset(torch, ints((4096,), 16, torch.bfloat16), 1), None)]
    for shape, a, x, tol in cases:
        y = a[..., 0].float()
        # torch.matmul takes one dtype: the mix's x as bf16 (its 8-bit
        # integers are exact there)
        xl = x.to(a.dtype)
        lib = ((lambda a=a, x=xl: torch.matmul(a, x[..., None]))
               if a.ndim == 3 else (lambda a=a, x=xl: torch.mv(a, x)))
        rows.append(kernel_row(
            torch, "splitk_matvec", shape, splitk_matvec,
            splitk_matvec_plain, lib, (a, x),
            _nbytes(a, x, y), [(2 * a.numel(), F32_FLOPS_PER_S)], tol))
    return rows


def _grouped_conv(torch, a, k):
    """The library yardstick: F.conv2d over B images as B groups."""
    import torch.nn.functional as F
    a4 = a.reshape((1, -1) + tuple(a.shape[-2:]))
    B = a4.shape[1]
    k4 = (k if k.ndim == 3 else k[None].expand(B, -1, -1)).reshape(
        (B, 1) + tuple(k.shape[-2:])).to(a.dtype)
    return lambda: F.conv2d(a4, k4, groups=B)


def per_call_us(torch, fn, calls: int = 10_000) -> float:
    """Host µs per call of ``fn`` over ``calls`` back-to-back calls (after
    200 warm-up calls; the device is idle before and synced after)."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def host_steps(torch, wrapper, module, signature, a, b, library) -> dict:
    """Host µs per call of each step the ``module.<wrapper>`` wrapper makes
    on CUDA operands (``kernels.launch``; ``signature`` its cached
    signature lookup), alone, beside the whole call and the library
    yardstick."""
    from repro_torch import kernels
    sig = signature()
    entry = kernels.entry(module.SOURCE, module.SYMBOL)
    out = a.new_empty(sig.out_shape, dtype=sig.out_dtype)
    stream = torch.cuda.current_stream(0).cuda_stream
    before = wrapper.launches
    steps = {
        "signature": signature,
        "device_checks": lambda: (a.is_cuda and b.is_cuda
                                  and b.get_device() == a.get_device()
                                  and a.is_contiguous()
                                  and b.is_contiguous()),
        "current_device":
            lambda: a.get_device() != torch.cuda.current_device(),
        "new_empty": lambda: a.new_empty(sig.out_shape, dtype=sig.out_dtype),
        "stream": lambda: torch.cuda.current_stream(0).cuda_stream,
        "data_ptrs": lambda: (a.data_ptr(), b.data_ptr(), out.data_ptr()),
        "ctypes_launch": lambda: entry(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), sig.args_addr, stream),
        "call": lambda: wrapper(a, b),
        "library": library,
        "loop": lambda: None,
    }
    us = {n: per_call_us(torch, fn) for n, fn in steps.items()}
    wrapper.launches = before
    return us


def conv_host_steps(torch, a, k) -> None:
    """Host time of each step the ``conv2d_shift`` wrapper makes on CUDA
    operands, at the served shape."""
    from repro_torch.kernels import conv2d_shift as cs
    emit("conv_host", kernel="conv2d_shift", shape=list(a.shape),
         us_per_call=host_steps(
             torch, cs.conv2d_shift, cs,
             lambda: cs._signature("conv2d_shift", a.shape, k.shape, a.dtype,
                                   k.dtype, None),
             a, k, _grouped_conv(torch, a, k)))


def matvec_host_steps(torch) -> None:
    """Host time of each step of the ``splitk_matvec`` and
    ``binary_matmul`` wrappers at their served shapes (27×1024×39 f32 and
    20×1024×13 words against one x each), in one record."""
    from repro_torch.kernels import binary_matmul as bm
    from repro_torch.kernels import splitk_matvec as sm
    g = torch.Generator(device="cuda").manual_seed(13)
    a = torch.randint(0, 256, (27, 1024, 39), generator=g,
                      device="cuda").float()
    x = torch.randint(0, 256, (27, 39), generator=g, device="cuda").float()
    af, bf, ap, bp = binary_operands(torch, 14, 20, 1024, 1, 13)
    emit("matvec_host", shapes={"splitk_matvec": [27, 1024, 39],
                                "binary_matmul": [20, 1024, 1, 13]},
         us_per_call={
             "splitk_matvec": host_steps(
                 torch, sm.splitk_matvec, sm,
                 lambda: sm._signature(a.shape, x.shape, a.dtype, x.dtype),
                 a, x, lambda: torch.matmul(a, x[..., None])),
             "binary_matmul": host_steps(
                 torch, bm.binary_matmul, bm,
                 lambda: bm._signature(ap.shape, bp.shape, ap.dtype,
                                       bp.dtype),
                 ap, bp, lambda: torch.matmul(af, bf.transpose(-1, -2)))})


def rows_conv(torch):
    from repro_torch.kernels.conv2d_shift import (conv2d_shift,
                                                  conv2d_shift_plain)
    g = torch.Generator(device="cuda").manual_seed(11)
    # the served shape: 126 tiles of ConvPlan(64, 8, 3, 8), one kernel each
    a = torch.randint(0, 256, (126, 64, 8), generator=g,
                      device="cuda").float()
    k = torch.randint(0, 256, (126, 3, 3), generator=g,
                      device="cuda").float()
    cases = [([126, 64, 8, 3, "f32"], a, k, None)]
    for H, W, kk, dt in [(32, 32, 3, torch.float32), (64, 48, 5,
                                                      torch.float32),
                         (33, 31, 3, torch.bfloat16),
                         (128, 128, 3, torch.bfloat16)]:
        bf16 = dt == torch.bfloat16
        cases.append(([0, H, W, kk, "bf16" if bf16 else "f32"],
                      torch.randn((H, W), generator=g, device="cuda").to(dt),
                      torch.randn((kk, kk), generator=g,
                                  device="cuda").to(dt),
                      (3e-2, 0.5) if bf16 else (1e-5, 1e-5)))
    # the redesigned tiling: many small images per launch, an odd width,
    # kh != kw with per-image bf16 kernels
    cases += [
        ([1000, 64, 8, 3, "f32"],
         torch.randint(0, 256, (1000, 64, 8), generator=g,
                       device="cuda").float(),
         torch.randint(0, 256, (1000, 3, 3), generator=g,
                       device="cuda").float(), None),
        ([0, 1026, 1027, 3, "f32"],
         torch.randint(0, 16, (1026, 1027), generator=g,
                       device="cuda").float(),
         torch.randint(0, 16, (3, 3), generator=g, device="cuda").float(),
         None),
        ([8, 130, 68, "2x5", "bf16"],
         torch.randn((8, 130, 68), generator=g,
                     device="cuda").to(torch.bfloat16),
         torch.randn((8, 2, 5), generator=g,
                     device="cuda").to(torch.bfloat16), (3e-2, 0.5))]
    # kernels of more than 3×3 taps stage halo tiles with cp.async: rows
    # 16-byte aligned (1028 f32) and 4-byte aligned (1027 f32)
    for W in (1028, 1027):
        cases.append((
            [0, 1028, W, 5, "f32"],
            torch.randint(0, 16, (1028, W), generator=g,
                          device="cuda").float(),
            torch.randint(0, 16, (5, 5), generator=g, device="cuda").float(),
            None))
    rows = []
    for shape, a, k, tol in cases:
        kh, kw = k.shape[-2:]
        out = conv2d_shift_plain(a, k)
        rows.append(kernel_row(
            torch, "conv2d_shift", shape, conv2d_shift, conv2d_shift_plain,
            _grouped_conv(torch, a, k), (a, k), _nbytes(a, k, out),
            [(2 * out.numel() * kh * kw, F32_FLOPS_PER_S)], tol))
    conv_host_steps(torch, *cases[0][1:3])
    return rows


def rows_tiled(torch):
    from repro_torch.kernels.conv2d_shift import (conv2d_shift_tiled,
                                                  conv2d_shift_tiled_plain)
    g = torch.Generator(device="cuda").manual_seed(12)
    # (label, a, k, (bh, bw), tolerance): the ops path's shape first — a
    # 1026×1026 image, 3×3 taps, the default 128×128 reference tiles
    cases = [([1026, 1026, 3, 128, 128],
              torch.randint(0, 16, (1026, 1026), generator=g,
                            device="cuda").float(),
              torch.randint(0, 16, (3, 3), generator=g,
                            device="cuda").float(), (128, 128), None)]
    for H, W, k, bh, bw in [(66, 66, 3, 32, 32), (131, 67, 4, 64, 32)]:
        cases.append(([H, W, k, bh, bw],
                      torch.randn((H, W), generator=g, device="cuda"),
                      torch.randn((k, k), generator=g, device="cuda"),
                      (bh, bw), (1e-5, 1e-5)))
    # 256×256 reference tiles (a 266 KB halo tile, once refused), an odd
    # bf16 width, kh != kw, and a batch of bf16 images with per-image f32
    # kernels
    cases += [
        ([514, 514, 3, 256, 256],
         torch.randint(0, 16, (514, 514), generator=g,
                       device="cuda").float(),
         torch.randint(0, 16, (3, 3), generator=g, device="cuda").float(),
         (256, 256), None),
        ([1026, 1027, 3, 128, 205, "bf16"],
         torch.randint(0, 16, (1026, 1027), generator=g,
                       device="cuda").to(torch.bfloat16),
         torch.randint(0, 16, (3, 3), generator=g,
                       device="cuda").to(torch.bfloat16), (128, 205), None),
        ([129, 132, "2x5", 64, 32],
         torch.randn((129, 132), generator=g, device="cuda"),
         torch.randn((2, 5), generator=g, device="cuda"), (64, 32),
         (1e-5, 1e-5)),
        ([4, 66, 66, 3, 32, 32, "bf16 a, f32 k"],
         torch.randn((4, 66, 66), generator=g,
                     device="cuda").to(torch.bfloat16),
         torch.randn((4, 3, 3), generator=g, device="cuda"), (32, 32),
         (3e-2, 0.5)),
        # staged halo tiles (5×5 taps) of bf16 rows only 2-byte aligned
        ([1028, 1029, 5, 128, 205, "bf16"],
         torch.randint(0, 16, (1028, 1029), generator=g,
                       device="cuda").to(torch.bfloat16),
         torch.randint(0, 16, (5, 5), generator=g,
                       device="cuda").to(torch.bfloat16), (128, 205), None)]
    rows = []
    for shape, a, k, (bh, bw), tol in cases:
        kh, kw = k.shape[-2:]
        out = conv2d_shift_tiled_plain(a, k, bh, bw)
        rows.append(kernel_row(
            torch, "conv2d_shift_tiled", shape,
            lambda a, k, bh=bh, bw=bw: conv2d_shift_tiled(a, k, bh, bw),
            lambda a, k, bh=bh, bw=bw: conv2d_shift_tiled_plain(a, k, bh,
                                                                bw),
            _grouped_conv(torch, a, k), (a, k), _nbytes(a, k, out),
            [(2 * out.numel() * kh * kw, F32_FLOPS_PER_S)], tol,
            counter=conv2d_shift_tiled))
    return rows


def bconv_host_steps(torch, a, k, a4, k4) -> None:
    """Host time of each step the ``binary_conv2d`` wrapper makes on CUDA
    operands, at the ops path's shape (``a4``, ``k4``: the ±1 floats of the
    ``F.conv2d`` yardstick)."""
    import torch.nn.functional as F
    from types import SimpleNamespace

    from repro_torch.kernels import conv2d_shift as cs
    emit("bconv_host", kernel="binary_conv2d", shape=list(a.shape),
         us_per_call=host_steps(
             torch, cs.binary_conv2d,
             SimpleNamespace(SOURCE=cs.SOURCE, SYMBOL=cs.BINARY_SYMBOL),
             lambda: cs._binary_signature(a.shape, k.shape, a.dtype,
                                          k.dtype),
             a, k, lambda: F.conv2d(a4, k4)))


# binary_conv2d's plan knobs for bconv_modes: each launch with its halo
# tiles read through L1, or staged in shared memory; row reuse whatever the
# CTA count
BCONV_MODES = {"direct": {"BCONV_STAGE_TAPS": 1 << 40},
               "staged": {"BCONV_STAGE_TAPS": 0},
               "reuse": {"BCONV_MIN_CTAS": 1, "BCONV_STAGE_TAPS": 1 << 40},
               "reuse staged": {"BCONV_MIN_CTAS": 1, "BCONV_STAGE_TAPS": 0}}


def bconv_modes(torch, shape, a, k, want) -> None:
    """Graph time of ``binary_conv2d`` under its plan and under each
    alternative of ``BCONV_MODES`` (each checked against the plain
    version), so the plan's choice of staging stands beside the times of
    the other choices."""
    from repro_torch.kernels import conv2d_shift as cs
    OH, OW = a.shape[0] - k.shape[0] + 1, a.shape[1] - k.shape[1] + 1
    modes = {}
    for name, knobs in {"plan": {}, **BCONV_MODES}.items():
        saved = {n: getattr(cs, n) for n in knobs}
        try:
            for n, v in knobs.items():
                setattr(cs, n, v)
            cs.binary_conv_launch_plan.cache_clear()
            cs._binary_signature.cache_clear()
            p = cs.binary_conv_launch_plan(OH, OW, a.shape[2], *k.shape[:2])
            check(torch.equal(cs.binary_conv2d(a, k), want),
                  f"binary_conv2d {name} != plain at {shape}")
            modes[name] = {"reuse": p.reuse, "staged": p.staged, "G": p.G,
                           "Q": p.Q, "threads": p.threads, "ctas": p.ctas,
                           "graph_ms": graph_ms(
                               torch, lambda: cs.binary_conv2d(a, k))}
        finally:
            for n, v in saved.items():
                setattr(cs, n, v)
            cs.binary_conv_launch_plan.cache_clear()
            cs._binary_signature.cache_clear()
    emit("bconv_modes", kernel="binary_conv2d", shape=shape, modes=modes)


def rows_binary_conv(torch, rates):
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d_shift import (binary_conv2d,
                                                  binary_conv2d_plain)
    from repro_torch.kernels.ref import pack_bits
    rows = []
    # (H, W, C, kh, kw, word offset of a): the ops path's shape first, then
    # the reference's; two images whose work is far above the launch floor
    # (514×514 at C 256, 258×258 at C 1024) and one of 25 taps (row reuse
    # staged); 3-word rows (C 96, rows off 16 bytes); the ops path's image
    # at 1 and 3 words off 16 bytes
    for i, (H, W, C, k, off) in enumerate([
            (66, 66, 256, 3, 0), (16, 16, 32, 3, 0), (32, 24, 64, 3, 0),
            (20, 20, 128, 5, 0), (514, 514, 256, 3, 0),
            (258, 258, 1024, 3, 0), (260, 260, 256, 5, 0),
            (66, 66, 96, 3, 0), (66, 66, 256, 3, 1), (66, 66, 256, 3, 3)]):
        rng = np.random.default_rng(20 + i)
        af = torch.from_numpy(rng.choice([-1.0, 1.0], size=(H, W, C)).astype(
            np.float32)).cuda()
        kf = torch.from_numpy(rng.choice([-1.0, 1.0], size=(k, k, C)).astype(
            np.float32)).cuda()
        ap, kp = pack_bits(af), pack_bits(kf)
        if off:
            ap = at_offset(torch, ap, off)
        a4 = af.permute(2, 0, 1)[None].contiguous()
        k4 = kf.permute(2, 0, 1)[None].contiguous()
        dense = F.conv2d(a4, k4)[0, 0].round().to(torch.int32)
        check(torch.equal(binary_conv2d(ap, kp), dense),
              f"binary_conv2d != the dense ±1 conv at {(H, W, C, k)}")
        shape = [H, W, C, k] + ([f"offset {off}"] if off else [])
        rows.append(kernel_row(
            torch, "binary_conv2d", shape, binary_conv2d,
            binary_conv2d_plain, lambda a4=a4, k4=k4: F.conv2d(a4, k4),
            (ap, kp), _nbytes(ap, kp, dense),
            xnor_work(rates, dense.numel(), k * k * (C // 32))))
        bconv_modes(torch, shape, ap, kp, dense)
        if i == 0:
            bconv_host_steps(torch, ap, kp, a4, k4)
    return rows


def phase_kernels(torch, rates) -> dict:
    """Every kernel against its plain version; returns each kernel's rows
    (the main-path row first)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {"binary_matmul": rows_binary_matmul(torch, rates),
            "splitk_matvec": rows_splitk(torch)}
    matvec_host_steps(torch)
    return {**rows,
            "conv2d_shift": rows_conv(torch),
            "conv2d_shift_tiled": rows_tiled(torch),
            "binary_conv2d": rows_binary_conv(torch, rates)}


def correlate(img, K, N):
    """Valid correlation mod 2^N in int64 (the numpy oracle)."""
    k = K.shape[-1]
    oh, ow = img.shape[-2] - k + 1, img.shape[-1] - k + 1
    out = np.zeros(img.shape[:-2] + (oh, ow), dtype=np.int64)
    for v in range(k):
        for h in range(k):
            out += img[..., v:v + oh, h:h + ow] * K[..., v, h, None, None]
    return out % (1 << N)


def engine_case(plan, name, cycles, Bs, make, decode, oracle,
                kernels_label="kernels"):
    """Run ``plan`` over each batch size on the three device backends; all
    decode identically and equal ``oracle``. ``kernels_label`` is the
    label a ``kernels`` run must carry (``kernels:fallback-torch`` for a
    trace no kernel computes)."""
    t0 = time.perf_counter()
    cp = plan.compile()
    compile_s = time.perf_counter() - t0
    check(cp.n_cycles == cycles, f"{name} has {cp.n_cycles} cycles, not "
          f"{cycles}")
    for B in Bs:
        operands = make(B)
        mems = np.zeros((B, plan.rows, plan.cols), np.uint8)
        for b in range(B):
            plan.load_into(mems[b], *(o[b] for o in operands))
        walls, decoded = {}, {}
        for backend in ("torch-fused", "torch-unfused", "kernels"):
            for run in ("first", "warm"):
                t0 = time.perf_counter()
                res = plan.execute_batch(mems, backend=backend,
                                         device="cuda")
                walls[f"{backend}:{run}"] = (time.perf_counter() - t0) * 1e3
            label = kernels_label if backend == "kernels" else backend
            check(res.backend == label and res.cycles == cycles,
                  f"{name} {backend}: label {res.backend}, {res.cycles} "
                  f"cycles")
            decoded[backend] = [decode(m) for m in res.mem]
        want = oracle(*operands)
        for backend, outs in decoded.items():
            for b, out in enumerate(outs):
                check(all(np.array_equal(np.asarray(o, dtype=np.int64), w)
                          for o, w in zip(out, want[b])),
                      f"{name} {backend} != the oracle at B={B}, "
                      f"instance {b}")
        emit("engine", plan=name, B=B, cycles=cycles, compile_s=compile_s,
             wall_ms=walls)


def sign_correlate(img, K):
    """sign of the valid ±1 correlation, ties to +1 (the binary conv
    oracle)."""
    k = K.shape[-1]
    oh, ow = img.shape[-2] - k + 1, img.shape[-1] - k + 1
    acc = np.zeros(img.shape[:-2] + (oh, ow), dtype=np.int64)
    for v in range(k):
        for h in range(k):
            acc += img[..., v:v + oh, h:h + ow] * K[..., v, h, None, None]
    return np.where(acc >= 0, 1, -1)


# fixed ±1 kernels of the binary conv requests and engine rows: the taps
# are baked into the program, so a fixed kernel keeps the warm rounds warm
# and the cycle counts known (the reference's, at these kernels)
BCONV_K3 = np.array([[1, -1, 1], [-1, 1, 1], [1, 1, -1]])
BCONV_K5 = np.array([[1, -1, 1, 1, -1], [-1, 1, -1, 1, 1],
                     [1, 1, -1, -1, 1], [-1, 1, 1, -1, 1],
                     [1, -1, 1, 1, -1]])


def phase_engine() -> None:
    from repro_torch.core import (BinaryConvPlan, BinaryMatvecPlan,
                                  ConvPlan, MatvecPlan)
    rng = np.random.default_rng(1)

    bplan = BinaryMatvecPlan(1024, 416)
    engine_case(
        bplan, "BinaryMatvecPlan(1024, 416)", 565, (1, 20, 33),
        lambda B: (rng.choice([-1, 1], size=(B, 1024, 416)),
                   rng.choice([-1, 1], size=(B, 416))),
        lambda m: (bplan.decode_y(m), bplan.decode_popcount(m)),
        lambda A, x: [(np.where(d >= 0, 1, -1), (d + 416) // 2)
                      for d in np.einsum("bmk,bk->bm", A, x)])

    mplan = MatvecPlan(1024, 39, 8)
    engine_case(
        mplan, "MatvecPlan(1024, 39, 8)", 9474, (1, 27),
        lambda B: (rng.integers(0, 256, size=(B, 1024, 39)),
                   rng.integers(0, 256, size=(B, 39))),
        lambda m: (mplan.decode_y(m),),
        lambda A, x: [(d % (1 << 16),)
                      for d in np.einsum("bmk,bk->bm", A, x)])

    cplan = ConvPlan(64, 8, 3, 8)
    cplan.ensure_program(np.ones((3, 3), np.int64))   # kstore: K-free
    engine_case(
        cplan, "ConvPlan(64, 8, 3, 8)", 9800, (1, 63),
        lambda B: (rng.integers(0, 256, size=(B, 64, 8)),
                   rng.integers(0, 256, size=(B, 3, 3))),
        lambda m: (cplan.decode_out(m),),
        lambda A, K: [(o,) for o in correlate(A, K, 8)])

    # binary conv: one kernel per program (its taps are in the gates), so
    # every instance of a batch shares it; no kernel computes the trace
    for (m, n), K, cycles in (((64, 64), BCONV_K3, 515),
                              ((128, 64), BCONV_K5, 1818)):
        bcplan = BinaryConvPlan(m, n, K.shape[0])
        bcplan.ensure_program(K)
        engine_case(
            bcplan, f"BinaryConvPlan({m}, {n}, {K.shape[0]})", cycles,
            (1, 33),
            lambda B, m=m, n=n, K=K: (rng.choice([-1, 1], size=(B, m, n)),
                                      np.broadcast_to(K, (B,) + K.shape)),
            lambda mem, p=bcplan: (p.decode_out(mem),),
            lambda A, Ks: [(sign_correlate(a, k),) for a, k in zip(A, Ks)],
            kernels_label="kernels:fallback-torch")


# request name -> (kind, operands, tiles, cycles, reduce depth)
def serve_requests(rng):
    K1 = rng.integers(0, 256, size=(3, 3))
    K2 = rng.integers(0, 256, size=(3, 3))
    lap = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]])
    pm = [-1, 1]
    return {
        "bmv 4096x2048": ("binary_matvec", (rng.choice(pm, (4096, 2048)),
                                            rng.choice(pm, 2048)), 20, 565,
                          3),
        "bmv 1024x384": ("binary_matvec", (rng.choice(pm, (1024, 384)),
                                           rng.choice(pm, 384)), 2, 565, 1),
        "bmv 300x500": ("binary_matvec", (rng.choice(pm, (300, 500)),
                                          rng.choice(pm, 500)), 2, None, 1),
        "mv 1024x1024 N8": ("matvec", (rng.integers(0, 256, (1024, 1024)),
                                       rng.integers(0, 256, 1024), 8),
                            27, 9474, 5),
        "mv 300x500 N8": ("matvec", (rng.integers(0, 256, (300, 500)),
                                     rng.integers(0, 256, 500), 8),
                          14, 9442, 4),
        "mv 256x256 N16": ("matvec", (rng.integers(0, 1 << 16, (256, 256)),
                                      rng.integers(0, 1 << 16, 256), 16),
                           15, 8732, 4),
        "conv 128x128 K1": ("conv", (rng.integers(0, 256, (128, 128)), K1,
                                     8), 63, 9800, 0),
        "conv 128x128 K2": ("conv", (rng.integers(0, 256, (128, 128)), K2,
                                     8), 63, 9800, 0),
        "conv 100x60 lap": ("conv", (rng.integers(0, 256, (100, 60)), lap,
                                     8), 33, 9800, 0),
        # ±1 binary conv (TiledConv2d(binary=True, tile_n=64)): two images
        # with one kernel share a plan and a batch
        "bconv 128x128 K3 a": ("binary_conv", (rng.choice(pm, (128, 128)),
                                               BCONV_K3), 9, 515, 0),
        "bconv 128x128 K3 b": ("binary_conv", (rng.choice(pm, (128, 128)),
                                               BCONV_K3), 9, 515, 0),
        "bconv 100x60 K5": ("binary_conv", (rng.choice(pm, (100, 60)),
                                            BCONV_K5), 3, 1562, 0),
    }


def oracle(kind, args):
    if kind == "binary_matvec":
        A, x = args
        return np.where(A @ x >= 0, 1, -1)
    if kind == "matvec":
        A, x, N = args
        return (A.astype(object) @ x.astype(object)) % (1 << (2 * N))
    if kind == "binary_conv":
        return sign_correlate(*args)
    img, K, N = args
    return correlate(img, K, N)


def serve_round(svc, reqs):
    from repro_torch.obs import trace
    tr = trace.enable()
    t0 = time.perf_counter()
    tickets = {name: svc.submit(kind, *args)
               for name, (kind, args, *_) in reqs.items()}
    svc.flush()
    wall = time.perf_counter() - t0
    trace.disable()
    spans = {}
    for ev in tr.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    for name, (kind, args, *_) in reqs.items():
        t = tickets[name]
        check(t.done and np.array_equal(
            np.asarray(t.result, dtype=np.int64),
            np.asarray(oracle(kind, args), dtype=np.int64)),
            f"ticket {name} != its oracle")
    return tickets, wall, spans


COUNTED = ("binary_matmul", "splitk_matvec", "conv2d_shift",
           "conv2d_shift_tiled", "binary_conv2d")


def launch_counters():
    from repro_torch.kernels import binary_matmul, conv2d_shift, splitk_matvec
    return {"binary_matmul": binary_matmul.binary_matmul,
            "splitk_matvec": splitk_matvec.splitk_matvec,
            "conv2d_shift": conv2d_shift.conv2d_shift,
            "conv2d_shift_tiled": conv2d_shift.conv2d_shift_tiled,
            "binary_conv2d": conv2d_shift.binary_conv2d}


def phase_serve() -> dict:
    """The slice's path; returns each kernel's launches in the kernels
    service's cold round."""
    from repro_torch.serve import PlanService
    counters = launch_counters()
    launches = None
    for backend in ("kernels", "torch"):
        rng = np.random.default_rng(2)
        reqs = serve_requests(rng)
        svc = PlanService(backend=backend, device="cuda")
        if backend == "kernels":
            for fn in counters.values():
                fn.launches = 0
        tickets, wall, spans = serve_round(svc, reqs)
        if backend == "kernels":
            launches = {n: fn.launches for n, fn in counters.items()}
            for n in ("binary_matmul", "splitk_matvec", "conv2d_shift"):
                check(launches[n] > 0, f"the kernels service launched no "
                      f"{n}")
            # one launch per bucket: three ±1 buckets, two 8-bit matvec
            check(launches["binary_matmul"] == 3
                  and launches["splitk_matvec"] == 2,
                  f"the kernels service launched {launches}")
        for name, (kind, args, tiles, cycles, depth) in reqs.items():
            t = tickets[name]
            check(t.n_units == tiles and t.reduce_depth == depth
                  and (cycles is None or t.cycles == cycles),
                  f"{name}: {t.n_units} tiles, {t.cycles} cycles, depth "
                  f"{t.reduce_depth}")
            fallback = backend == "kernels" and (name == "mv 256x256 N16"
                                                 or kind == "binary_conv")
            label = "kernels:fallback-torch" if fallback else backend
            check(t.backend == label, f"{name} labelled {t.backend}, not "
                  f"{label}")
        k1, k2 = tickets["conv 128x128 K1"], tickets["conv 128x128 K2"]
        check(k1.key == k2.key and k1.batch_units == 126,
              "distinct-kernel convs did not share one plan and batch")
        b1, b2 = tickets["bconv 128x128 K3 a"], tickets["bconv 128x128 K3 b"]
        b5 = tickets["bconv 100x60 K5"]
        check(b1.key == b2.key and b1.batch_units == 18 and b5.key != b1.key,
              "binary convs of one kernel did not share one plan and batch")
        # a warm round: plans cached, replay tables and libraries loaded
        warm, warm_wall, warm_spans = serve_round(
            svc, serve_requests(np.random.default_rng(3)))
        emit("serve", backend=backend,
             launches=launches if backend == "kernels" else None,
             stats=svc.stats.as_dict(),
             cold={"wall_s": wall, "spans_ms": spans, "requests": {
                 name: {"tiles": t.n_units, "cycles": t.cycles,
                        "reduce_depth": t.reduce_depth, "label": t.backend,
                        "wall_s": t.wall_s, "batch_wall_s": t.batch_wall_s,
                        "batch_units": t.batch_units}
                 for name, t in tickets.items()}},
             warm={"wall_s": warm_wall, "spans_ms": warm_spans,
                   "requests": {name: {"wall_s": t.wall_s,
                                       "batch_wall_s": t.batch_wall_s}
                                for name, t in warm.items()}})
    return launches


# the span totals the serve_auto_store record reports for each flush
STORE_SPANS = ("serve.plan_build", "serve.load", "engine.execute",
               "serve.prewarm", "autotune.tune")


def auto_labels_ok(reqs, tickets) -> None:
    """Every bucket the kernels compute resolved to ``kernels``; the 16-bit
    matvec and the binary convs resolved off it."""
    for name, (kind, *_) in reqs.items():
        label = tickets[name].backend
        off = name == "mv 256x256 N16" or kind == "binary_conv"
        if off:
            ok = label.startswith("auto:torch")
        else:
            ok = label in ("auto:kernels", "auto:kernels@32")
        check(ok, f"auto service labelled {name} {label}")


def phase_serve_auto_store() -> None:
    """``backend="auto"`` on a plan store: the serve phase's requests
    flushed cold (plans compiled and stored, buckets tuned inline), then
    warm, then on a fresh service over the same store and tunings file
    (every plan loaded, none compiled), then on an ``async_compile=True``
    service. ``compile_program`` calls are counted by a wrapper installed
    here, around the name the plans call."""
    import tempfile

    import repro_torch.core.plan as plan_mod
    from repro_torch.core.autotune import TuningTable
    from repro_torch.serve import PlanService
    counters = launch_counters()
    real = plan_mod.compile_program
    compiles = []

    def counting(*args, **kwargs):
        compiles.append(1)
        return real(*args, **kwargs)

    reqs = serve_requests(np.random.default_rng(2))
    rounds, stats = {}, {}
    plan_mod.compile_program = counting
    try:
        with tempfile.TemporaryDirectory(prefix="matpim_smoke_") as tmp:
            store, table = Path(tmp) / "plans", Path(tmp) / "tunings.json"

            def service(**kw):
                return PlanService(backend="auto", tunings=TuningTable(table),
                                   device="cuda", **kw)

            def run(name, svc):
                compiles.clear()
                tickets, wall, spans = serve_round(svc, reqs)
                auto_labels_ok(reqs, tickets)
                for req, (kind, args, tiles, cycles, depth) in reqs.items():
                    t = tickets[req]
                    check(t.n_units == tiles and t.reduce_depth == depth
                          and (cycles is None or t.cycles == cycles),
                          f"{name} {req}: {t.n_units} tiles, {t.cycles} "
                          f"cycles")
                rounds[name] = {
                    "wall_s": wall, "compiles": len(compiles),
                    "spans_ms": {k: spans.get(k, 0.0) for k in STORE_SPANS},
                    "labels": {req: t.backend for req, t in tickets.items()}}

            for fn in counters.values():
                fn.launches = 0
            svc = service(store=store)
            run("cold", svc)
            run("warm", svc)
            launches = {n: fn.launches for n, fn in counters.items()}
            svc.close()
            stats["first"] = svc.stats.as_dict()
            for n in ("binary_matmul", "splitk_matvec", "conv2d_shift"):
                check(launches[n] > 0, f"the auto service launched no {n}")
            fresh = service(store=store)
            run("restart", fresh)
            fresh.close()
            stats["restart"] = fresh.stats.as_dict()
            check(rounds["restart"]["compiles"] == 0,
                  f"the restarted service compiled "
                  f"{rounds['restart']['compiles']} programs")
            check(fresh.stats.store_hits == fresh.stats.misses > 0,
                  f"restart: {fresh.stats.store_hits} store hits of "
                  f"{fresh.stats.misses} misses")
            pooled = service(store=False, async_compile=True)
            run("async", pooled)
            pooled.close()
            stats["async"] = pooled.stats.as_dict()
            check(pooled.stats.async_compiles > 0,
                  "the async service compiled nothing on its pool")
    finally:
        plan_mod.compile_program = real
    emit("serve_auto_store", launches=launches, stats=stats, rounds=rounds)


def phase_ops(torch) -> dict:
    """``kernels.ops`` on CUDA tensors: each equals its plain version and
    launches its kernel; returns the launches of this run."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.binary_matmul import binary_matmul_plain
    from repro_torch.kernels.conv2d_shift import (binary_conv2d_plain,
                                                  conv2d_shift_plain)
    from repro_torch.kernels.splitk_matvec import splitk_matvec_plain
    g = torch.Generator(device="cuda").manual_seed(30)
    # integer-valued operands under 2^24: every sum exact in any order
    a = torch.randint(0, 16, (1024, 1024), generator=g, device="cuda").float()
    x = torch.randint(0, 16, (1024,), generator=g, device="cuda").float()
    img = torch.randint(0, 16, (1026, 1026), generator=g,
                        device="cuda").float()
    k = torch.randint(0, 16, (3, 3), generator=g, device="cuda").float()
    pm = torch.tensor([-1.0, 1.0], device="cuda")
    ab = pm[torch.randint(0, 2, (66, 66, 256), generator=g, device="cuda")]
    kb = pm[torch.randint(0, 2, (3, 3, 256), generator=g, device="cuda")]
    xs = torch.randn((64, 1024), generator=g, device="cuda")
    w = pm[torch.randint(0, 2, (1024, 1024), generator=g, device="cuda")]
    ap, kp, wp = ops.pack_bits(ab), ops.pack_bits(kb), ops.pack_bits(w)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    got = {"matvec": ops.matvec(a, x), "conv2d": ops.conv2d(img, k),
           "conv2d_tiled": ops.conv2d(img, k, tiled=True),
           "conv2d_binary": ops.conv2d_binary(ap, kp),
           "binary_dense": ops.binary_dense(xs, wp, 1024)}
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    want = {"matvec": splitk_matvec_plain(a, x),
            "conv2d": conv2d_shift_plain(img, k),
            "conv2d_tiled": conv2d_shift_plain(img, k),
            "conv2d_binary": binary_conv2d_plain(ap, kp),
            "binary_dense": binary_matmul_plain(ops.pack_bits(xs), wp)}
    for name in got:
        check(got[name].is_cuda and torch.equal(got[name], want[name]),
              f"ops.{name} != its plain version")
    check(all(v == 1 for v in launches.values()),
          f"ops launches {launches}, not one each")
    emit("ops", launches=launches,
         shapes={n: list(t.shape) for n, t in got.items()})
    return launches


SOURCES = {
    "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                      "src/repro/kernels/binary_matmul.py:63"),
    "splitk_matvec": ("src/repro_torch/csrc/splitk_matvec.cu",
                      "src/repro/kernels/splitk_matvec.py:38"),
    "conv2d_shift": ("src/repro_torch/csrc/conv2d_shift.cu",
                     "src/repro/kernels/conv2d_shift.py:36"),
    "conv2d_shift_tiled": ("src/repro_torch/csrc/conv2d_shift.cu",
                           "src/repro/kernels/conv2d_shift.py:63"),
    "binary_conv2d": ("src/repro_torch/csrc/conv2d_shift.cu",
                      "src/repro/kernels/conv2d_shift.py:100"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every phase record here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    name_limit = smi("name,power.limit")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(torch, int_rates(torch))
    phase_engine()
    launches = phase_serve()
    phase_serve_auto_store()
    launches.update({n: v for n, v in phase_ops(torch).items()
                     if n in ("conv2d_shift_tiled", "binary_conv2d")})
    summary = {"kernels": []}
    for name in COUNTED:
        main_row = rows[name][0]
        source, replaces = SOURCES[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library_graph_ms": main_row["library_graph_ms"]})
    emit("done", seconds=time.perf_counter() - t0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"nvidia_smi": name_limit, "records": RECORDS, **summary},
            indent=1))
    print(json.dumps(summary), flush=True)
    print(name_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
