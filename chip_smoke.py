"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``; imports nothing of JAX or of the reference package. Phases,
each printing one JSON line per record:

1. build   — compile every CUDA source of the port (one ``nvcc`` each, all
             started together; of ``decode_attention.cu`` the served
             variant, olmo-1b's bf16 cache at one query head a KV head) and
             print the build seconds, each source's, and ptxas report;
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
             choices of its plan (record ``bconv_modes``), and for
             decode_attention at the chat and rag cells' decode shapes
             (olmo-1b, 32 slots at rows 256–1280 and 16 at 1536–1984 of a
             2048-row bf16 cache) and at granite-4.0-h-micro's (GQA 32 on
             8 heads of 64, 32 slots at rows 2048–8255 of an 8448-row
             cache, the logits divided by 64), rows past ``pos`` at NaN,
             within one bf16 rounding plus 1e-5 of the values' scale; and
             for ssd_scan at a granite-4.0-h-micro prefill's shapes (one
             prompt of 2048, 5000 and 8000 tokens, 64 heads of 64, state
             128, chunk 256, bf16), its max abs error against a float64
             run of the plain version at most twice the plain float32
             path's, for y and the final state, with each path's peak
             memory above its inputs;
             the compared call's launch count; kernel, plain and library
             times from CUDA events — per call, and for the kernel and the
             library also per launch replayed from a CUDA graph, without the
             host — and the bound, the largest of the bytes' time (3.35
             TB/s) and each kind of operations' time (float multiply-adds as
             2 flops at 67 TFLOP/s; XOR and add at the INT32 rate,
             population count at the popcount rate). The library call is a
             yardstick the port never calls: ``torch.matmul`` of the unpacked
             ±1 operands (binary_matmul), ``torch.mv`` / ``torch.matmul``
             (splitk_matvec), ``F.conv2d`` with ``groups=B`` (the convs),
             ``F.conv2d`` of the unpacked ±1 floats (binary_conv2d) and
             ``F.scaled_dot_product_attention`` over the whole cache under
             the ``pos`` mask (decode_attention), none for ssd_scan; TF32 is
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
   mesh    — multi-device tile dispatch with two slots on the one card:
             each engine plan's last batch (``BinaryMatvecPlan(1024,
             416)`` at B 33, ``MatvecPlan`` at 27, ``ConvPlan`` at 63,
             ``BinaryConvPlan(64, 64, 3)`` at 33) through ``execute(...,
             backend="torch-fused", mesh=tile_mesh(devices=["cuda:0"] *
             2))`` equals the single-device images, labelled ``+mesh2``;
             a cold and a warm flush of the serve phase's twelve requests on
             ``PlanService(devices=2, backend="kernels")`` equal their
             oracles and the serial kernels service's tickets, run on both
             slots, and launch the three served kernels (counts zeroed just
             before the cold flush, read after it). Record ``mesh``: the
             walls beside the serial ones (no speed claim: both slots share
             the card).
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
   tune    — ``tools/autotune_torch.py``: ``service_work`` captures the
             buckets of one flush of the serve phase's twelve requests,
             ``sweep`` times every candidate on each and writes a fresh
             tunings file; then one cold ``PlanService(backend="auto")``
             flush on that file with a fresh plan store. It must tune no
             bucket inline (the ``serve.inline_tunes`` counter does not
             move) and every ticket equals its oracle. Record ``tune``: the
             sweep's wall and entries, the cold flush's wall, span totals
             and labels, beside the cold ``auto`` walls this card measured
             earlier with inline tuning (33.76 and 44.05 s, PERF.md §5).
5. ops     — ``kernels.ops`` on CUDA tensors: ``matvec``, ``conv2d``,
             ``conv2d(tiled=True)``, ``conv2d_binary`` and ``binary_dense``
             each equal their plain versions exactly, and raise their
             kernels' launch counts, zeroed just before and read just after.
6. apps    — the application layer at full width on ``backend="kernels"``:
             ``BinaryMLP.random([512, 2048, 2048, 2048, 32])`` (the
             ``matpim-bnn`` config's unreduced widths on the reference's
             256×512 crossbars of 16 partitions), ``forward`` of one input
             and ``forward_batch`` of 64, equal to ``model.reference``; a
             ``Pipeline([MatvecStage(A, 8)])`` over a 1024×1024 8-bit A
             (``A @ x mod 2^16``); ``edge_pipeline``, ``sharpen_pipeline``
             and ``binary_edge_pipeline`` on a 512×512 4-bit image, equal to
             their host references. Per run: stage labels (``kernels``;
             ``kernels:fallback-torch`` for the binary convs), report cycles
             and nJ, wall, launches. ``binary_matmul``, ``splitk_matvec``
             and ``conv2d_shift`` counts, zeroed just before the phase and
             read just after, must rise.
7. faults  — ``FaultModel`` runs on ``device="cuda"`` and ``"cpu"`` with
             the same seeds, bit-identical: ``binary_matvec_sweep([0,
             1e-4, 1e-3, 1e-2])`` at its defaults on ``torch-fused`` and
             ``torch-unfused`` (equal to each other; rate 0 fault-free),
             ``bnn_accuracy_sweep`` at its defaults, ``tmr_binary_matvec(
             1e-3, samples=256)``, ``fault_sweep`` of the reduced 3-layer
             BNN at 128 samples, and a ``PlanService(seed=0,
             backend="kernels")`` flush of two faulty binary-matvec
             requests (labelled ``kernels:fallback-torch``) and a
             fault-free one (``kernels``). Per run and device: the wall and
             the host's mask drawing and copying (``engine.fault.draw`` /
             ``engine.fault.copy`` span totals) as a share of it.

8. lm      — the model stack's serving path on ``cuda`` at full width,
             weights from a seeded ``torch.Generator``: olmo-1b (16 layers,
             d_model 2048, vocab 50304), mamba2-370m (48 layers) and
             granite-4.0-h-micro (40 layers, 4 of them attention) in
             their bf16, each serving 8 requests of 16 new tokens on 4
             slots of a 128-row cache through ``launch.serve.serve`` (the
             CLI's path): per-request prefill ms and every decode step's ms
             from CUDA events, tokens per second, peak memory (and what
             earlier phases still held when it began), and the
             decode step's bound (its parameter bytes, and its cache, read
             once at 3.35 TB/s). olmo-1b and mamba2-370m in float32: one
             16-token prompt's forward logits on the card, on the CPU, and
             on the CPU in float64 agree pairwise (card-CPU, card-f64, CPU-f64) within
             1e-2 of the float64 logits' largest magnitude, and so do 16
             decode steps on the card against its forward; in float64 the
             first 4 decode steps equal the forward within 1e-9 of it. A matpim-bnn forward (4 × 64 tokens) at
             full width. Record ``lm``. The model path launches none of the
             five crossbar kernels (the reference's runs no Pallas kernel);
             the bf16 serving runs launch ``decode_attention`` once an
             attention layer a decode step: olmo-1b's launches must equal
             16 × its decode steps and ``attention.decode.kernel``'s calls,
             with ``attention.decode.plain`` at 0, granite-4.0-h-micro's
             4 × its decode steps, and mamba2-370m's 0 (record fields
             ``decode_attention_launches``,
             ``attention_decode_calls``). Each serving run replays every
             decode step from the engine's CUDA graph
             (``model.decode.graph``), and is served again with every step
             eager (``DecodeGraph.takes`` patched to refuse): the same
             tokens and launches; field ``graph``: the capture's seconds,
             the median decode ms of both runs, the tokens equal. The
             Mamba archs (mamba2-370m, granite-4.0-h-micro) are served once
             more with every chunked scan on the plain path
             (``mamba._kernel_takes`` patched to refuse): the bf16 run
             counts ``mamba.ssd.kernel`` (and ``ssd_scan`` launches) once a
             Mamba layer a prefill and ``mamba.ssd.plain`` never, the
             patched run the reverse; field ``ssd``: the tokens equal, or
             at the first that parts each path's logit gap between the two
             tokens. Field ``ssd_prefill`` (also a record of its own per
             length): one granite-4.0-h-micro prefill of 2048, 5000 and
             8000 tokens on each path, CUDA-event ms of the forward and of
             its 36 scans, the forward's peak memory above the weights and
             a scan's largest peak, which must fall by at least 1 GB at
             8000 tokens on the kernel.
9. train   — the model stack's training half on ``cuda``. Record ``train``:
             olmo-1b at full width in bf16 through ``launch.train.train``
             (the CLI's path; weights from a seeded ``torch.Generator``),
             SyntheticLM batch 8 × 256, 6 steps under each of remat
             "full" with float32 moments, "none", and "dots" with int8
             moments and two microbatches: step ms split into gradients and
             update (CUDA events; medians over steps 1-5), tokens/s, the
             peak memory of each part, the optimizer state's bytes, and the
             bound from ``launch/analytic.py`` at 989 TFLOP/s bf16 and 3.35
             TB/s; every loss finite, every leaf moved, "full"'s gradient
             peak below "none"'s, first-step losses within 2^-7 of each
             other. Record ``train_f32``: one float32 step (B 2, S 64) on
             the card and on the CPU against the same step in float64 on the
             card, within ``TRAIN_F32_TOL`` of each gradient leaf's scale,
             and a TF32 control that must miss it. Record ``train_bnn``:
             matpim-bnn at full width, 10 steps on the reference test's
             batch (loss must fall), then ``run_resilient_loop`` with a
             checkpoint every 3 steps and a failure injected at step 4,
             bit-equal to a clean run under deterministic algorithms, and
             the checkpoint's save and restore walls.

10. oracle — the CUDA ``binary_matmul`` against the port's crossbar
             engine replayed on the card (``kernels.ref.
             crossbar_binary_matmul_ref(..., backend="torch")``), bit for
             bit: at the main path's shape (20 instances of a 1024×416 ±1
             tile against one vector, Kw 13) and at one spanning several
             tiles (2500×3000 against 3 vectors: 3 × 8 tiles each). Record
             ``oracle``: shapes, tiles, walls of both sides.
11. dryrun — ``launch.dryrun.run_cell`` for every (arch × shape) cell of
             the ten assigned configs at full width on ``meta`` (in worker
             processes; the card's memory allocated does not move while one
             cell runs in this process), each ``ok``: fits against the
             card's ``total_memory``, peak, counted and analytic flops,
             dominant term (record ``dryrun``). Then the real step on the
             card for up to two cells the dry run says fit, at their full
             production shape (mamba2-370m ``decode_32k``, then
             whisper-tiny ``decode_32k`` if its predicted peak fits in the
             free memory with 2 GB to spare, else mamba2-370m
             ``long_500k``): ``torch.cuda.max_memory_allocated`` over the
             first step against the predicted peak, and
             ``FlopCounterMode``'s count on the real tensors (the
             ``decode_attention`` operator by its registered formula, as
             on ``meta``), which must equal the count on ``meta``; the
             first and a warm step's ms
             from CUDA events (record ``dryrun_real``); the logits must be
             finite.

12. dist  — sharded steps. A one-rank NCCL process group on the card (a
             ``FileStore`` in a temporary directory) with a 1×1
             ``("data", "model")`` mesh (``launch.mesh.make_mesh``): olmo-1b
             at full width in bf16 served (8 requests × 16 new tokens
             through ``launch.serve.serve``) and trained (3 steps, remat
             "full", float32 moments, batch 8 × 256, through
             ``launch.train.train``) with DTensor parameters, cache,
             moments and batches, each beside the same run on plain tensors
             (``make_local_mesh``): greedy tokens equal to a plain run's
             whose caches are decoded through ``_sdpa``, as DTensor
             caches are (the plain run through the ``decode_attention``
             kernel sums in another order, so a random model's tokens may
             part at a near tie: where they part is reported, entry
             ``serve.kernel_vs_sharded``), losses within
             2^-7 relative and every updated parameter within
             ``TRAIN_F32_TOL`` of its scale (max abs difference and
             bit-equality reported); decode-step and train-step ms (CUDA
             events) of both and their ratio (DTensor's host overhead);
             peak memory; the collectives ``CollectiveMeter`` saw. Meanwhile
             five spawned workers run the sharded dry run
             (``run_cell(mesh="16x16")``, rank 0 of a fake process group of
             256 or 512 ranks on ``meta``): olmo-1b and mamba2-370m
             ``train_4k`` and ``decode_32k`` at 16×16, olmo-1b ``train_4k``
             at 2×16×16; per-device peak, ``fits``, collective bytes by
             kind and the dominant term (record ``dist``). Then, on the
             same group and mesh, sharded checkpoints (record ``ckpt``):
             olmo-1b at full width in bf16 with int8 moments (remat
             "full", batch 8 × 256), 4 steps through
             ``run_resilient_loop`` with ``Checkpointer(keep=1)`` in a
             temporary directory and a checkpoint every 2 steps, (a)
             clean and (b) with a failure injected at step 3, which
             restores step 2 and must end bit-equal to (a) in every
             parameter, moment and the step count (deterministic
             algorithms); (c) that step-2 checkpoint restored onto plain
             tensors (``shardings`` on ``make_local_mesh``), then steps 2
             and 3: losses within 2^-7 relative of (a)'s, parameters
             within ``TRAIN_F32_TOL`` of scale, bit-equality reported.
             The directory's free bytes are printed first, and under 2.5
             checkpoints (one is 7.08 GB) the record fails. It reports
             bytes on disk, each save's snapshot wall and background
             write wall, each restore's wall and each save's extra peak
             of allocated memory. Last, the record ``dist``'s entry
             ``split_reductions``: ``spmd.block_softmax`` and
             ``spmd.block_logsumexp`` (the bodies ``spmd.softmax`` and
             ``spmd.logsumexp`` run on each rank's block of a split axis)
             on olmo-1b's decode logits at the ``dist`` serving's shape
             (4 slots × 16 KV heads × 1 × 1 × 128 positions, masked to
             ``-1e30`` past position 23, so three of the four blocks are
             wholly masked) and on full-width loss logits (8 × 256 ×
             50304), float32, each cut into 4 blocks along the reduced
             axis with ``amax``/``sum`` over the blocks standing in for
             the all-reduces: values and gradients no further from a
             float64 run of the whole than ``torch.softmax`` /
             ``torch.logsumexp``'s float32 is, plus ``SPLIT_TOL`` (1e-6)
             of scale, and within ``SPLIT_TORCH_TOL`` (3e-5) of scale of
             torch's float32; and ``spmd.softmax`` /
             ``spmd.logsumexp`` on DTensors of the 1×1 mesh (no axis to
             reduce over: torch's own function on the shard), bit-equal.

Then the per-kernel summary line ``{"kernels": [...]}`` (``launches`` from
the serve phase for binary_matmul, splitk_matvec and conv2d_shift, from the
ops phase for conv2d_shift_tiled and binary_conv2d, from the lm phase's
serving runs for decode_attention and ssd_scan; the other numbers from
each kernel's main-path row, ``library_graph_ms`` the library yardstick
replayed from a CUDA graph), the card's name and power limit from
``nvidia-smi``, and the last line ``{"ok": true, "device": {...}}``. Any
failed check raises: the script exits non-zero and prints no result line.
Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import decode_attention as DA
    served = DA.variant(torch.bfloat16, DA.decode_launch_plan(
        32, 16, 16, 2048, 128, torch.bfloat16))
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    jobs = [(s, served if s == DA.SOURCE else ()) for s in sources]

    def timed(job):
        t = time.perf_counter()
        log = kernels.build(*job)
        return log, time.perf_counter() - t
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        done = dict(zip(sources, pool.map(timed, jobs)))
    seconds = time.perf_counter() - t0
    for job in jobs:
        kernels.load_library(*job)
    emit("build", sources=sources, seconds=seconds,
         seconds_by_source={s: done[s][1] for s in sources},
         decode_attention_variant=list(served),
         ptxas={s: [ln for ln in done[s][0].splitlines() if "ptxas" in ln]
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


# decode_attention's served shapes (bench/mixes/), bf16 throughout: olmo-1b's
# 16 heads of 128 on 16 KV heads over a 2048-row cache, the chat cell's 32
# slots at rows 256-1280 and the rag cell's 16 at rows 1536-1984; and
# granite-4.0-h-micro's GQA of 32 heads of 64 on 8 KV heads over an 8448-row
# cache, 32 slots at rows 2048-8255 (long documents), its logits divided by
# 64 (1 / attention_multiplier) in place of sqrt(64).
# (name, B, S_max, H, KV, hd, lowest pos, highest pos, logit divisor or None)
DECODE_SHAPES = (("chat", 32, 2048, 16, 16, 128, 256, 1280, None),
                 ("rag", 16, 2048, 16, 16, 128, 1536, 1984, None),
                 ("granite", 32, 8448, 32, 8, 64, 2048, 8255, 64.0))


def rows_decode_attention(torch):
    """``decode_attention`` at the served shapes against its plain version
    on the card, rows past ``pos`` at NaN; the library yardstick is
    ``F.scaled_dot_product_attention`` over the whole cache under the
    ``pos`` mask (its GQA, and the same scale), timed only (the port never
    calls it). Bound: the valid rows of k and v read once, q read and the
    output written once (``bytes_needed``), against 4 flops a cached
    element a query head."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (bytes_needed,
                                                      decode_attention,
                                                      decode_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for name, B, S, H, KV, hd, lo, hi, divisor in DECODE_SHAPES:
        pos = torch.randint(lo, hi + 1, (B,), generator=g, device="cuda")
        q = torch.randn((B, 1, H, hd), generator=g,
                        device="cuda").bfloat16()
        k, v = (torch.randn((B, S, KV, hd), generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        past = torch.arange(S, device="cuda")[None, :] > pos[:, None]
        k[past], v[past] = float("nan"), float("nan")
        lib_k, lib_v = (torch.nan_to_num(t).transpose(1, 2) for t in (k, v))
        mask = ~past[:, None, None, :]
        lib_q = q.transpose(1, 2)
        lib_scale = None if divisor is None else 1.0 / divisor

        def library(q=lib_q, k=lib_k, v=lib_v, m=mask, sc=lib_scale,
                    gqa=H != KV):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                  scale=sc, enable_gqa=gqa)
        scale = float(torch.nan_to_num(v).float().abs().max())
        valid = int((pos + 1).sum())
        args = (q, k, v, pos) if divisor is None else (q, k, v, pos, divisor)
        rows.append(kernel_row(
            torch, "decode_attention",
            [name, B, S, H, KV, hd, "bf16", divisor],
            decode_attention, decode_attention_plain, library, args,
            bytes_needed(pos.tolist(), KV, hd, 2, H, 2),
            [(4 * valid * H * hd, F32_FLOPS_PER_S)],
            tol=(2.0 ** -7, 1e-5 * scale)))
    return rows


# ssd_scan at a granite-4.0-h-micro prefill's shapes: one prompt of each
# length, 64 heads of 64, state 128, one group, chunk 256, bf16 x, B and C
SSD_SHAPES = (2048, 5000, 8000)
SSD_WIDTHS = (64, 64, 128, 256)      # heads, head size, state, chunk


def peak_over(torch, fn) -> int:
    """The peak memory ``fn()`` allocates above what was allocated before
    it (its result held until the peak is read)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def rows_ssd_scan(torch):
    """``ssd_scan`` at a granite prefill's shapes against its plain version
    (``models/mamba.py::ssd_plain``) and a float64 run of the plain version
    on the same inputs, A and dt drawn as Mamba-2 publishes them (A uniform
    in [1, 16], dt log-uniform in [0.001, 0.1]): the kernel's max abs error
    against float64 at most twice the plain float32 path's, for y and the
    final state. Kernel ms per call and replayed from a CUDA graph, plain
    ms, each path's peak memory above its inputs, and the bound: the
    scan's flops (``ssd_scan.flops``) as float32 FMAs at 67 TFLOP/s
    against its operands read and outputs written once. No library call
    computes the scan."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models.mamba import ssd_plain
    H, P, N, L = SSD_WIDTHS
    rng = np.random.default_rng(34)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()
    rows = []
    for S in SSD_SHAPES:
        x = f32(rng.standard_normal((1, S, H, P))).bfloat16()
        B, C = (f32(rng.standard_normal((1, S, N))).bfloat16()
                for _ in range(2))
        A = -f32(rng.uniform(1.0, 16.0, H))
        dt = f32(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (1, S, H))))
        D = f32(rng.standard_normal(H))
        args = (x, dt, A, B, C, D, L)
        SS.ssd_scan.launches = 0
        y, state = SS.ssd_scan(*args)
        launches = SS.ssd_scan.launches
        py, pstate = ssd_plain(*args)
        wy, wstate = ssd_plain(*(t.double() for t in args[:6]), L)
        torch.cuda.synchronize()
        check(launches == 1, f"ssd_scan launched {launches} times for one "
              f"call")
        errs = {}
        for name, got, plain, want in (("y", y, py, wy),
                                       ("state", state, pstate, wstate)):
            errs[name] = {"kernel": float((got.double() - want).abs().max()),
                          "plain": float((plain.double() - want).abs().max()),
                          "scale": float(want.abs().max())}
            check(errs[name]["kernel"] <= 2 * errs[name]["plain"],
                  f"ssd_scan at {S} tokens: {name} {errs[name]} against "
                  f"float64, over twice the plain path's")
        del py, pstate, wy, wstate
        torch.cuda.empty_cache()
        nbytes = _nbytes(x, dt, A, B, C, D, y, state)
        flops = SS.flops(1, S, H, P, N, L)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        row = {
            "shape": [1, S, H, P, N, L, "bf16"],
            "max_abs_err": errs["y"]["kernel"], "against": "float64",
            "errors": errs, "launches": launches,
            "ms": cuda_ms(torch, lambda: SS.ssd_scan(*args)),
            "graph_ms": graph_ms(torch, lambda: SS.ssd_scan(*args)),
            "plain_ms": cuda_ms(torch, lambda: ssd_plain(*args), trials=5,
                                per_trial=4),
            "library_ms": None, "library_graph_ms": None,
            "peak_bytes": {"kernel": peak_over(torch,
                                               lambda: SS.ssd_scan(*args)),
                           "plain": peak_over(torch,
                                              lambda: ssd_plain(*args))},
            "bytes": nbytes, "ops": [flops],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        emit("kernels", kernel="ssd_scan", **row)
        rows.append(row)
        del x, B, C, dt, y, state, args
        torch.cuda.empty_cache()
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
            "binary_conv2d": rows_binary_conv(torch, rates),
            "decode_attention": rows_decode_attention(torch),
            "ssd_scan": rows_ssd_scan(torch)}


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
    trace no kernel computes). Returns the last batch's memory images and
    its final images on ``torch-fused``."""
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
            if backend == "torch-fused":
                fused = res.mem
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
    return mems, fused, walls["torch-fused:warm"]


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


def phase_engine() -> dict:
    """Returns, per plan kind, the plan, its last batch, that batch's
    final images on ``torch-fused`` and the warm wall (the mesh phase's
    inputs)."""
    from repro_torch.core import (BinaryConvPlan, BinaryMatvecPlan,
                                  ConvPlan, MatvecPlan)
    rng = np.random.default_rng(1)

    kinds = {}
    bplan = BinaryMatvecPlan(1024, 416)
    kinds["BinaryMatvecPlan(1024, 416)"] = (bplan, *engine_case(
        bplan, "BinaryMatvecPlan(1024, 416)", 565, (1, 20, 33),
        lambda B: (rng.choice([-1, 1], size=(B, 1024, 416)),
                   rng.choice([-1, 1], size=(B, 416))),
        lambda m: (bplan.decode_y(m), bplan.decode_popcount(m)),
        lambda A, x: [(np.where(d >= 0, 1, -1), (d + 416) // 2)
                      for d in np.einsum("bmk,bk->bm", A, x)]))

    mplan = MatvecPlan(1024, 39, 8)
    kinds["MatvecPlan(1024, 39, 8)"] = (mplan, *engine_case(
        mplan, "MatvecPlan(1024, 39, 8)", 9474, (1, 27),
        lambda B: (rng.integers(0, 256, size=(B, 1024, 39)),
                   rng.integers(0, 256, size=(B, 39))),
        lambda m: (mplan.decode_y(m),),
        lambda A, x: [(d % (1 << 16),)
                      for d in np.einsum("bmk,bk->bm", A, x)]))

    cplan = ConvPlan(64, 8, 3, 8)
    cplan.ensure_program(np.ones((3, 3), np.int64))   # kstore: K-free
    kinds["ConvPlan(64, 8, 3, 8)"] = (cplan, *engine_case(
        cplan, "ConvPlan(64, 8, 3, 8)", 9800, (1, 63),
        lambda B: (rng.integers(0, 256, size=(B, 64, 8)),
                   rng.integers(0, 256, size=(B, 3, 3))),
        lambda m: (cplan.decode_out(m),),
        lambda A, K: [(o,) for o in correlate(A, K, 8)]))

    # binary conv: one kernel per program (its taps are in the gates), so
    # every instance of a batch shares it; no kernel computes the trace
    for (m, n), K, cycles in (((64, 64), BCONV_K3, 515),
                              ((128, 64), BCONV_K5, 1818)):
        bcplan = BinaryConvPlan(m, n, K.shape[0])
        bcplan.ensure_program(K)
        name = f"BinaryConvPlan({m}, {n}, {K.shape[0]})"
        out = engine_case(
            bcplan, name, cycles,
            (1, 33),
            lambda B, m=m, n=n, K=K: (rng.choice([-1, 1], size=(B, m, n)),
                                      np.broadcast_to(K, (B,) + K.shape)),
            lambda mem, p=bcplan: (p.decode_out(mem),),
            lambda A, Ks: [(sign_correlate(a, k),) for a, k in zip(A, Ks)],
            kernels_label="kernels:fallback-torch")
        if K is BCONV_K3:
            kinds[name] = (bcplan, *out)
    return kinds


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


# the crossbar kernels, whose launches the crossbar phases count, and the
# model path's decode kernel, whose launches the lm phase counts
COUNTED = ("binary_matmul", "splitk_matvec", "conv2d_shift",
           "conv2d_shift_tiled", "binary_conv2d", "decode_attention",
           "ssd_scan")


def launch_counters():
    """The five crossbar kernels' wrappers, which count their launches."""
    from repro_torch.kernels import binary_matmul, conv2d_shift, splitk_matvec
    return {"binary_matmul": binary_matmul.binary_matmul,
            "splitk_matvec": splitk_matvec.splitk_matvec,
            "conv2d_shift": conv2d_shift.conv2d_shift,
            "conv2d_shift_tiled": conv2d_shift.conv2d_shift_tiled,
            "binary_conv2d": conv2d_shift.binary_conv2d}


def phase_serve() -> tuple:
    """The slice's path; returns each kernel's launches in the kernels
    service's cold round, and that service's tickets and walls (the mesh
    phase's serial flush)."""
    from repro_torch.serve import PlanService
    counters = launch_counters()
    launches = serial = None
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
        if backend == "kernels":
            serial = {"tickets": tickets, "cold_wall_s": wall,
                      "warm_wall_s": warm_wall}
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
    return launches, serial


# cold auto flushes of the serve_auto_store phase measured earlier on the
# H100 (s), each bucket tuned inline (PERF.md section 5)
INLINE_TUNED_COLD_S = (33.76, 44.05)

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


def _sweep_tool():
    """``tools/autotune_torch.py`` as a module (``tools/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "autotune_torch", ROOT / "tools" / "autotune_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_tune(card: str) -> None:
    """The offline sweep over exactly the buckets the serve phase submits,
    then a cold ``auto`` flush on its table that tunes nothing inline."""
    import tempfile

    from repro_torch.core.autotune import TuningTable
    from repro_torch.obs import metrics
    from repro_torch.serve import PlanService
    tool = _sweep_tool()
    reqs = serve_requests(np.random.default_rng(2))
    t0 = time.perf_counter()
    work = tool.service_work([(kind, args) for kind, args, *_ in
                              reqs.values()], device="cuda")
    capture_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="matpim_tune_") as tmp:
        path = Path(tmp) / "tunings.json"
        t0 = time.perf_counter()
        tuned = tool.sweep(work, TuningTable(path), device="cuda", log=None)
        sweep_s = time.perf_counter() - t0
        inline = metrics.counter("serve.inline_tunes")
        before = inline.value
        svc = PlanService(backend="auto", store=Path(tmp) / "plans",
                          tunings=TuningTable(path), device="cuda")
        tickets, wall, spans = serve_round(svc, reqs)
        svc.close()
        inline_tunes = inline.value - before
    check(inline_tunes == 0, f"the cold auto flush tuned {inline_tunes} "
          f"buckets inline on a swept table")
    for name, (kind, *_) in reqs.items():
        label = tickets[name].backend
        check(label.startswith("auto:") and not (
            (name == "mv 256x256 N16" or kind == "binary_conv")
            and label.startswith("auto:kernels")),
            f"tune: {name} labelled {label}")
    emit("tune", card=card, buckets=len(work), capture_wall_s=capture_s,
         sweep_wall_s=sweep_s,
         entries=[{"bucket": name, "batch": B, "backend": e.backend,
                   "max_batch": e.max_batch, "us": e.us}
                  for name, B, e in tuned],
         cold_auto={"wall_s": wall, "inline_tunes": inline_tunes,
                    "spans_ms": {k: spans.get(k, 0.0) for k in STORE_SPANS},
                    "labels": {r: t.backend for r, t in tickets.items()}},
         inline_tuned_cold_wall_s=INLINE_TUNED_COLD_S)


def phase_oracle(torch) -> None:
    """The CUDA ``binary_matmul`` equals the port's crossbar engine on the
    card (``backend="torch"`` replay), bit for bit, at the main path's
    shape and at one that spans several tiles."""
    from repro_torch.core.tiling import TiledBinaryMatvec
    from repro_torch.kernels.binary_matmul import binary_matmul
    from repro_torch.kernels.ref import crossbar_binary_matmul_ref, pack_bits
    rng = np.random.default_rng(40)
    out = []
    for batch, M, K, N in ((20, 1024, 416, 1), (1, 2500, 3000, 3)):
        a = rng.choice([-1, 1], size=(batch, M, K))
        b = rng.choice([-1, 1], size=(batch, N, K))
        pad = -K % 32

        def words(x):
            x = np.pad(x, ((0, 0), (0, 0), (0, pad)))
            return pack_bits(torch.from_numpy(x)).cuda()
        aw, bw = words(a), words(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = binary_matmul(aw if batch > 1 else aw[0],
                            bw if batch > 1 else bw[0])
        got = got.reshape(batch, M, N).cpu().numpy().astype(np.int64)
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = np.stack([crossbar_binary_matmul_ref(a[i], b[i],
                                                    device="cuda")
                         for i in range(batch)])
        engine_s = time.perf_counter() - t0
        check(np.array_equal(got, want + pad),
              f"binary_matmul != the crossbar engine at {batch}x{M}x{K}")
        check(np.array_equal(want, np.einsum("imk,ink->imn", a, b)),
              f"the crossbar engine != the ±1 product at {batch}x{M}x{K}")
        tiled = TiledBinaryMatvec(M, K)
        out.append({"batch": batch, "M": M, "K": K, "N": N, "Kw": -(-K // 32),
                    "tiles": tiled.gm * tiled.gk, "engine_runs":
                    batch * N * tiled.gm * tiled.gk, "kernel_wall_s":
                    kernel_s, "engine_wall_s": engine_s, "equal": True})
    emit("oracle", engine_backend="torch", cases=out)


# (arch, shape) cells whose real step the dryrun phase runs on the card,
# in order of preference; the second is taken only if it fits the memory
# then free with DRYRUN_SPARE_BYTES to spare, else the fallback
DRYRUN_REAL = (("mamba2-370m", "decode_32k"),
               ("whisper-tiny", "decode_32k"))
DRYRUN_FALLBACK = ("mamba2-370m", "long_500k")
DRYRUN_SPARE_BYTES = 2e9


def dryrun_real(torch, D, res: dict) -> dict:
    """The cell's real step on the card at its full production shape:
    measured peak and flop count against the dry run's."""
    from torch.utils.flop_counter import FlopCounterMode
    arch, shape = res["arch"], res["shape"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    step, args = D.build_step(D.get_config(arch), D.SHAPES[shape],
                              D.default_train_config(), "cuda")
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    count = FlopCounterMode(display=False)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with count:
        out = step(*args)
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    logits = out[0] if isinstance(out, tuple) else out
    check(bool(torch.isfinite(logits.float()).all()),
          f"{arch} {shape}: non-finite logits on the card")
    flops = float(count.get_total_flops())
    check(flops == res["raw_cost_analysis"]["flops"],
          f"{arch} {shape}: {flops} flops counted on the card, "
          f"{res['raw_cost_analysis']['flops']} on meta")
    first_ms = start.elapsed_time(end)
    del out, logits
    start.record()
    step(*args)
    end.record()
    torch.cuda.synchronize()
    mem = res["memory"]
    rec = {"arch": arch, "shape": shape, "first_step_ms": first_ms,
           "warm_step_ms": start.elapsed_time(end),
           "args_bytes": {"predicted": mem["args_bytes"],
                          "measured": args_bytes},
           "peak_bytes": {"predicted": mem["peak_bytes"], "measured": peak,
                          "ratio": peak / mem["peak_bytes"]},
           "flops": {"meta": res["raw_cost_analysis"]["flops"],
                     "card": flops},
           "analytic_flops": res["flops_per_device"]}
    del step, args
    torch.cuda.empty_cache()
    return rec


def phase_dryrun(torch, card: str) -> None:
    """Every cell's dry run on ``meta`` at full width, then the real step
    of up to two cells that fit, against the dry run's prediction."""
    import functools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import dryrun as D
    capacity = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    here = D.run_cell(*DRYRUN_REAL[0], capacity_bytes=capacity)
    check(torch.cuda.memory_allocated() == before,
          "the dry run allocated memory on the card")
    cells = [c for c in D.all_cells() if c != DRYRUN_REAL[0]]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        results = [here] + list(pool.map(
            functools.partial(D.run_cell, capacity_bytes=capacity),
            *zip(*cells)))
    wall = time.perf_counter() - t0
    by_cell = {(r["arch"], r["shape"]): r for r in results}
    check(len(by_cell) == len(D.all_cells())
          and all(r["ok"] for r in results), "a dry-run cell failed")
    emit("dryrun", card=card, capacity_bytes=capacity, wall_s=wall,
         cells=[{"arch": r["arch"], "shape": r["shape"],
                 "fits": r["memory"]["fits"],
                 "peak_bytes": r["memory"]["peak_bytes"],
                 "args_bytes": r["memory"]["args_bytes"],
                 "flops_counted": r["raw_cost_analysis"]["flops"],
                 "flops_analytic": r["flops_per_device"],
                 "bytes_counted": r["raw_cost_analysis"]["bytes"],
                 "bytes_analytic": r["bytes_per_device"],
                 "dominant": r["dominant"], "cell_wall_s": r["wall_s"]}
                for r in results])
    first = by_cell[DRYRUN_REAL[0]]
    check(first["memory"]["fits"], f"{DRYRUN_REAL[0]} does not fit")
    runs = [dryrun_real(torch, D, first)]
    second = by_cell[DRYRUN_REAL[1]]
    free, _ = torch.cuda.mem_get_info()
    if not (second["memory"]["fits"] and second["memory"]["peak_bytes"]
            + DRYRUN_SPARE_BYTES <= free):
        second = by_cell[DRYRUN_FALLBACK]
    runs.append(dryrun_real(torch, D, second))
    emit("dryrun_real", card=card, free_bytes_before_second=free,
         spare_bytes=DRYRUN_SPARE_BYTES, runs=runs)


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


# the apps record's launch counts: the three kernels the application
# pipelines reach on backend="kernels"
APP_KERNELS = ("binary_matmul", "splitk_matvec", "conv2d_shift")


def timed_launches(torch, fn):
    """``fn()``, its wall (ending in a device sync) and each kernel's
    launches during it."""
    counters = launch_counters()
    before = {n: f.launches for n, f in counters.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {n: f.launches - before[n]
                       for n, f in counters.items()}


def stage_record(rep, wall, launches) -> dict:
    """One pipeline run: each stage's label, the report's cycles and nJ,
    the wall and the launches."""
    return {"labels": {s.name: s.backend for s in rep.stages},
            "cycles": rep.cycles, "energy_nj": rep.energy_nj,
            "stage_cycles": {s.name: s.total_cycles for s in rep.stages},
            "wall_s": wall, "launches": launches}


def phase_apps(torch) -> dict:
    """The slice's application path at full width on ``backend="kernels"``:
    ``MATPIM_BNN``'s unreduced widths (512 → 2048 → 2048 → 2048 → 32, the
    reference's 256×512 crossbars of 16 partitions) on one input and on a
    batch of 64, a 1024×1024 8-bit matvec pipeline at the service's
    1024×1024 geometry, and the edge, sharpen and binary edge pipelines on
    a 512×512 4-bit image. Every output equals its numpy oracle; the three
    kernels' counts, zeroed just before and read just after, must rise."""
    from repro_torch.apps.bnn import BinaryMLP
    from repro_torch.apps.imaging import (BINARY_KERNELS, KERNELS,
                                          binary_edge_pipeline,
                                          edge_pipeline, edge_reference,
                                          ref_correlate, sharpen_pipeline)
    from repro_torch.apps.pipeline import MatvecStage, Pipeline
    counters = launch_counters()
    rng = np.random.default_rng(40)
    records = {}
    for fn in counters.values():
        fn.launches = 0

    model, build_s, _ = timed_launches(
        torch, lambda: BinaryMLP.random([512, 2048, 2048, 2048, 32], seed=0))
    x = rng.choice([-1, 1], size=512)
    (y, rep), wall, launched = timed_launches(
        torch, lambda: model.forward(x, backend="kernels"))
    want_y, want_dots = model.reference(x)
    check(np.array_equal(y, want_y) and np.array_equal(model.scores,
                                                       want_dots),
          "BNN forward != its numpy reference")
    records["bnn_forward"] = dict(stage_record(rep, wall, launched),
                                  build_s=build_s, dims=model.dims)
    X = rng.choice([-1, 1], size=(64, 512))
    (dots, acts), wall, launched = timed_launches(
        torch, lambda: model.forward_batch(X, backend="kernels"))
    a = X
    for W in model.weights[:-1]:
        a = np.where(a @ W.T >= 0, 1, -1)
    check(np.array_equal(dots, a @ model.weights[-1].T),
          "BNN forward_batch != its numpy reference")
    records["bnn_forward_batch"] = {"inputs": 64, "wall_s": wall,
                                    "launches": launched}

    A = rng.integers(0, 256, size=(1024, 1024))
    xv = rng.integers(0, 256, size=1024)
    pipe = Pipeline([MatvecStage(A, 8)], name="matvec")
    (yv, rep), wall, launched = timed_launches(
        torch, lambda: pipe.run(xv, backend="kernels"))
    check(np.array_equal(np.asarray(yv, dtype=np.int64),
                         (A @ xv) % (1 << 16)),
          "matvec pipeline != A @ x mod 2^16")
    records["matvec"] = stage_record(rep, wall, launched)

    img = rng.integers(0, 16, size=(512, 512))
    binar = np.where(img > 7, 1, -1)
    oracles = {
        "edge": (edge_pipeline, edge_reference(img)),
        "sharpen": (sharpen_pipeline,
                    np.clip(ref_correlate(img, KERNELS["sharpen"]), 0, 15)),
        "binary_edge": (binary_edge_pipeline, np.maximum(
            *(np.where(ref_correlate(binar, BINARY_KERNELS[k]) >= 0, 1, -1)
              for k in ("edge_v", "edge_h")))),
    }
    for name, (make, want) in oracles.items():
        pipe = make(img.shape)
        (out, rep), wall, launched = timed_launches(
            torch, lambda: pipe.run(img, backend="kernels"))
        check(np.array_equal(np.asarray(out, dtype=np.int64), want),
              f"{name} pipeline != its host reference")
        labels = [s.backend for s in rep.stages if s.kind != "host"]
        want_label = ("kernels:fallback-torch" if name == "binary_edge"
                      else "kernels")
        check(labels == [want_label] * len(labels),
              f"{name} pipeline labelled {labels}")
        records[name] = stage_record(rep, wall, launched)
    launches = {n: fn.launches for n, fn in counters.items()}
    for n in APP_KERNELS:
        check(launches[n] > 0, f"the apps phase launched no {n}")
    emit("apps", launches=launches, runs=records)
    return launches


FAULT_SPANS = ("engine.fault.draw", "engine.fault.copy")


def fault_run(torch, fn) -> dict:
    """``fn()`` on each of the card and the CPU under the tracer: its
    result per device, the walls and the host mask-drawing and copy
    shares (the ``engine.fault.*`` span totals over the wall)."""
    from repro_torch.obs import trace
    out, rec = {}, {}
    for dev in ("cuda", "cpu"):
        tr = trace.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out[dev] = fn(dev)
            torch.cuda.synchronize()
        finally:
            trace.disable()
        wall = time.perf_counter() - t0
        spans = {k: 0.0 for k in FAULT_SPANS}
        for ev in tr.events():
            if ev["name"] in spans:
                spans[ev["name"]] += ev["dur"] / 1e6
        rec[dev] = {"wall_s": wall,
                    "draw_s": spans["engine.fault.draw"],
                    "copy_s": spans["engine.fault.copy"],
                    "draw_copy_share": sum(spans.values()) / wall}
    return out, rec


def points(pts) -> list:
    return [[p.rate, p.samples, p.bit_error_rate, p.sign_error_rate,
             p.accuracy] for p in pts]


def phase_faults(torch) -> None:
    """``FaultModel`` runs on the card and on the CPU with the same seeds:
    every output must be bit-identical (every mask is drawn on the host).
    The Monte-Carlo sweeps at their defaults on both replay variants, TMR,
    the BNN fault sweep, and a ``PlanService(seed=0, backend="kernels")``
    flush of two faulty binary-matvec requests and one fault-free one."""
    import dataclasses

    from repro_torch.apps.bnn import BinaryMLP, fault_sweep
    from repro_torch.device import (FaultModel, binary_matvec_sweep,
                                    bnn_accuracy_sweep, tmr_binary_matvec)
    from repro_torch.serve import PlanService
    rates = [0.0, 1e-4, 1e-3, 1e-2]
    records, first = {}, None
    for variant in ("fused", "unfused"):
        out, rec = fault_run(torch, lambda d: points(binary_matvec_sweep(
            rates, backend=f"torch-{variant}", device=d)))
        check(out["cuda"] == out["cpu"],
              f"binary_matvec_sweep torch-{variant}: card != CPU")
        first = first or out["cuda"]
        check(out["cuda"] == first, "binary_matvec_sweep: fused != unfused")
        check(out["cuda"][0][2:4] == [0.0, 0.0],
              "binary_matvec_sweep: rate 0 != the fault-free run")
        records[f"binary_matvec_sweep:{variant}"] = dict(rec,
                                                         points=out["cuda"])
    out, rec = fault_run(torch, lambda d: points(
        bnn_accuracy_sweep(rates, device=d)))
    check(out["cuda"] == out["cpu"], "bnn_accuracy_sweep: card != CPU")
    check(out["cuda"][0][4] == 1.0, "bnn_accuracy_sweep: rate 0 not exact")
    records["bnn_accuracy_sweep"] = dict(rec, points=out["cuda"])
    out, rec = fault_run(torch, lambda d: dataclasses.asdict(
        tmr_binary_matvec(1e-3, samples=256, device=d)))
    check(out["cuda"] == out["cpu"], "tmr_binary_matvec: card != CPU")
    records["tmr"] = dict(rec, report=out["cuda"])
    model = BinaryMLP.from_config(n_layers=3)
    out, rec = fault_run(torch, lambda d: points(
        fault_sweep(model, [1e-4, 1e-3], samples=128, device=d)))
    check(out["cuda"] == out["cpu"], "fault_sweep: card != CPU")
    records["fault_sweep"] = dict(rec, points=out["cuda"])

    rng = np.random.default_rng(41)
    reqs = [(rng.choice([-1, 1], (1024, 384)), rng.choice([-1, 1], 384)),
            (rng.choice([-1, 1], (300, 500)), rng.choice([-1, 1], 500)),
            (rng.choice([-1, 1], (1024, 384)), rng.choice([-1, 1], 384))]

    def flush(dev):
        svc = PlanService(seed=0, backend="kernels", device=dev)
        tickets = [svc.submit_binary_matvec(
            A, x, faults=FaultModel.uniform(3e-3) if i < 2 else None)
            for i, (A, x) in enumerate(reqs)]
        svc.flush()
        return [(t.result.tolist(), t.backend) for t in tickets]

    out, rec = fault_run(torch, flush)
    check(out["cuda"] == out["cpu"], "faulty service flush: card != CPU")
    labels = [b for _, b in out["cuda"]]
    check(labels == ["kernels:fallback-torch"] * 2 + ["kernels"],
          f"faulty service flush labelled {labels}")
    A, x = reqs[2]
    check(out["cuda"][2][0] == np.where(A @ x >= 0, 1, -1).tolist(),
          "the fault-free request != sign(A @ x)")
    records["service_flush"] = dict(rec, labels=labels)
    emit("faults", runs=records)


def phase_mesh(kinds: dict, serial: dict, card: str) -> None:
    """Multi-device tile dispatch with two slots on one card: each engine
    plan's last batch on ``torch-fused`` over ``tile_mesh(devices=
    ["cuda:0"] * 2)`` must give the single-device images, labelled
    ``+mesh2``; one cold and one warm flush of the serve phase's requests on
    ``PlanService(devices=2, backend="kernels")`` must equal the oracles and
    the serial service's tickets, and launch the three served kernels
    (counts zeroed just before the cold flush, read after it). Walls beside
    the serial ones: both slots share the card, so no speed is claimed."""
    from repro_torch.core import execute
    from repro_torch.distributed.mesh_exec import tile_mesh
    from repro_torch.serve import PlanService
    mesh = tile_mesh(devices=["cuda:0"] * 2)
    engine = {}
    for name, (plan, mems, want, serial_ms) in kinds.items():
        cp = plan.compile()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = execute(cp, mems, backend="torch-fused", device="cuda",
                          mesh=mesh)
            walls.append((time.perf_counter() - t0) * 1e3)
        check(res.backend == "torch-fused+mesh2",
              f"{name} on the mesh labelled {res.backend}")
        check(np.array_equal(res.mem, want),
              f"{name} on two slots != one device")
        engine[name] = {"B": int(mems.shape[0]), "label": res.backend,
                        "mesh_ms": {"first": walls[0], "warm": walls[1]},
                        "serial_warm_ms": serial_ms}
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    svc = PlanService(backend="kernels", device="cuda", devices=2)
    try:
        reqs = serve_requests(np.random.default_rng(2))
        tickets, wall, spans = serve_round(svc, reqs)
        launches = {n: fn.launches for n, fn in counters.items()}
        for n in ("binary_matmul", "splitk_matvec", "conv2d_shift"):
            check(launches[n] > 0, f"the two-slot service launched no {n}")
        for name, t in tickets.items():
            s = serial["tickets"][name]
            check(np.array_equal(np.asarray(t.result, dtype=np.int64),
                                 np.asarray(s.result, dtype=np.int64))
                  and (t.cycles, t.backend) == (s.cycles, s.backend),
                  f"{name} on two slots != the serial flush")
        slots = sorted({t.device for t in tickets.values()})
        check(slots == [0, 1], f"the flush ran on slots {slots}")
        warm, warm_wall, _ = serve_round(
            svc, serve_requests(np.random.default_rng(3)))
    finally:
        svc.close()
    emit("mesh", card=card, engine=engine, serve={
        "launches": launches, "slots": slots,
        "cold_wall_s": wall, "warm_wall_s": warm_wall,
        "serial_cold_wall_s": serial["cold_wall_s"],
        "serial_warm_wall_s": serial["warm_wall_s"],
        "spans_ms": spans,
        "slot_of": {name: t.device for name, t in tickets.items()}})


# full-width model configs the lm phase serves in bf16 through the launcher,
# and those it also checks in float32
LM_SERVED = ("olmo-1b", "mamba2-370m", "granite-4.0-h-micro")
LM_F32 = ("olmo-1b", "mamba2-370m")
LM_PROMPT = 16
# float32 against float64 at full width, as a share of the float64 logits'
# largest magnitude (~170-210 on seeded weights). Sound float32 runs read at
# most 1.61e-3 of it (mamba2-370m on the card; 2.4e-4 on the CPU; olmo-1b
# 1.7e-4), the same float32 on the card with TF32 matmuls 4.0e-2 (olmo-1b)
# and 0.76 (mamba2-370m) (PERF.md §6, `python -m
# repro_torch.launch.precision`): the limit sits between, and the phase
# shows again that the TF32 run fails it. Each layer group rounds on the
# card within 0.5-2.1x of the CPU; what grows the drift to 1e-3 of scale is
# the depth (48 groups, gains of 1.4-2.4 each in groups 2-10), so the 1e-3
# absolute and the reference's elementwise 2e-2 hold at reduced size only
LM_F32_TOL = 5e-3


def _decode_bytes(model, params, B: int, S: int) -> int:
    """Bytes one decode step must move: every parameter once, and the
    whole cache (K/V rows or conv and SSM states) read once."""
    import torch
    from repro_torch.models.spec import param_bytes, tree_leaves
    cache = model.init_cache(B, S, model.cfg.dtype, device="meta")
    return param_bytes(params) + sum(
        t.numel() * t.element_size() for t in tree_leaves(cache)
        if isinstance(t, torch.Tensor))


def lm_check_f32(torch, arch: str) -> dict:
    """Full width in float32 on seeded weights: one 16-token prompt's
    forward logits on the card, on the CPU and on the CPU in float64 (the
    model built in float64 on the same weights widened). The card's and
    the CPU's logits must agree, and each must agree with the float64
    ones, within ``LM_F32_TOL`` of the float64 logits' largest magnitude;
    so must 16 decode steps on the card with the card's full forward. The
    card's forward with TF32 matmuls, the control, must miss that limit.
    In float64 the first 4 decode steps equal the forward within 1e-9 of
    that magnitude: decode and forward compute the same function, and
    what separates them in float32 is rounding."""
    from repro_torch.launch.precision import (f64_reference, prompt,
                                              seeded_f32, tf32)
    from repro_torch.models.spec import tree_map
    cfg, model, params = seeded_f32(arch)
    toks = prompt(cfg, LM_PROMPT)
    with torch.no_grad():
        cpu, _ = model.forward(params, {"tokens": toks})
        f64, dec64_err = f64_reference(cfg, params, toks, 4)
        gp = tree_map(lambda t: t.to("cuda"), params)
        del params
        gt = toks.to("cuda")
        with tf32(False):
            full, _ = model.forward(gp, {"tokens": gt})
        with tf32(True):
            control = model.forward(gp, {"tokens": gt})[0].cpu()
        card = full.cpu()
        check(bool(torch.isfinite(card).all()), f"{arch} f32 logits")
        scale = max(1.0, float(f64.abs().max()))
        check(dec64_err <= 1e-9 * scale, f"{arch} float64 decode differs "
              f"from the float64 forward by {dec64_err}")
        errs = {"card_vs_cpu": float((card - cpu).abs().max()),
                "card_vs_f64": float((card.double() - f64).abs().max()),
                "cpu_vs_f64": float((cpu.double() - f64).abs().max())}
        tf32_err = float((control.double() - f64).abs().max())
        cache = model.init_cache(1, LM_PROMPT, torch.float32, device="cuda")
        dec = 0.0
        with tf32(False):
            for t in range(LM_PROMPT):
                lg, cache = model.decode_step(
                    gp, cache, gt[:, t:t + 1],
                    torch.full((1,), t, dtype=torch.long, device="cuda"))
                dec = max(dec, float((lg[:, 0] - full[:, t]).abs().max()))
        errs["card_decode_vs_forward"] = dec
        for what, err in errs.items():
            check(err <= LM_F32_TOL * scale, f"{arch} f32 logits {what}: "
                  f"{err} over {LM_F32_TOL} of {scale}")
        check(tf32_err > LM_F32_TOL * scale, f"{arch}: the TF32 control "
              f"is off float64 by only {tf32_err}, within {LM_F32_TOL} of "
              f"{scale}: the limit would not reject it")
    del gp
    torch.cuda.empty_cache()
    return {"logits_max_abs_f64": scale, "limit_share": LM_F32_TOL,
            "f64_decode_vs_forward_max_abs_err": dec64_err,
            "tf32_control_vs_f64_max_abs_err": tf32_err,
            **{f"{k}_max_abs_err": v for k, v in errs.items()}}


def _lm_serve_counted(torch, arch: str) -> dict:
    """One serving run of ``arch`` through the launcher, summed up with
    what it counted (``decode_attention``'s launches, ``attention_decode``'s
    kernel and plain calls, the decode steps replayed from the engine's
    graph and run eagerly) and its memory; the engine is freed."""
    from repro_torch.kernels.decode_attention import \
        decode_attention as decode
    from repro_torch.launch.serve import serve
    from repro_torch.obs import metrics
    names = ("attention.decode.kernel", "attention.decode.plain",
             "model.decode.graph", "model.decode.eager")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    decode.launches = 0
    counts0 = [metrics.counter(n).value for n in names]
    rep = serve(arch, requests=8, max_new=16, max_batch=4, max_seq=128,
                device="cuda")
    eng = rep.pop("engine")
    rep.update(peak=torch.cuda.max_memory_allocated(), before=before,
               launches=decode.launches, timings=eng.timings(),
               capture_s=eng.graph.capture_s if eng.graph else None,
               step_bytes=_decode_bytes(eng.model, eng.params, eng.B, eng.S),
               max_batch=eng.B, max_seq=eng.S,
               counts={n.split(".", 2)[-1]: metrics.counter(n).value - v
                       for n, v in zip(names, counts0)})
    del eng
    torch.cuda.empty_cache()
    return rep


def lm_serve(torch, arch: str) -> dict:
    """Serve 8 requests (16 new tokens each, 4 slots, a 128-row cache)
    through the port's launcher at full width in the config's bf16, with
    weights from a seeded ``torch.Generator`` on the card: decode steps
    replayed from the engine's CUDA graph, then the same requests with
    every step eager (``DecodeGraph.takes`` patched to refuse), whose
    tokens must be the graph's."""
    from unittest import mock

    from repro_torch.models.lm import DecodeGraph
    rep = _lm_serve_counted(torch, arch)
    with mock.patch.object(DecodeGraph, "takes",
                           staticmethod(lambda cache: False)):
        eager = _lm_serve_counted(torch, arch)
    cfg, results = rep["cfg"], rep["results"]
    check(sorted(results) == list(range(8))
          and all(len(v) == 16 and all(0 <= t < cfg.vocab for t in v)
                  for v in results.values()),
          f"{arch}: served {results}")
    tm = rep["timings"]
    dec = sorted(tm["decode_ms"])
    eager_dec = sorted(eager["timings"]["decode_ms"])
    launches, counts = rep["launches"], rep["counts"]
    calls = [counts["kernel"], counts["plain"]]
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    check(launches == attn * len(dec) and calls == [launches, 0],
          f"{arch}: decode_attention launched {launches} times in "
          f"{len(dec)} decode steps of {attn} attention layers; "
          f"attention_decode's kernel and plain calls {calls}")
    check(rep["capture_s"] is not None and counts["graph"] == len(dec)
          and counts["eager"] == 0,
          f"{arch}: {counts['graph']} replayed and {counts['eager']} eager "
          f"decode steps of {len(dec)}")
    check(eager["capture_s"] is None and eager["counts"]["graph"] == 0
          and eager["counts"]["eager"] == len(eager_dec) == len(dec)
          and eager["launches"] == launches,
          f"{arch}: the eager run counted {eager['counts']} and "
          f"{eager['launches']} launches in {len(eager_dec)} steps")
    equal = sum(a == b for u in results
                for a, b in zip(results[u], eager["results"][u]))
    n_tok = sum(len(v) for v in results.values())
    check(equal == n_tok, f"{arch}: {equal} of {n_tok} tokens equal between "
          f"the graph's run and the eager run")
    step_bytes = rep["step_bytes"]
    return {"arch": arch, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "vocab_padded": cfg.vocab_padded, "params": rep["params"],
            "param_bytes": rep["param_bytes"], "requests": 8,
            "max_new": 16, "max_batch": rep["max_batch"],
            "max_seq": rep["max_seq"], "tokens": n_tok,
            "wall_s": rep["wall_s"], "tokens_per_s": n_tok / rep["wall_s"],
            "prefill_ms": tm["prefill_ms"],
            "decode_steps": len(dec), "decode_ms_median": dec[len(dec) // 2],
            "decode_ms_min": dec[0], "decode_ms_max": dec[-1],
            "decode_step_bytes": step_bytes,
            "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "weights_bound_ms": rep["param_bytes"] / HBM_BYTES_PER_S * 1e3,
            "decode_attention_launches": launches,
            "attention_decode_calls": dict(zip(("kernel", "plain"), calls)),
            "graph": {"capture_s": rep["capture_s"],
                      "decode_ms_median_graph": dec[len(dec) // 2],
                      "decode_ms_median_eager":
                          eager_dec[len(eager_dec) // 2],
                      "tokens_equal": equal, "tokens": n_tok,
                      "wall_s_eager": eager["wall_s"],
                      "launches_per_step": launches / len(dec)},
            "peak_memory_bytes": rep["peak"],
            "peak_memory_bytes_eager": eager["peak"],
            "allocated_before_bytes": rep["before"],
            "first_tokens": {u: results[u][:4] for u in range(2)}}


def _last_logits(torch, model, params, seq) -> "torch.Tensor":
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": torch.as_tensor(
            seq, dtype=torch.long, device="cuda")[None]})
    return logits[0, -1].float()


def lm_ssd_paths(torch, arch: str) -> dict:
    """``arch`` served as :func:`lm_serve` serves it, with every chunked
    scan through the ``ssd_scan`` kernel, then through the plain path
    (``mamba._kernel_takes`` patched to refuse): each run's
    ``mamba.ssd.kernel`` and ``mamba.ssd.plain`` counts (the kernel run's
    must be one a Mamba layer a prefill, with ``ssd_scan.launches`` equal,
    and none plain; the plain run's the reverse), and the greedy tokens
    equal, or at the first that parts, each path's logit gap between its
    token and the other's (a forward over the prompt and the tokens
    before it)."""
    from unittest import mock

    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.serve import serve
    from repro_torch.models import mamba
    from repro_torch.obs import metrics
    names = ("mamba.ssd.kernel", "mamba.ssd.plain")

    def run():
        counts0 = [metrics.counter(n).value for n in names]
        launches0 = SS.ssd_scan.launches
        rep = serve(arch, requests=8, max_new=16, max_batch=4, max_seq=128,
                    device="cuda")
        rep["counts"] = [metrics.counter(n).value - v
                         for n, v in zip(names, counts0)]
        rep["launches"] = SS.ssd_scan.launches - launches0
        return rep
    torch.cuda.empty_cache()
    kern = run()
    cfg = kern["cfg"]
    scans = 8 * sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    check(kern["counts"] == [scans, 0] and kern["launches"] == scans,
          f"{arch}: the kernel run counted {kern['counts']} scans "
          f"(kernel, plain) and {kern['launches']} launches; want {scans}")
    with mock.patch.object(mamba, "_kernel_takes", lambda *a: False):
        plain = run()
        del plain["engine"]
    check(plain["counts"] == [0, scans] and plain["launches"] == 0,
          f"{arch}: the plain run counted {plain['counts']} scans")
    parted = []
    for req in kern["requests"]:
        a, b = kern["results"][req.uid], plain["results"][req.uid]
        k = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), None)
        if k is None:
            continue
        seq = np.concatenate([req.prompt, a[:k]])
        eng = kern["engine"]
        lk = _last_logits(torch, eng.model, eng.params, seq)
        with mock.patch.object(mamba, "_kernel_takes", lambda *a: False):
            lp = _last_logits(torch, eng.model, eng.params, seq)
        parted.append({"uid": req.uid, "at": k, "kernel_token": a[k],
                       "plain_token": b[k],
                       "kernel_gap": float(lk[a[k]] - lk[b[k]]),
                       "plain_gap": float(lp[b[k]] - lp[a[k]]),
                       "logit_scale": float(lk.abs().max())})
    del kern["engine"]
    torch.cuda.empty_cache()
    n_tok = sum(len(v) for v in kern["results"].values())
    equal = sum(u == v for uid in kern["results"] for u, v in
                zip(kern["results"][uid], plain["results"][uid]))
    return {"arch": arch, "scans": scans, "launches": kern["launches"],
            "counts_kernel_run": dict(zip(("kernel", "plain"),
                                          kern["counts"])),
            "counts_plain_run": dict(zip(("kernel", "plain"),
                                         plain["counts"])),
            "tokens": n_tok, "tokens_equal": equal, "parted": parted,
            "wall_s": {"kernel": kern["wall_s"], "plain": plain["wall_s"]}}


def ssd_prefill(torch, arch: str = "granite-4.0-h-micro") -> dict:
    """One prefill of ``arch`` (``Model.forward`` at B = 1 in its bf16,
    weights from a seeded ``torch.Generator``) of each of ``SSD_SHAPES``
    tokens, with the scans on the kernel and on the plain path (patched):
    CUDA-event ms of the forward and of its scans (median of 3 after a
    warm-up), the scans each path counted, the forward's peak memory above
    the weights, and, in another forward, the largest peak of one scan
    above what was allocated when it began. The kernel path allocates no
    ``(c, h, l, l)`` float32 tensor: at 8000 tokens a scan's peak must fall
    by at least 1 GB."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, mamba
    from repro_torch.models.spec import init_params
    from repro_torch.obs import metrics
    cfg = get_config(arch)
    model = build_model(cfg)
    params = init_params(model.specs(),
                         torch.Generator(device="cuda").manual_seed(3),
                         cfg.dtype)
    orig = mamba.ssd_chunked
    g = torch.Generator(device="cuda").manual_seed(4)
    names = ("mamba.ssd.kernel", "mamba.ssd.plain")
    out = {"arch": arch}

    def forward(toks, scan):
        with torch.no_grad(), mock.patch.object(mamba, "ssd_chunked", scan):
            return model.forward(params, {"tokens": toks})

    for S in SSD_SHAPES:
        toks = torch.randint(0, cfg.vocab, (1, S), generator=g,
                             device="cuda")
        row = {}
        for path in ("kernel", "plain"):
            refuse = mock.patch.object(mamba, "_kernel_takes",
                                       lambda *a: False)
            with (refuse if path == "plain" else contextlib.nullcontext()):
                events, peaks = [], []

                def timed(*a, **k):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    res = orig(*a, **k)
                    e.record()
                    events.append((s, e))
                    return res

                def peaked(*a, **k):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    res = orig(*a, **k)
                    torch.cuda.synchronize()
                    peaks.append(torch.cuda.max_memory_allocated() - base)
                    return res
                trials = []
                counts0 = [metrics.counter(n).value for n in names]
                for _ in range(4):
                    events.clear()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    res = forward(toks, timed)
                    end.record()
                    torch.cuda.synchronize()
                    trials.append((start.elapsed_time(end),
                                   sum(a.elapsed_time(b) for a, b in events)))
                    del res
                counts = [metrics.counter(n).value - v
                          for n, v in zip(names, counts0)]
                torch.cuda.empty_cache()
                whole = peak_over(torch, lambda: forward(toks, orig))
                forward(toks, peaked)
                trials = sorted(trials[1:])
                row[path] = {"forward_ms": trials[1][0],
                             "scans_ms": trials[1][1],
                             "scans": len(events),
                             "counts": dict(zip(("kernel", "plain"),
                                                counts)),
                             "peak_bytes": whole,
                             "scan_peak_bytes": max(peaks)}
                torch.cuda.empty_cache()
        n_scans = row["kernel"]["scans"]
        check(row["kernel"]["counts"] == {"kernel": 4 * n_scans, "plain": 0}
              and row["plain"]["counts"] == {"kernel": 0,
                                             "plain": 4 * n_scans},
              f"{arch} prefill of {S}: scans counted {row}")
        out[S] = row
        emit("ssd_prefill", tokens=S, **row)
    fell = (out[SSD_SHAPES[-1]]["plain"]["scan_peak_bytes"]
            - out[SSD_SHAPES[-1]]["kernel"]["scan_peak_bytes"])
    check(fell >= 1e9, f"{arch}: a scan's peak at {SSD_SHAPES[-1]} tokens "
          f"fell by only {fell} bytes on the kernel")
    del model, params
    torch.cuda.empty_cache()
    return out


def phase_lm(torch, card: str) -> dict:
    """The model stack's serving path on the card at full width: olmo-1b,
    mamba2-370m and granite-4.0-h-micro served in bf16 through the
    launcher (per-request prefill ms and decode-step ms from CUDA events,
    tokens per second, peak memory, the decode step's bytes bound),
    olmo-1b and mamba2-370m checked in float32 (card against CPU, decode
    against the forward), the Mamba archs' scans on the kernel and on the
    plain path (:func:`lm_ssd_paths`, :func:`ssd_prefill`), and a forward
    of matpim-bnn. Any mismatch raises. Returns the launches of
    decode_attention and of ssd_scan in the bf16 serving runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.spec import init_params
    served = {}
    for arch in LM_SERVED:
        served[arch] = lm_serve(torch, arch)
    olmo = served["olmo-1b"]
    check((olmo["n_layers"], olmo["d_model"], olmo["vocab"]) ==
          (16, 2048, 50304) and olmo["dtype"] == "bfloat16",
          f"olmo-1b served at {olmo}")
    f32 = {arch: lm_check_f32(torch, arch) for arch in LM_F32}
    ssd = {arch: lm_ssd_paths(torch, arch) for arch in LM_SERVED
           if get_config(arch).ssm_state}
    prefill = ssd_prefill(torch)
    cfg = get_config("matpim-bnn")
    model = build_model(cfg)
    params = init_params(model.specs(),
                         torch.Generator(device="cuda").manual_seed(2),
                         cfg.dtype)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (4, 64))).long().cuda()
    bnn_ms = []
    with torch.no_grad():
        for _ in range(2):          # a first call, then a warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            bnn_ms.append((time.perf_counter() - t0) * 1e3)
    check(tuple(logits.shape) == (4, 64, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()),
          f"matpim-bnn logits {tuple(logits.shape)}")
    emit("lm", card=card, served=served, f32=f32, ssd=ssd,
         ssd_prefill=prefill,
         bnn={"n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "d_ff": cfg.d_ff, "batch": [4, 64], "forward_ms": {"first": bnn_ms[0],
                                                "warm": bnn_ms[1]},
              "dtype": cfg.dtype})
    return {"decode_attention": sum(s["decode_attention_launches"]
                                    for s in served.values()),
            "ssd_scan": sum(r["launches"] for r in ssd.values())}


# H100 SXM dense bf16 tensor-core rate (NVIDIA's data sheet): the train
# record's bound divides the analytic flops of launch/analytic.py by it,
# and its bytes by HBM_BYTES_PER_S
BF16_FLOPS_PER_S = 989e12
# olmo-1b at full width in bf16: the TrainConfig default (remat "full",
# float32 moments), no remat, and "dots" with int8 moments and two
# microbatches; SyntheticLM batch 8 × seq 256, 6 steps each
TRAIN_RUNS = ({"remat": "full", "opt_dtype": "float32", "microbatches": 1},
              {"remat": "none", "opt_dtype": "float32", "microbatches": 1},
              {"remat": "dots", "opt_dtype": "int8", "microbatches": 2})
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 6
# the three runs' first-step losses: one forward of the same weights on the
# same batch; "dots" with two microbatches runs half-batch bf16 products,
# whose rounding moves the mean loss: held to 2^-7 relative, two bf16 ulps
TRAIN_LOSS_TOL = 2 ** -7
# one float32 olmo-1b step against float64 at full width, as a share of
# each gradient leaf's largest float64 magnitude (of the loss and the
# gradient norm for those two). Seeded weights put the logits' spread in
# the hundreds (loss ~184), where the softmax is steep: sound float32 reads
# up to 9.31e-3 on the card and 9.35e-3 on the CPU (wk's gradient), TF32
# matmuls 0.50-1.08 (PERF.md §6, record train_f32). The limit sits 3.2x
# over the sound readings and 17x under the control's smallest leaf.
TRAIN_F32_TOL = 3e-2
BNN_STEPS, BNN_RESUME_STEPS = 10, 8


def train_run(torch, run: dict) -> dict:
    """olmo-1b trained ``TRAIN_STEPS`` steps at full width in bf16
    through ``launch.train.train`` (the CLI's path), no checkpoints:
    losses, step ms split into gradients and update (CUDA events), peak
    memory of each part, the optimizer state's bytes and the analytic
    bound. The parameters must have moved from their seeded draw, every
    leaf."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import analytic
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.models.spec import init_params, tree_leaves
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    rep = train("olmo-1b", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, ckpt_dir=None, device="cuda", **run)
    cfg, tc, losses = rep["cfg"], rep["tc"], rep["losses"]
    what = f"olmo-1b train {run}"
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.dtype) ==
          (16, 2048, 50304, "bfloat16"), f"{what}: config {cfg}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(rep["grad_norms"])), f"{what}: {losses}")
    init = init_params(build_model(cfg).specs(),
                       torch.Generator(device="cuda").manual_seed(0),
                       cfg.dtype)
    moved = [float((a.float() != b.float()).float().mean())
             for a, b in zip(tree_leaves(init), tree_leaves(rep["params"]))]
    del init
    check(all(m > 0 for m in moved), f"{what}: leaves unmoved {moved}")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    flops = analytic.cell_flops(cfg, shape, tc)
    nbytes = analytic.cell_bytes(cfg, shape, tc, rep["n_params"])
    bound = analytic.roofline_ms(flops, nbytes, BF16_FLOPS_PER_S,
                                 HBM_BYTES_PER_S)
    warm = slice(1, None)           # step 0 pays cuBLAS and allocator set-up
    step_ms = np.median(rep["step_ms"][warm])
    out = {**run, "n_params": rep["n_params"], "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
           "grad_norms": rep["grad_norms"],
           "step_ms": rep["step_ms"], "grads_ms": rep["grads_ms"],
           "update_ms": rep["update_ms"],
           "step_ms_median_warm": step_ms,
           "grads_ms_median_warm": np.median(rep["grads_ms"][warm]),
           "update_ms_median_warm": np.median(rep["update_ms"][warm]),
           "update_share": np.median(rep["update_ms"][warm]) / step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_bytes": rep["peak_memory_bytes"],
           "grads_peak_bytes": max(rep["grads_peak_bytes"]),
           "update_peak_bytes": max(rep["update_peak_bytes"]),
           "allocated_before_bytes": before,
           "opt_state_bytes": rep["opt_state_bytes"],
           "leaf_share_moved": moved, "flops": flops, "bytes": nbytes,
           **bound, "bound_over_step": bound["bound_ms"] / step_ms,
           "rates": {"bf16_flops_per_s": BF16_FLOPS_PER_S,
                     "hbm_bytes_per_s": HBM_BYTES_PER_S,
                     "source": "H100 SXM data sheet, dense"}}
    del rep
    torch.cuda.empty_cache()
    return out


def train_f32_check(torch) -> dict:
    """One olmo-1b step's loss and gradients at full width in float32 on
    the card (B 2, S 64, remat "full") against the same step of the model
    built in float64 on the same weights widened (every layer computes in
    float64, ``models.spec.wide``): the loss and gradient norm relative to
    float64's, each gradient leaf's largest error relative to that leaf's
    largest float64 magnitude. Sound float32 must stay within
    ``TRAIN_F32_TOL``; the same step with TF32 matmuls, the control, must
    miss it. The same float32 step on the host's CPU is read beside them
    (``cpu_f32``). Float64 parameters and gradients are 9.4 GB each."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.precision import tf32
    from repro_torch.models import build_model
    from repro_torch.models.spec import init_params, tree_leaves, tree_map
    from repro_torch.train import grad_norm, make_grad_fn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32")
    tc = TrainConfig()
    params = init_params(build_model(cfg).specs(),
                         torch.Generator(device="cuda").manual_seed(1),
                         "float32")
    batch = make_global_batch(SyntheticLM(cfg, batch=2, seq=64, seed=1)
                              .at_step(0), make_local_mesh("cuda"),
                              "float32")
    model64 = build_model(dataclasses.replace(cfg, dtype="float64"))
    loss64, g64 = make_grad_fn(model64, tc)(
        tree_map(lambda t: t.double(), params), batch)
    gn64 = float(grad_norm(g64))
    loss64 = float(loss64)
    g64 = tree_leaves(g64)
    scales = [float(g.abs().max()) for g in g64]

    def shares(tf: bool, device="cuda") -> dict:
        with tf32(tf):
            loss, g = make_grad_fn(build_model(cfg), tc)(
                tree_map(lambda t: t.to(device), params),
                {k: v.to(device) for k, v in batch.items()})
            gn = float(grad_norm(g))
        leaves = [float((a.to("cuda").double() - b).abs().max()) / s
                  for a, b, s in zip(tree_leaves(g), g64, scales)]
        return {"loss": abs(float(loss) - loss64) / abs(loss64),
                "grad_norm": abs(gn - gn64) / gn64, "leaves": leaves,
                "max": max([abs(float(loss) - loss64) / abs(loss64),
                            abs(gn - gn64) / gn64] + leaves)}

    sound = shares(False)
    control = shares(True)
    peak = torch.cuda.max_memory_allocated()
    cpu = shares(False, "cpu")      # the same float32 step on the host
    del params, g64
    torch.cuda.empty_cache()
    for what, r in (("card", sound), ("CPU", cpu)):
        check(r["max"] <= TRAIN_F32_TOL, f"olmo-1b f32 train step on the "
              f"{what} off float64 by {r['max']} of scale, over "
              f"{TRAIN_F32_TOL}")
    check(control["max"] > TRAIN_F32_TOL, f"olmo-1b: the TF32 control is "
          f"off float64 by only {control['max']} of scale, within "
          f"{TRAIN_F32_TOL}: the limit would not reject it")
    return {"arch": "olmo-1b", "dtype": "float32", "batch": [2, 64],
            "remat": tc.remat, "loss_f64": loss64, "grad_norm_f64": gn64,
            "leaf_scales_f64": scales, "sound": sound,
            "tf32_control": control, "cpu_f32": cpu,
            "limit_share": TRAIN_F32_TOL, "allocated_before_bytes": before,
            "peak_memory_bytes": peak}


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True)`` for the block, with the
    cuBLAS workspace setting it asks for (read when a product launches),
    both restored after. The CUDA embedding backward otherwise adds with
    atomics in an order that changes from run to run."""
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def train_bnn(torch) -> dict:
    """matpim-bnn at full width (4 × 512, vocab 32768, the binary FFN's
    straight-through signs) in its bf16: ``BNN_STEPS`` steps at lr 1e-3 on
    one batch, the loss must end below where it began
    (``tests/test_models_smoke.py::test_binary_ffn_model`` at full width;
    deterministic algorithms, so the card's run repeats). Then ``run_resilient_loop`` over SyntheticLM
    batches with a checkpoint every 3 steps, once clean and once with a
    failure injected at step 4: the second restores step 3 and must end at
    the first's parameters and optimizer state bit for bit (both under
    deterministic algorithms). The save and restore walls of the final
    state."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.distributed.fault_tolerance import run_resilient_loop
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.models.spec import init_params, tree_leaves
    from repro_torch.train import make_train_step
    cfg = get_config("matpim-bnn")
    check(cfg.binary_ffn and (cfg.n_layers, cfg.d_model, cfg.vocab) ==
          (4, 512, 32768), f"matpim-bnn config {cfg}")
    model = build_model(cfg)
    mesh = make_local_mesh("cuda")
    step_fn, opt = make_train_step(model, TrainConfig(lr=1e-3))
    params = init_params(model.specs(),
                         torch.Generator(device="cuda").manual_seed(2),
                         cfg.dtype)
    state = (params, opt.init(params))
    # the reference test's batch: B 2 × S 32 tokens and targets drawn
    # uniformly over the vocabulary (numpy seed 0)
    rng = np.random.default_rng(0)
    one = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))).cuda()
           for k in ("tokens", "targets")}
    p, s = state
    losses = []
    with deterministic(torch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BNN_STEPS):
            p, s, m = step_fn(p, s, one)
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        fit_s = time.perf_counter() - t0
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"matpim-bnn loss did not fall: {losses}")
    del p, s
    src = SyntheticLM(cfg, batch=8, seq=128, seed=2)

    class Counting(Checkpointer):
        def __init__(self, directory):
            super().__init__(directory)
            self.restored = []

        def restore(self, like, step=None):
            self.restored.append(step)
            return super().restore(like, step)

    def batch_at(i):
        return make_global_batch(src.at_step(i), mesh, cfg.dtype)

    with deterministic(torch), tempfile.TemporaryDirectory() as tmp:
        def run(name, fail_at):
            ck = Counting(os.path.join(tmp, name))
            ck.save(0, state, block=True)
            return run_resilient_loop(step_fn, state, batch_at, ck,
                                      n_steps=BNN_RESUME_STEPS, ckpt_every=3,
                                      fail_at=fail_at), ck
        clean, _ = run("clean", None)
        faulty, ck = run("faulty", {4: RuntimeError("injected at step 4")})
        check(ck.restored == [3], f"matpim-bnn restores {ck.restored}")
        differ = [i for i, (a, b) in enumerate(zip(tree_leaves(clean),
                                                   tree_leaves(faulty)))
                  if not torch.equal(a, b)]
        check(not differ, f"matpim-bnn resumed run differs from the clean "
              f"one at leaves {differ}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(99, faulty, block=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = ck.restore(faulty, 99)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves(faulty))),
            "matpim-bnn checkpoint round trip")
        d = os.path.join(ck.dir, "step_99")
        disk = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    return {"arch": "matpim-bnn", "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "fit_batch": [2, 32],
            "losses": losses, "fit_wall_s": fit_s, "resume_batch": [8, 128],
            "resume": {"steps": BNN_RESUME_STEPS, "ckpt_every": 3,
                       "fail_at": 4, "restored_step": 3,
                       "compare": "bit for bit, deterministic algorithms"},
            "ckpt_save_s": save_s, "ckpt_restore_s": restore_s,
            "ckpt_disk_bytes": disk,
            "ckpt_leaves": len(tree_leaves(faulty))}


# the sharded dry-run cells of the dist phase: (arch, shape, multi_pod)
DIST_CELLS = (("olmo-1b", "train_4k", False), ("olmo-1b", "decode_32k", False),
              ("mamba2-370m", "train_4k", False),
              ("mamba2-370m", "decode_32k", False),
              ("olmo-1b", "train_4k", True))
DIST_REQUESTS, DIST_NEW, DIST_STEPS = 8, 16, 3


@contextlib.contextmanager
def sdpa_decode():
    """Plain caches decoded through ``_sdpa``, as DTensor caches are: the
    plain run that does the sharded run's arithmetic. Through the
    ``decode_attention`` kernel a plain run sums each softmax in another
    order, and a random model's greedy tokens may part at a near tie."""
    from unittest import mock

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.obs import metrics
    plain = metrics.counter("attention.decode.plain")
    before = plain.value
    with mock.patch.object(DA, "DTYPES", ()):
        yield
    check(plain.value > before, "no decode went through _sdpa")


def agreement(a: dict, b: dict) -> dict:
    """Where two runs' greedy tokens part: each uid's first differing
    index (None where all agree) and the count of equal tokens."""
    first = {u: next((i for i, (x, y) in enumerate(zip(a[u], b[u]))
                      if x != y), None) for u in a}
    return {"tokens_equal": sum(x == y for u in a
                                for x, y in zip(a[u], b[u])),
            "tokens": sum(len(v) for v in a.values()),
            "first_difference": first}


def dist_serve(torch, mesh) -> dict:
    """olmo-1b served at full width in bf16 on ``mesh``: tokens per uid,
    decode-step ms (CUDA events; median over the warm steps) and peak
    memory."""
    from repro_torch.launch.serve import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep = serve("olmo-1b", requests=DIST_REQUESTS, max_new=DIST_NEW,
                device="cuda", mesh=mesh)
    dec = rep["engine"].timings()["decode_ms"]
    out = {"results": rep["results"], "wall_s": rep["wall_s"],
           "decode_ms": dec, "decode_ms_median_warm": float(np.median(
               dec[1:])), "peak_memory_bytes":
           torch.cuda.max_memory_allocated()}
    del rep
    torch.cuda.empty_cache()
    return out


def dist_train(torch, mesh) -> dict:
    """olmo-1b trained ``DIST_STEPS`` steps at full width in bf16 on
    ``mesh`` (remat "full", float32 moments, batch 8 × 256): losses,
    step ms (CUDA events), peak memory and the updated parameters (this
    rank's shards, on the card)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.train import train
    from repro_torch.models.spec import tree_leaves
    torch.cuda.empty_cache()
    rep = train("olmo-1b", steps=DIST_STEPS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, remat="full", opt_dtype="float32",
                ckpt_dir=None, device="cuda", mesh=mesh)
    params = [p.to_local() if isinstance(p, DTensor) else p
              for p in tree_leaves(rep["params"])]
    out = {"losses": rep["losses"], "step_ms": rep["step_ms"],
           "step_ms_median_warm": float(np.median(rep["step_ms"][1:])),
           "peak_memory_bytes": rep["peak_memory_bytes"], "params": params}
    del rep
    torch.cuda.empty_cache()
    return out


# the ckpt record: olmo-1b with int8 moments, a checkpoint every 2 steps of
# 4, a failure injected at step 3; the free disk it needs, in checkpoints
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT, CKPT_ROOM = 4, 2, 3, 2.5


def dist_ckpt(torch, mesh, local) -> dict:
    """Sharded checkpoints of olmo-1b at full width in bf16 (int8 moments,
    remat "full", batch 8 × 256) on ``mesh``: (a) ``CKPT_STEPS`` steps
    through ``run_resilient_loop`` with ``Checkpointer(keep=1)``, a
    checkpoint every ``CKPT_EVERY``; (b) the same with a failure injected
    at step ``CKPT_FAIL_AT`` on every rank, which restores step 2 and must
    end bit-equal to (a) in every parameter, moment and the step count
    (both under deterministic algorithms); (c) that step-2 checkpoint
    restored onto plain tensors (``shardings`` on ``local``), then steps 2
    and 3, within ``TRAIN_LOSS_TOL`` of (a)'s losses and ``TRAIN_F32_TOL``
    of each parameter's scale (bit-equality reported). The directory must
    hold ``CKPT_ROOM`` checkpoints free; (a)'s is deleted before (b), so
    at most two exist at once. Walls of each save's snapshot and
    background write and of each restore, bytes on disk, each save's extra
    peak of allocated memory."""
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.distributed.fault_tolerance import run_resilient_loop
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  distribute_tree, use_mesh)
    from repro_torch.models import build_model
    from repro_torch.models.spec import (axes_tree, init_params, tree_leaves,
                                         tree_map)
    from repro_torch.train import make_train_step
    cfg = get_config("olmo-1b")
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.dtype) ==
          (16, 2048, 50304, "bfloat16"), f"ckpt: config {cfg}")
    model = build_model(cfg)
    step_fn, opt = make_train_step(model, TrainConfig(
        lr=1e-3, remat="full", opt_state_dtype="int8"))
    src = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.empty_cache()
    with use_mesh(mesh):
        params = distribute_tree(init_params(
            model.specs(), torch.Generator(device="cuda").manual_seed(0),
            cfg.dtype), axes_tree(model.specs()), mesh, params=True)
        state = (params, opt.init(params))
    del params
    n_leaves = len(tree_leaves(state))
    wide = (torch.bfloat16, torch.float32)
    one = sum(t.numel() * (4 if t.dtype in wide else t.element_size())
              for t in tree_leaves(state))
    on_plain = tree_map(lambda t: NamedSharding(local, (None,) * t.ndim),
                        state)

    def local_of(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    class Probe(Checkpointer):
        """Times each save's snapshot (with its extra peak of allocated
        memory) and background write, and each restore; on its first
        restore also restores the same step onto plain tensors (c)."""

        def __init__(self, directory):
            super().__init__(directory, keep=1)
            self.saves, self.writes, self.restores = [], [], []
            self.plain = None

        def save(self, step, tree, extra=None, block=False):
            self.wait()                 # the previous write, untimed
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = synced()
            super().save(step, tree, extra, block)
            self.saves.append({
                "step": step, "snapshot_s": time.perf_counter() - t0,
                "extra_peak_bytes": torch.cuda.max_memory_allocated()
                - before})

        def wait(self):
            super().wait()
            if self.write_s is not None:
                self.writes.append(self.write_s)
                self.write_s = None

        def restore(self, like, step=None, shardings=None):
            t0 = synced()
            out = super().restore(like, step, shardings)
            self.restores.append({"step": step, "onto": "mesh",
                                  "s": synced() - t0})
            if self.plain is None:
                t0 = synced()
                self.plain = super().restore(like, step, on_plain)[0]
                self.restores.append({"step": step, "onto": "plain",
                                      "s": synced() - t0})
            return out

    def batch_at(i, on=mesh):
        return make_global_batch(src.at_step(i), on, cfg.dtype)

    def run(directory, fail_at):
        ck, losses = Probe(directory), {}
        with deterministic(torch), use_mesh(mesh):
            out = run_resilient_loop(
                step_fn, state, batch_at, ck, n_steps=CKPT_STEPS,
                ckpt_every=CKPT_EVERY, fail_at=fail_at,
                on_metrics=lambda s, m: losses.__setitem__(
                    s, float(m["loss"])))
        return out, [losses[s] for s in sorted(losses)], ck

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"ckpt: {free} bytes free in {tmp}; one checkpoint is {one} "
              f"bytes", flush=True)
        check(free >= CKPT_ROOM * one,
              f"ckpt: {free} bytes free in {tmp}, under {CKPT_ROOM} "
              f"checkpoints of {one} bytes: point TMPDIR at a larger disk")
        clean, clean_losses, ck_a = run(os.path.join(tmp, "clean"), None)
        d = os.path.join(ck_a.dir, f"step_{CKPT_STEPS}")
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))
        check(ck_a.steps() == [CKPT_STEPS] and len(os.listdir(d)) ==
              n_leaves + 1, f"ckpt: {ck_a.steps()} kept")
        shutil.rmtree(ck_a.dir)
        faulty, faulty_losses, ck_b = run(
            os.path.join(tmp, "faulty"),
            {CKPT_FAIL_AT: RuntimeError("injected at step 3")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check([r["step"] for r in ck_b.restores if r["onto"] == "mesh"] == [2],
          f"ckpt: restores {ck_b.restores}")
    differ = [i for i, (a, b) in enumerate(zip(tree_leaves(clean),
                                               tree_leaves(faulty)))
              if not torch.equal(local_of(a), local_of(b))
              or type(a) is not type(b)
              or getattr(a, "placements", None)
              != getattr(b, "placements", None)]
    check(not differ, f"ckpt: the resumed run differs from the clean one at "
          f"leaves {differ}")
    check(faulty_losses == clean_losses,
          f"ckpt: losses {faulty_losses} against {clean_losses}")
    # (c): steps 2 and 3 on plain tensors from the sharded step-2 checkpoint
    p_state, plain_losses = ck_b.plain, []
    check(not any(isinstance(t, DTensor) for t in tree_leaves(p_state)),
          "ckpt: the restore onto plain tensors gave DTensors")
    with deterministic(torch), use_mesh(local):
        for i in range(CKPT_FAIL_AT - 1, CKPT_STEPS):
            *p_state, m = step_fn(*p_state, batch_at(i, local))
            plain_losses.append(float(m["loss"]))
    check(all(abs(a - b) <= TRAIN_LOSS_TOL * abs(b) for a, b in
              zip(plain_losses, clean_losses[CKPT_FAIL_AT - 1:])),
          f"ckpt: plain losses {plain_losses} against {clean_losses}")
    worst = 0.0
    for a, b in zip(tree_leaves(p_state[0]), tree_leaves(clean[0])):
        b = local_of(b)
        diff = float((a.float() - b.float()).abs().max())
        scale = max(1.0, float(b.float().abs().max()))
        check(diff <= TRAIN_F32_TOL * scale,
              f"ckpt: a parameter restored onto plain tensors moved {diff} "
              f"at scale {scale}")
        worst = max(worst, diff)
    bit_equal = all(torch.equal(a, local_of(b)) for a, b in zip(
        tree_leaves(p_state), tree_leaves(clean)))
    wall = time.perf_counter() - t_start
    del clean, faulty, p_state, state
    ck_b.plain = None
    torch.cuda.empty_cache()
    return {"arch": "olmo-1b", "dtype": "bfloat16", "opt_dtype": "int8",
            "remat": "full", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": CKPT_STEPS, "ckpt_every": CKPT_EVERY, "keep": 1,
            "fail_at": CKPT_FAIL_AT, "leaves": n_leaves,
            "checkpoint_bytes": one, "disk_bytes": disk,
            "free_bytes_before": free, "room_needed": CKPT_ROOM,
            "losses": clean_losses, "resumed_bit_equal": True,
            "restored_step": 2, "saves": {"clean": ck_a.saves,
                                          "faulty": ck_b.saves},
            "writes_s": {"clean": ck_a.writes, "faulty": ck_b.writes},
            "restores": ck_b.restores,
            "plain": {"losses": plain_losses, "loss_tol": TRAIN_LOSS_TOL,
                      "param_tol": TRAIN_F32_TOL,
                      "param_max_abs_diff": worst,
                      "state_bit_equal": bit_equal},
            "wall_s": wall}


# split_reductions: the float32 values and gradients of the blocked
# softmax and logsumexp no further from a float64 run of the whole than
# torch's float32 function of the whole is, plus SPLIT_TOL of scale (the
# tests' limit), and within SPLIT_TORCH_TOL of scale of torch's float32
# (torch sums the 50304 terms of a loss row in another order, and on some
# devices further from float64 than the blocks do); the blocks of the
# reduced axis; the decode position
SPLIT_TOL, SPLIT_TORCH_TOL, SPLIT_BLOCKS, SPLIT_POS = 1e-6, 3e-5, 4, 23


def split_reductions(torch, mesh) -> dict:
    """The softmax and logsumexp of a split axis on the card, cut into
    ``SPLIT_BLOCKS`` blocks (the ``split_reductions`` entry of record
    ``dist``): values and gradients against a float64 run and torch's
    float32 function of the whole. Raises on a miss."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    cfg = get_config("olmo-1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    decode = torch.randn((4, kv, rep, 1, 128), device="cuda",
                         generator=gen) * 4
    decode[..., SPLIT_POS + 1:] = -1e30
    loss = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.vocab), device="cuda",
                       generator=gen) * 4

    def across_blocks(t, op):
        # the blocks on axis -2 stand in for the ranks of an all-reduce
        return t.amax(-2, keepdim=True) if op == "max" \
            else t.sum(-2, keepdim=True)

    def blocked(fn, x):
        blocks = x.unflatten(-1, (SPLIT_BLOCKS, -1))
        if fn == "softmax":
            return spmd.block_softmax(blocks, -1, across_blocks).flatten(-2)
        return spmd.block_logsumexp(blocks, -1, across_blocks).squeeze(-1)

    def value_and_grad(f, x, g):
        x = x.detach().requires_grad_()
        y = f(x)
        (gx,) = torch.autograd.grad(y, x, g.to(x.dtype))
        return y.detach(), gx

    def err(a, b):
        b = b.double()
        return float((a.double() - b).abs().max()) / max(
            1.0, float(b.abs().max()))

    out = {"limit_f64": SPLIT_TOL, "limit_torch": SPLIT_TORCH_TOL,
           "blocks": SPLIT_BLOCKS, "decode_position": SPLIT_POS}
    for name, x in (("decode_logits", decode), ("loss_logits", loss)):
        for fn in ("softmax", "logsumexp"):
            plain = getattr(torch, fn)
            g = torch.randn(plain(x, -1).shape, device="cuda", generator=gen)
            got = value_and_grad(lambda t: blocked(fn, t), x, g)
            f32 = value_and_grad(lambda t: plain(t, -1), x, g)
            f64 = value_and_grad(lambda t: plain(t, -1), x.double(), g)
            row = {"shape": list(x.shape)}
            for i, part in enumerate(("value", "grad")):
                row[f"{part}_err_f64"] = err(got[i], f64[i])
                row[f"{part}_err_torch"] = err(got[i], f32[i])
                row[f"torch_{part}_err_f64"] = err(f32[i], f64[i])
                check(row[f"{part}_err_f64"]
                      <= row[f"torch_{part}_err_f64"] + SPLIT_TOL
                      and row[f"{part}_err_torch"] <= SPLIT_TORCH_TOL,
                      f"blocked {fn} of {name}: {row}")
            dt = DTensor.from_local(x, mesh.device_mesh,
                                    [Replicate(), Shard(x.ndim - 1)],
                                    run_check=False)
            row["mesh_1x1_bit_equal"] = bool(torch.equal(
                getattr(spmd, fn)(dt, -1).to_local(), f32[0]))
            check(row["mesh_1x1_bit_equal"],
                  f"spmd.{fn} on the 1x1 mesh differs from torch's")
            out[f"{name}_{fn}"] = row
            del got, f32, f64, dt
    del decode, loss
    torch.cuda.empty_cache()
    return out


def phase_dist(torch, card: str) -> None:
    """Sharded steps on a one-rank NCCL group against plain tensors, and
    the sharded dry run in spawned workers meanwhile (record ``dist``);
    then sharded checkpoints on the same group (record ``ckpt``,
    :func:`dist_ckpt`). Any failed check raises; the group is torn down
    either way."""
    import functools
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_analysis import (CollectiveMeter,
                                                 collective_bytes)
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    capacity = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=len(DIST_CELLS),
            mp_context=multiprocessing.get_context("spawn")) as pool, \
            tempfile.TemporaryDirectory() as tmp:
        cells = pool.map(functools.partial(D.run_cell, mesh="16x16",
                                           capacity_bytes=capacity),
                         *zip(*DIST_CELLS))
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            local = make_local_mesh("cuda")
            plain_serve = dist_serve(torch, local)
            with sdpa_decode():
                plain_sdpa = dist_serve(torch, local)
            serve_meter = CollectiveMeter()
            with serve_meter:
                sharded_serve = dist_serve(torch, mesh)
            plain_train = dist_train(torch, local)
            train_meter = CollectiveMeter()
            with train_meter:
                sharded_train = dist_train(torch, mesh)
            ckpt = dist_ckpt(torch, mesh, local)
            split = split_reductions(torch, mesh)
        finally:
            dist.destroy_process_group()
        card_s = time.perf_counter() - t0
        cells = list(cells)
    wall = time.perf_counter() - t0
    check(sharded_serve["results"] == plain_sdpa["results"],
          "sharded serving's greedy tokens differ from plain tensors' "
          "decoded through _sdpa")
    check(len(sharded_serve["results"]) == DIST_REQUESTS
          and all(len(v) == DIST_NEW
                  for v in sharded_serve["results"].values()),
          f"served {sharded_serve['results']}")
    pl, sh = plain_train["losses"], sharded_train["losses"]
    check(len(sh) == DIST_STEPS and all(np.isfinite(sh)) and all(
        abs(a - b) <= TRAIN_LOSS_TOL * abs(b) for a, b in zip(sh, pl)),
        f"sharded losses {sh} against plain {pl}")
    worst, bit_equal = 0.0, True
    for a, b in zip(sharded_train["params"], plain_train["params"]):
        check(a.shape == b.shape, f"{a.shape} against {b.shape}")
        diff = float((a.float() - b.float()).abs().max())
        scale = max(1.0, float(b.float().abs().max()))
        check(diff <= TRAIN_F32_TOL * scale,
              f"an updated parameter moved {diff} at scale {scale}")
        worst = max(worst, diff)
        bit_equal = bit_equal and bool(torch.equal(a, b))
    check(all(r["ok"] for r in cells), "a sharded dry-run cell failed")

    def coll(meter):
        raw, _, wire = collective_bytes(meter.records)
        kinds = sorted({k for k, _, _ in meter.records})
        return {"count": len(meter.records), "kinds": kinds,
                "operand_bytes": raw, "wire_bytes": wire}

    def times(plain, sharded, key):
        return {"plain": plain[key], "sharded": sharded[key],
                "ratio": sharded[key] / plain[key]}
    emit("dist", card=card, process_group="nccl, 1 rank",
         mesh={"data": 1, "model": 1}, arch="olmo-1b", dtype="bfloat16",
         serve={"requests": DIST_REQUESTS, "max_new": DIST_NEW,
                "tokens_equal": True,
                "kernel_vs_sharded": agreement(plain_serve["results"],
                                               sharded_serve["results"]),
                "decode_ms_median_warm": times(plain_serve, sharded_serve,
                                               "decode_ms_median_warm"),
                "decode_ms": {"plain": plain_serve["decode_ms"],
                              "sharded": sharded_serve["decode_ms"]},
                "peak_memory_bytes": times(plain_serve, sharded_serve,
                                           "peak_memory_bytes"),
                "collectives": coll(serve_meter)},
         train={"steps": DIST_STEPS, "batch": TRAIN_BATCH,
                "seq": TRAIN_SEQ, "remat": "full", "opt_dtype": "float32",
                "losses": {"plain": pl, "sharded": sh},
                "loss_tol": TRAIN_LOSS_TOL, "param_tol": TRAIN_F32_TOL,
                "param_max_abs_diff": worst, "params_bit_equal": bit_equal,
                "step_ms_median_warm": times(plain_train, sharded_train,
                                             "step_ms_median_warm"),
                "step_ms": {"plain": plain_train["step_ms"],
                            "sharded": sharded_train["step_ms"]},
                "peak_memory_bytes": times(plain_train, sharded_train,
                                           "peak_memory_bytes"),
                "collectives": coll(train_meter)},
         dryrun=[{"arch": r["arch"], "shape": r["shape"],
                  "mesh": r["mesh"], "chips": r["chips"],
                  "peak_bytes": r["memory"]["peak_bytes"],
                  "args_bytes": r["memory"]["args_bytes"],
                  "fits": r["memory"]["fits"],
                  "collective_bytes": r["collective_bytes"],
                  "collective_wire_bytes": r["collective_wire_bytes"],
                  "collective_s": r["roofline"]["collective_s"],
                  "dominant": r["dominant"], "cell_wall_s": r["wall_s"]}
                 for r in cells],
         split_reductions=split, card_work_s=card_s, wall_s=wall)
    emit("ckpt", card=card, process_group="nccl, 1 rank",
         mesh={"data": 1, "model": 1}, **ckpt)


def phase_train(torch, card: str) -> None:
    """The model stack's training half on the card: olmo-1b at full width
    in bf16 under three configurations (record ``train``), one float32
    step against float64 with a TF32 control (``train_f32``), and
    matpim-bnn's training, resume after an injected failure and
    checkpoint walls (``train_bnn``). Any failed check raises."""
    runs = [train_run(torch, run) for run in TRAIN_RUNS]
    full, none, dots = runs
    check(full["grads_peak_bytes"] < none["grads_peak_bytes"],
          f"remat full's forward+backward peak {full['grads_peak_bytes']} "
          f"is not below none's {none['grads_peak_bytes']}")
    first = none["losses"][0]
    for r in runs:
        check(abs(r["losses"][0] - first) <= TRAIN_LOSS_TOL * abs(first),
              f"first-step losses {[x['losses'][0] for x in runs]}")
    emit("train", card=card, runs=runs, loss_tol=TRAIN_LOSS_TOL)
    emit("train_f32", card=card, **train_f32_check(torch))
    emit("train_bnn", card=card, **train_bnn(torch))


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
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "none"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "none"),
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
    kinds = phase_engine()
    launches, serial = phase_serve()
    phase_mesh(kinds, serial, name_limit)
    phase_serve_auto_store()
    phase_tune(name_limit)
    launches.update({n: v for n, v in phase_ops(torch).items()
                     if n in ("conv2d_shift_tiled", "binary_conv2d")})
    phase_apps(torch)
    phase_faults(torch)
    launches.update(phase_lm(torch, name_limit))
    phase_train(torch, name_limit)
    phase_oracle(torch)
    phase_dryrun(torch, name_limit)
    phase_dist(torch, name_limit)
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
