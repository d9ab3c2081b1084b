"""granite-4.0-h-micro through the port's normal path, held to the plain
float32 reference, the benchmark's ``bench/reference/hybrid.py``, on the
CPU, at a small size with its μP multipliers, GQA and the gated norm on.

The port-only fields of ``ModelConfig`` (``norm_eps``, the μP multipliers,
``attention_multiplier``, ``ssm_gated_norm``) at their defaults add no
operation; ``ssd_chunked`` takes a sequence of any length and gives
today's bits where it is a multiple of the chunk; the spans ``model.mamba``
and ``mamba.ssd`` and the counters ``mamba.ssd.tokens``,
``mamba.ssd.pad_rows`` and ``mamba.decode.state_copy_bytes`` read what the
model did.

Tolerances, each against the reference's largest logit magnitude (or the
tensor's): ``REF_TOL`` = 1e-5 for float32 logits, forward or decoded
through the cache. Both sides compute in float32; they differ in the order
of their sums and in the form of the scan (the port's chunked SSD with
float32 cumulative decays, the reference's quadratic form with float64
ones), which read 2.4e-7 here, 40 times under it. ``SCAN_TOL`` = 1e-5 for
the ragged scan against the step-by-step recurrence, for the same reasons.
"""
import ast
import collections
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))   # the benchmark's harness and reference

from bench import harness  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.configs.granite_4_0_h_micro import CONFIG  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

REF_TOL = 1e-5
SCAN_TOL = 1e-5
CHUNK = 16            # the SSD's chunk at this size (CHUNK, patched)
SEED = 2 ** 31 + 5
CPU = torch.device("cpu")
ref = harness.reference("hybrid")


def small(**over):
    """granite-4.0-h-micro's smoke size in float32: one period of ten
    layers, GQA 4 on 2, the published multipliers, ε and gated norm."""
    return dataclasses.replace(get_config("granite-4.0-h-micro-smoke"),
                               dtype="float32", n_kv_heads=2, **over)


@pytest.fixture
def chunk16(monkeypatch):
    monkeypatch.setattr(M, "CHUNK", CHUNK)


def _case(cfg):
    model = build_model(cfg)
    return model, harness.make_params(model.specs(), cfg.dtype, SEED, CPU)


def _tokens(n, seed, vocab):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g)


def _close(got, want, tol):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, scale, err / scale)


# -- the configuration --------------------------------------------------------

def test_config_is_found_and_kept_out_of_the_registry():
    assert get_config("granite-4.0-h-micro") is CONFIG
    assert "granite-4.0-h-micro" not in REGISTRY
    smoke = get_config("granite-4.0-h-micro-smoke")
    assert smoke == CONFIG.reduced() and smoke.n_layers == 10
    assert [CONFIG.is_attn_layer(i) for i in range(40)].count(True) == 4
    assert [i for i in range(40) if CONFIG.is_attn_layer(i)] == \
        [5, 15, 25, 35]
    assert CONFIG.hd == 64 and CONFIG.ssm_heads == 64
    assert CONFIG.vocab_padded == CONFIG.vocab == 100352


def test_bench_config_gives_the_port_constant():
    file = harness.config("granite-4.0-h-micro")
    assert harness.model_config(file) == CONFIG
    # the published keys, as the source states them, say the same
    assert (file["hidden_size"], file["num_hidden_layers"],
            file["num_attention_heads"], file["num_key_value_heads"],
            file["shared_intermediate_size"], file["vocab_size"],
            file["mamba_d_state"], file["mamba_d_head"],
            file["mamba_n_heads"] * file["mamba_d_head"],
            file["mamba_d_conv"], file["rms_norm_eps"]) == (
        CONFIG.d_model, CONFIG.n_layers, CONFIG.n_heads, CONFIG.n_kv_heads,
        CONFIG.d_ff, CONFIG.vocab, CONFIG.ssm_state, CONFIG.ssm_headdim,
        CONFIG.di, CONFIG.conv_dim, CONFIG.norm_eps)
    assert file["layer_types"] == [
        "attention" if CONFIG.is_attn_layer(i) else "mamba"
        for i in range(CONFIG.n_layers)]
    assert file["reduced"] == []


def test_plain_reference_imports_only_torch_and_the_standard_library():
    tree = ast.parse(Path(ref.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert roots <= {"__future__", "math", "torch"}, roots


def test_plain_reference_raises_for_what_it_does_not_cover():
    cfg = dataclasses.asdict(small())
    for bad in ({"n_experts": 4}, {"rope": "standard"}, {"family": "ssm"},
                {"norm": "layernorm"}):
        with pytest.raises(ValueError):
            ref.logits({**cfg, **bad}, {}, torch.zeros(1, dtype=torch.long))


# -- the model against the reference -----------------------------------------

@pytest.mark.parametrize("S", [11, 32, 37],
                         ids=["under-a-chunk", "two-chunks", "ragged"])
def test_forward_matches_plain_reference(chunk16, S):
    cfg = small()
    model, params = _case(cfg)
    toks = _tokens(S, S, cfg.vocab)
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": toks[None]})
    want = ref.logits(dataclasses.asdict(cfg), params, toks)
    _close(got[0], want, REF_TOL)


def test_prefill_then_decode_match_the_reference_forward(chunk16):
    """A ragged prompt of 37 prefilled into slot 1 of two, then 12 tokens
    decoded through the cache: each step's logits against the reference's
    full forward over the whole sequence."""
    cfg = small()
    model, params = _case(cfg)
    toks = _tokens(49, 7, cfg.vocab)
    P = 37
    want = ref.logits(dataclasses.asdict(cfg), params, toks)
    cache = model.init_cache(2, 64, torch.float32, device="cpu")
    with torch.no_grad():
        logits, caches = model.forward(params, {"tokens": toks[None, :P]})
        _close(logits[0], want[:P], REF_TOL)
        for name, c in caches.items():
            dst = cache["layers"][name]
            for k, v in c.items():
                if k in ("k", "v"):
                    dst[k][:, 1, :P] = v[:, 0]
                else:
                    dst[k][:, 1] = v[:, 0]
        for t in range(P, 49):
            step = torch.stack([toks[t], toks[t]])[:, None]
            logits, cache = model.decode_step(params, cache, step,
                                              torch.tensor([t, t]))
            _close(logits[1, 0], want[t], REF_TOL)


def test_engine_serves_prompts_of_any_length(chunk16):
    """``Engine.admit`` and ``Engine.step`` over prompts shorter than the
    convolution's window, under a chunk, a multiple of it and ragged, on
    two slots (recycled): every served token is the reference's best at its
    position, up to ``REF_TOL`` of the logits' scale."""
    cfg = small()
    model, params = _case(cfg)
    rng = np.random.default_rng(3)
    lens = [2, 11, 32, 37]
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    eng = Engine(model, params, max_batch=2, max_seq=64)
    got = eng.run([Request(uid=i, prompt=p, max_new=6)
                   for i, p in enumerate(prompts)])
    d = dataclasses.asdict(cfg)
    for i, p in enumerate(prompts):
        out = got[i]
        assert len(out) == 6
        seq = torch.as_tensor(np.concatenate([p, out[:-1]]))
        rows = ref.logits(d, params, seq)[len(p) - 1:, :cfg.vocab]
        gap = rows.max(-1).values - rows[torch.arange(6), torch.tensor(out)]
        assert gap.max().item() <= REF_TOL * rows.abs().max().item(), gap


# -- the chunked scan ---------------------------------------------------------

def _ssd_unpadded(x, dt, A, B, C, D, chunk, init_state=None):
    """``mamba.ssd_chunked`` as it stood before it took ragged chunks (a
    sequence that is a multiple of the chunk), kept to hold the new one to
    its bits."""
    acc = torch.float32
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    c = s // chunk
    xf = x.to(acc).reshape(b, c, chunk, h, p)
    dtf = dt.to(acc).reshape(b, c, chunk, h)
    Bf = B.to(acc).reshape(b, c, chunk, n)
    Cf = C.to(acc).reshape(b, c, chunk, n)
    dA = dtf * A
    dAt = dA.movedim(-1, -2)
    cs = torch.cumsum(dAt, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    Ldec = torch.exp(diff.masked_fill(~mask, float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    att = scores[:, :, None] * Ldec
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", att, dtf, xf)
    dA_cum = torch.cumsum(dA, dim=2)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bf, dtf * decay_to_end,
                          xf)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])
    carry = (init_state if init_state is not None
             else torch.zeros((b, h, p, n), dtype=acc))
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)
    in_decay = torch.exp(dA_cum)
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cf, in_decay,
                           prev_states)
    y = y_intra + y_inter + D[None, None, :, None] * xf
    return y.reshape(b, s, h, p).to(x.dtype), carry


def _scan_inputs(s, seed, b=2, h=3, p=4, n=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    A = -torch.rand(h, generator=g) * 2 - 0.1
    B = torch.randn(b, s, n, generator=g)
    C = torch.randn(b, s, n, generator=g)
    D = torch.randn(h, generator=g)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("s", [7, 16, 48])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_bit_equal_at_multiples_of_the_chunk(s, carried):
    x, dt, A, B, C, D = _scan_inputs(s, s)
    init = (torch.randn(2, 3, 4, 5, generator=torch.Generator()
                        .manual_seed(1)) if carried else None)
    got = M.ssd_chunked(x, dt, A, B, C, D, chunk=CHUNK, init_state=init)
    want = _ssd_unpadded(x, dt, A, B, C, D, CHUNK, init_state=init)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("s", [17, 37, 47])
def test_ragged_ssd_matches_the_recurrence(s):
    x, dt, A, B, C, D = _scan_inputs(s, s)
    pads = metrics.counter("mamba.ssd.pad_rows").value
    y, state = M.ssd_chunked(x, dt, A, B, C, D, chunk=CHUNK)
    assert metrics.counter("mamba.ssd.pad_rows").value - pads == \
        2 * (-s % CHUNK)
    h = torch.zeros(2, 3, 4, 5)
    ys = []
    for t in range(s):
        yt, h = M.ssd_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, h)
        ys.append(yt)
    assert y.shape == x.shape
    _close(y, torch.stack(ys, dim=1), SCAN_TOL)
    _close(state, h, SCAN_TOL)


def test_ssd_paths_are_counted():
    """Off the card every scan is the plain path's, counted in
    ``mamba.ssd.plain``: float32 and float64 on the CPU, with gradients on,
    and on ``meta``; ``mamba.ssd.kernel`` does not move, and the plain
    path's bits are :func:`mamba.ssd_plain`'s."""
    x, dt, A, B, C, D = _scan_inputs(37, 5)
    kernel = metrics.counter("mamba.ssd.kernel").value
    plain = metrics.counter("mamba.ssd.plain").value
    got = M.ssd_chunked(x, dt, A, B, C, D, chunk=CHUNK)
    want = M.ssd_plain(x, dt, A, B, C, D, CHUNK)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    M.ssd_chunked(*(t.double() for t in (x, dt, A, B, C, D)), chunk=CHUNK)
    xg = x.clone().requires_grad_()
    y, _ = M.ssd_chunked(xg, dt, A, B, C, D, chunk=CHUNK)
    y.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    y, state = M.ssd_chunked(*(t.to("meta") for t in (x, dt, A, B, C, D)),
                             chunk=CHUNK)
    assert y.shape == x.shape and state.shape == (2, 3, 4, 5)
    assert metrics.counter("mamba.ssd.plain").value - plain == 4
    assert metrics.counter("mamba.ssd.kernel").value == kernel


# -- defaults add no operation ------------------------------------------------

class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten operators run under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _ops(cfg, S=12) -> collections.Counter:
    """The operators of a forward over ``S`` tokens and a decode step."""
    model = build_model(cfg)
    params = harness.make_params(model.specs(), "float32", SEED, CPU)
    cache = model.init_cache(2, 32, torch.float32, device="cpu")
    toks = _tokens(S, 1, cfg.vocab)
    mode = _Ops()
    with torch.no_grad(), mode:
        model.forward(params, {"tokens": toks[None]})
        model.decode_step(params, cache, toks[:2, None],
                          torch.tensor([3, 5]))
    return mode.ops


def test_defaults_add_no_operation():
    """olmo-1b's smoke config at the defaults runs the operators of the
    same config with a multiplier set, less exactly the ones that
    multiplier adds: one on the embedding and one on the logits in each of
    the forward and the decode step, two a layer in each for the residual
    branches. So no default multiplies or divides by 1.0. ``norm_eps`` and
    ``attention_multiplier`` change no operator."""
    base = dataclasses.replace(get_config("olmo-1b-smoke"), dtype="float32")
    n = base.n_layers
    default = _ops(base)
    for over, extra in (
            ({"embedding_multiplier": 12.0}, {"aten.mul": 2}),
            ({"logits_scaling": 8.0}, {"aten.div": 2}),
            ({"residual_multiplier": 0.22}, {"aten.mul": 4 * n}),
            ({"norm_eps": 1e-5}, {}),
            ({"attention_multiplier": 0.015625}, {})):
        ops = _ops(dataclasses.replace(base, **over))
        assert (dict(ops - default), dict(default - ops)) == (extra, {}), \
            over


def test_ungated_mamba_adds_no_operation():
    """mamba2-370m's smoke config (``ssm_gated_norm`` off) has no ``norm``
    leaf, and runs the operators of the gated one less the gated norm's,
    the same ones in each Mamba layer of the forward and the decode
    step."""
    base = dataclasses.replace(get_config("mamba2-370m-smoke"),
                               dtype="float32")
    assert "norm" not in build_model(base).specs()["layers"]["sub0"]["mamba"]
    gated = dataclasses.replace(base, ssm_gated_norm=True)
    spec = build_model(gated).specs()["layers"]["sub0"]["mamba"]["norm"]
    assert spec.shape == (base.n_layers, base.di) and spec.init == "ones"
    default, ops = _ops(base), _ops(gated)
    more = ops - default
    assert not default - ops
    # the stacked weight unbound into its layers once a call
    assert more.pop("aten.unbind") == 2
    assert more and all(n % (2 * base.n_layers) == 0
                        for n in more.values()), more


# -- the attention scale ------------------------------------------------------

def _decode_inputs(dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 1, 8, 64, generator=g).to(dtype)
    k = torch.randn(3, 40, 2, 64, generator=g).to(dtype)
    v = torch.randn(3, 40, 2, 64, generator=g).to(dtype)
    pos = torch.tensor([0, 17, 39])
    return [t.to(device) for t in (q, k, v, pos)]


def test_decode_attention_takes_the_configs_scale():
    """With ``attention_multiplier`` 1/64 the plain decode attention and
    the operator divide the logits by 64, as ``_sdpa`` does, bit for
    bit; without it by sqrt(hd), as before."""
    q, k, v, pos = _decode_inputs()
    valid = (torch.arange(40)[None, :] <= pos[:, None])[:, None, :]
    cfg = small()
    assert L.logit_divisor(cfg, 64) == 64.0
    want = L._sdpa(q, k, v, valid, cfg)
    assert torch.equal(decode_attention_plain(q, k, v, pos, 64.0), want)
    assert torch.equal(decode_attention(q, k, v, pos, 64.0), want)
    plain = L._sdpa(q, k, v, valid, None)
    assert torch.equal(decode_attention(q, k, v, pos), plain)
    assert torch.equal(decode_attention(q, k, v, pos, math.sqrt(64)), plain)
    assert not torch.equal(want, plain)


@pytest.mark.cuda
def test_decode_attention_kernel_takes_the_configs_scale():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, pos = _decode_inputs(dt, "cuda")
        got = decode_attention(q, k, v, pos, 64.0).float()
        want = decode_attention_plain(q, k, v, pos, 64.0).float()
        tol = 1e-2 if dt == torch.bfloat16 else 1e-5
        assert (got - want).abs().max().item() <= tol


# -- spans and counters -------------------------------------------------------

def test_mamba_spans_and_counters(chunk16):
    """A ragged prefill of 37 tokens (a tail of 5 rows, 11 padded) and a
    decode step on two slots: ``model.mamba`` inside each ``model.group``
    with its ``tokens`` and ``tail``, ``mamba.ssd`` inside it; the scan's
    tokens and padded rows counted a Mamba layer, and each decode step's
    state copies counted in bytes."""
    cfg = small()
    model, params = _case(cfg)
    n_mamba = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    cache = model.init_cache(2, 64, torch.float32, device="cpu")
    read = lambda n: metrics.counter(n).value  # noqa: E731
    before = {n: read(n) for n in ("mamba.ssd.tokens", "mamba.ssd.pad_rows",
                                   "mamba.decode.state_copy_bytes")}
    trace.enable(trace.Tracer())
    try:
        with torch.no_grad():
            model.forward(params, {"tokens": _tokens(37, 2, cfg.vocab)[None]})
            model.decode_step(params, cache, torch.tensor([[1], [2]]),
                              torch.tensor([0, 4]))
    finally:
        events = trace.disable().events()
    by = collections.defaultdict(list)
    for e in events:
        by[e["name"]].append(e)
    mixers = by["model.mamba"]
    assert len(mixers) == 2 * n_mamba
    assert [(e["args"]["tokens"], e["args"]["tail"]) for e in mixers] == \
        [(37, 5)] * n_mamba + [(2, 0)] * n_mamba
    groups = by["model.group"]
    for e in mixers:
        assert any(g["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= g["ts"] + g["dur"]
                   and e["args"]["depth"] == g["args"]["depth"] + 1
                   for g in groups)
    scans = by["mamba.ssd"]
    assert [(e["args"]["tokens"], e["args"]["pad_rows"]) for e in scans] == \
        [(37, 11)] * n_mamba
    for e in scans:
        assert any(m["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= m["ts"] + m["dur"]
                   and e["args"]["depth"] == m["args"]["depth"] + 1
                   for m in mixers)
    assert read("mamba.ssd.tokens") - before["mamba.ssd.tokens"] == \
        37 * n_mamba
    assert read("mamba.ssd.pad_rows") - before["mamba.ssd.pad_rows"] == \
        11 * n_mamba
    conv = (cfg.conv_dim - 1) * (cfg.di + 2 * cfg.ssm_state) * 4
    ssm = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
    copied = read("mamba.decode.state_copy_bytes") \
        - before["mamba.decode.state_copy_bytes"]
    assert copied == 2 * (conv + ssm) * n_mamba
