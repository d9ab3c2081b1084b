"""Serving engine: continuous-batching prefill + decode with a KV cache,
the port of ``src/repro/serve/engine.py``.

:class:`Engine` handles prefill → cache handoff (the prompt's cache set
into the request's slot by :meth:`Model.write_slot`, which alone knows the
cache's format), slot-based continuous batching, EOS retirement, and
greedy or temperature sampling. The batching loop is host-side, as in
real serving systems. Prefill runs eagerly on the parameters' device. A
decode step over a plain cache on the card is replayed from one CUDA
graph, captured when the engine is built over its ``max_batch`` slots and
``max_seq`` rows (:class:`~repro_torch.models.lm.DecodeGraph`): each step
copies its tokens and write positions into the graph's static inputs and
replays it. Elsewhere (the CPU, a DTensor cache on a mesh, a float64
cache) the step runs eagerly (:meth:`Model.decode_step`); both run the
same body, which writes the cache where it lies.

On a process-group mesh (``use_mesh``) the engine serves DTensor
parameters: the cache is placed by ``Model.cache_axes``, a prefill's
rows are written into each rank's own block of it, and the logits are
gathered whole to the host, where sampling reads them.

Every prefill and decode step is timed on the device: CUDA events on a
card (read into a number once the step's logits reach the host, which
waits for them anyway), the host clock on the CPU. :meth:`Engine.timings`
returns them.

With :mod:`repro_torch.obs.trace` enabled, the engine's host work is
spanned: ``engine.admit`` (``uid``, ``prompt_len``, ``slot``) with its
``engine.admit.handoff`` (the prefill's cache rows set into the slot) and
``engine.admit.first_token`` (the last logits to the host, sampled), and
``engine.step`` (``live`` slots; its self time is the token feed) with its
``engine.step.fetch`` (the logits to the host, ``bytes``) and
``engine.step.sample`` (sampling and retirement); the model's own spans
nest inside (a replayed step: one ``model.decode_step`` span with
``graph=1``). Counters of :mod:`repro_torch.obs.metrics`, always on:
``engine.tokens``, every token sampled; ``engine.host_copy_bytes``, the
bytes of every logits tensor copied to the host; ``model.decode.graph``
and ``model.decode.eager``, the decode steps replayed and run eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from ..distributed.sharding import distribute_tree
from ..models.lm import DecodeGraph, Model
from ..models.spec import torch_dtype, tree_leaves
from ..obs import metrics as _metrics
from ..obs.trace import span as _span


def _host(x: torch.Tensor) -> np.ndarray:
    """Logits on the host for sampling (a DTensor gathered whole), their
    bytes counted in ``engine.host_copy_bytes``."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    x = x.float()
    _metrics.counter("engine.host_copy_bytes").inc(x.nbytes)
    return x.cpu().numpy()


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S_prompt,) int
    max_new: int = 32
    out: Optional[List[int]] = None
    done: bool = False


class _Timer:
    """Device time of one call: CUDA events on a card, the host clock
    (after the call returns) on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> "_Timer":
        if self.cuda:
            self.t1.record()
        else:
            self.t1 = time.perf_counter()
        return self

    def ms(self) -> float:
        if self.cuda:
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1)
        return (self.t1 - self.t0) * 1e3


class Engine:
    """Continuous batching over ``max_batch`` slots of a ``max_seq`` cache.

    ``temperature > 0`` samples from the softmax of the logits at that
    temperature with ``generator`` (a ``numpy.random.Generator``, required
    then); greedy decoding (the default) takes the argmax and needs none.
    """

    def __init__(self, model: Model, params, max_batch: int = 8,
                 max_seq: int = 256, temperature: float = 0.0,
                 eos_id: int = -1,
                 generator: Optional[np.random.Generator] = None):
        if temperature > 0 and generator is None:
            raise ValueError("temperature > 0 samples: pass a generator "
                             "(numpy.random.Generator)")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.B = max_batch
        self.S = max_seq
        self.temperature = temperature
        self.eos_id = eos_id
        self.generator = generator
        self.cache = distribute_tree(
            model.init_cache(self.B, self.S, torch_dtype(self.cfg.dtype),
                             device=self.device), model.cache_axes())
        self.graph = (DecodeGraph(model, params, self.cache)
                      if DecodeGraph.takes(self.cache) else None)
        self.pos = np.zeros(self.B, np.int64)         # next write index / slot
        self.slots: List[Optional[Request]] = [None] * self.B
        self._prefill_ms: Dict[int, float] = {}
        self._decode_ms: List[float] = []

    # -- prefill --------------------------------------------------------------

    def _prefill(self, tokens):
        """Single-request prefill; returns (last_logits, per-layer caches)."""
        logits, caches = self.model.forward(self.params, {"tokens": tokens})
        return logits[:, -1], caches

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot; False if the engine is
        full."""
        try:
            slot = self.slots.index(None)
        except ValueError:
            return False
        with _span("engine.admit", uid=req.uid, prompt_len=len(req.prompt),
                   slot=slot):
            self._admit(req, slot)
        return True

    def _admit(self, req: Request, slot: int) -> None:
        timer = _Timer(self.device)
        toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                               device=self.device)[None, :]
        last_logits, caches = self._prefill(toks)
        with _span("engine.admit.handoff"):
            self.model.write_slot(self.cache, caches, slot)
        timer.stop()
        self.pos[slot] = toks.shape[1]
        req.out = []
        with _span("engine.admit.first_token"):
            first = self._sample(_host(last_logits)[0])
        self._prefill_ms[req.uid] = timer.ms()
        req.out.append(int(first))
        self.slots[slot] = req

    # -- decode ---------------------------------------------------------------

    def _sample(self, logits: np.ndarray) -> int:
        _metrics.counter("engine.tokens").inc()
        logits = logits[: self.cfg.vocab]
        if self.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / self.temperature)
        p = p / p.sum()
        return int(self.generator.choice(len(p), p=p))

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One decode step for every live slot; returns [(uid, token)]."""
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return []
        with _span("engine.step", live=len(live)):
            return self._step(live)

    def _step(self, live: List[int]) -> List[Tuple[int, int]]:
        feed = np.zeros((2, self.B), np.int64)   # each slot's token, pos
        for i in live:
            feed[0, i] = self.slots[i].out[-1]
        feed[1] = self.pos
        feed = torch.from_numpy(feed)
        if self.graph is not None:
            self.graph.feed.copy_(feed)
            _metrics.counter("model.decode.graph").inc()
            timer = _Timer(self.device)
            logits = self.graph.replay()
        else:
            feed = feed.to(self.device)
            _metrics.counter("model.decode.eager").inc()
            timer = _Timer(self.device)
            logits, _ = self.model.decode_step(
                self.params, self.cache, feed[0][:, None], feed[1])
        timer.stop()
        out = []
        with _span("engine.step.fetch") as sp:
            logits_np = _host(logits)
            sp.set(bytes=logits_np.nbytes)
        self._decode_ms.append(timer.ms())
        logits_np = logits_np[:, 0]
        with _span("engine.step.sample"):
            for i in live:
                req = self.slots[i]
                tok = self._sample(logits_np[i])
                req.out.append(tok)
                self.pos[i] += 1
                out.append((req.uid, tok))
                if tok == self.eos_id or len(req.out) >= req.max_new \
                        or self.pos[i] >= self.S - 1:
                    req.done = True
                    self.slots[i] = None
        return out

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve a list of requests to completion (continuous batching)."""
        pending = list(requests)
        results: Dict[int, List[int]] = {}
        while pending or any(s is not None for s in self.slots):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            self.step()
            for r in requests:
                if r.done and r.uid not in results:
                    results[r.uid] = r.out
        return results

    def timings(self) -> Dict[str, object]:
        """Device milliseconds of every prefill (``{uid: ms}``: model
        forward and cache handoff) and every decode step (a list: the
        graph's replay, or the eager step), in order. On a card: CUDA
        events."""
        return {"prefill_ms": dict(self._prefill_ms),
                "decode_ms": list(self._decode_ms)}


__all__ = ["Engine", "Request"]
