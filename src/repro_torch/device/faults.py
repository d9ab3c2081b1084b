"""Device-fault state for the torch executors.

Half of ``src/repro/device/faults.py``.

The port carries the part of the reference module its executors import:
the :class:`FaultModel` dataclass, ``IDEAL``, ``as_rng``, the packed
Bernoulli helpers, and explicit :class:`FaultRealization` masks with the
realization source the replay consumes. Realizations are sampled on the
host with a numpy ``Generator`` and packed into the canonical word layout
(uint32 words with a leading ``W = ceil(B/32)`` axis, bit ``b`` of word
``w`` = crossbar ``32w + b``); the executors move them to the device.

``FaultModel`` *sampling* inside an executor (the reference's
``sample_stuck_words`` and ``_ModelSource``) is not ported yet:
:func:`make_fault_source` raises ``NotImplementedError`` for a model.

Fault mechanisms (all independent, per crossbar instance): stuck-at-0/1
cells (``buf = (buf | sa1) & ~sa0`` after the load and after every write),
per-gate-evaluation switching failures (the output keeps its old value),
and per-cell init-disturb flips inside bulk-init rectangles.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-mechanism fault probabilities. The default is the ideal device:
    all zero, and property-tested bit-identical to fault-free execution."""

    p_sa0: float = 0.0     # per-cell stuck-at-0 probability (static map)
    p_sa1: float = 0.0     # per-cell stuck-at-1 probability (static map)
    p_switch: float = 0.0  # per gate evaluation: output fails to switch
    p_init: float = 0.0    # per cell per init cycle: value disturbed (flipped)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f.name}={v} outside [0, 1]")
        if self.p_sa0 + self.p_sa1 > 1.0:
            raise ValueError("p_sa0 + p_sa1 > 1: stuck states are exclusive")

    @property
    def is_ideal(self) -> bool:
        """True for the all-zero (default) model.

        >>> FaultModel().is_ideal, FaultModel(p_switch=1e-3).is_ideal
        (True, False)
        """
        return (self.p_sa0 == self.p_sa1 == self.p_switch == self.p_init
                == 0.0)

    @classmethod
    def uniform(cls, rate: float) -> "FaultModel":
        """All four mechanisms at the same ``rate`` — the sweep axis used by
        the Monte-Carlo fault-rate→accuracy curves.

        >>> FaultModel.uniform(1e-3).p_switch
        0.001
        """
        return cls(p_sa0=rate / 2, p_sa1=rate / 2, p_switch=rate, p_init=rate)


IDEAL = FaultModel()


def as_rng(rng) -> np.random.Generator:
    """Normalize ``None`` / seed / Generator into a numpy Generator."""
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


# ---------------------------------------------------------------------------
# Packed Bernoulli sampling (bit b of each word = crossbar b of the chunk)
# ---------------------------------------------------------------------------


def pack_sample_bits(bits: np.ndarray) -> np.ndarray:
    """(B, *shape) {0,1} -> (W, *shape) uint32 words, ``W = ceil(B/32)``,
    bit ``b`` of word ``w`` = sample ``32w + b``."""
    pb = np.packbits(np.ascontiguousarray(bits, dtype=np.uint8), axis=0,
                     bitorder="little")
    W = -(-bits.shape[0] // 32)
    out = np.zeros((W,) + bits.shape[1:], np.uint32)
    for g in range(pb.shape[0]):
        out[g >> 2] |= pb[g].astype(np.uint32) << np.uint32(8 * (g & 3))
    return out


def bernoulli_words(rng: np.random.Generator, p: float, shape: Tuple[int, ...],
                    B: int) -> np.ndarray:
    """(W,) + shape words of independent Bernoulli(p) bits: one realization
    per crossbar in the batch (bits >= B in the last word stay zero — they
    are never unpacked). The draw is ``rng.random((B,) + shape)`` in
    *logical* sample order, so same-seed values are independent of the
    packed layout."""
    if p <= 0.0:
        return np.zeros((-(-B // 32),) + shape, dtype=np.uint32)
    return pack_sample_bits(rng.random((B,) + shape) < p)


# ---------------------------------------------------------------------------
# Explicit fault realizations (per original trace cycle, backend-agnostic)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultRealization:
    """A concrete fault draw for one compiled trace, as boolean arrays.

    Masks are indexed by the *original* cycle index ``t`` and compile-time op
    slot ``w`` (executors that re-sort ops per cycle translate through the
    segment permutation), so the same realization means the same physical
    event set no matter how the replay is batched or fused:

    * ``sa0``/``sa1`` — (B, rows, cols) static stuck-at maps.
    * ``switch`` — (B, T, W, L) per-gate-evaluation switching failures over
      the written line; col-mode cycles use ``[..., :rows+1]`` of the L axis,
      row-mode cycles ``[..., :cols+1]`` (``L = max(rows, cols) + 1``).
    * ``init_flip`` — (B, T, I, rows, cols) per-cell disturb flips for each
      bulk-init rectangle entry.

    Dense over the trace: sized for conformance/debug programs. For
    Monte-Carlo scale use :class:`FaultModel` and let executors stream their
    own draws.
    """

    sa0: np.ndarray
    sa1: np.ndarray
    switch: np.ndarray
    init_flip: np.ndarray

    def __post_init__(self):
        assert self.sa0.shape == self.sa1.shape and self.sa0.ndim == 3
        assert self.switch.ndim == 4 and self.init_flip.ndim == 5
        assert not np.logical_and(self.sa0, self.sa1).any(), \
            "a cell cannot be stuck at both 0 and 1"

    @property
    def batch(self) -> int:
        return self.sa0.shape[0]

    @property
    def is_ideal(self) -> bool:
        """True when no mask is set (the realization of the ideal device)."""
        return not (self.sa0.any() or self.sa1.any() or self.switch.any()
                    or self.init_flip.any())

    def narrow(self, lo: int, hi: int) -> "FaultRealization":
        """Batch-slice view ``[lo, hi)`` — used by ``max_batch`` span
        chunking."""
        return FaultRealization(
            sa0=self.sa0[lo:hi], sa1=self.sa1[lo:hi],
            switch=self.switch[lo:hi], init_flip=self.init_flip[lo:hi])

    @classmethod
    def sample(cls, model: FaultModel, B: int, rows: int, cols: int,
               n_cycles: int, W: int, I: int, rng=None) -> "FaultRealization":
        """Draw one realization of ``model`` for a (rows, cols) trace of
        ``n_cycles`` cycles with at most ``W`` ops / ``I`` init entries per
        cycle. All mechanisms are sampled per original cycle, up front.

        >>> r = FaultRealization.sample(FaultModel(), 2, 4, 4, 3, 2, 1)
        >>> r.switch.shape, bool(r.switch.any())
        ((2, 3, 2, 5), False)
        """
        rng = as_rng(rng)
        L = max(rows, cols) + 1
        u = rng.random((B, rows, cols))
        sa0 = u < model.p_sa0
        sa1 = (u >= model.p_sa0) & (u < model.p_sa0 + model.p_sa1)
        switch = (rng.random((B, n_cycles, W, L)) < model.p_switch
                  if model.p_switch else
                  np.zeros((B, n_cycles, W, L), dtype=bool))
        init_flip = (rng.random((B, n_cycles, I, rows, cols)) < model.p_init
                     if model.p_init else
                     np.zeros((B, n_cycles, I, rows, cols), dtype=bool))
        return cls(sa0=sa0, sa1=sa1, switch=switch, init_flip=init_flip)

    # -- packed views: canonical (W, ...) uint32 words, bit b = crossbar
    # -- 32w + b, in the executors' transposed buffer layout ----------------

    def stuck_words(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sa0, sa1) packed to (W, C+1, R+1) canonical buffer layout,
        sacrificial lines fault-free."""
        B, R, C = self.sa0.shape
        W = -(-B // 32)
        sa0 = np.zeros((W, C + 1, R + 1), dtype=np.uint32)
        sa1 = np.zeros_like(sa0)
        sa0[:, :C, :R] = pack_sample_bits(self.sa0).transpose(0, 2, 1)
        sa1[:, :C, :R] = pack_sample_bits(self.sa1).transpose(0, 2, 1)
        return sa0, sa1

    def switch_words(self, t: int, slots: np.ndarray, line: int) -> np.ndarray:
        """(W, len(slots), line) fail words for original cycle ``t``'s ops at
        compile slots ``slots`` over a written line of ``line`` cells."""
        return pack_sample_bits(self.switch[:, t][:, slots, :line])

    def init_words(self, t: int, i: int) -> np.ndarray:
        """(W, C+1, R+1) disturb-flip words for init entry ``i`` of cycle
        ``t`` (sacrificial lines never flip)."""
        B, R, C = self.sa0.shape
        out = np.zeros((-(-B // 32), C + 1, R + 1), dtype=np.uint32)
        out[:, :C, :R] = pack_sample_bits(
            self.init_flip[:, t, i]).transpose(0, 2, 1)
        return out


# ---------------------------------------------------------------------------
# Fault sources: the word-mask protocol the executors consume
# ---------------------------------------------------------------------------
#
# The torch executors (per-cycle and fused) read faults through a source
# object that yields host-side packed uint32 masks per original cycle; the
# executor moves each mask to its device. Only the realization source is
# ported; the reference's model source (numpy RNG draws in cycle-then-gate
# order) arrives with FaultModel sampling.


class _RealizationSource:
    def __init__(self, real: FaultRealization, rows: int, cols: int):
        assert real.sa0.shape[1:] == (rows, cols), \
            (real.sa0.shape, rows, cols)
        self.real = real
        self.rows, self.cols = rows, cols
        # skipping all-zero masks is an identity — saves the dense packing
        # for stuck-at-only or ideal realizations
        self.has_switch = bool(real.switch.any())

    def stuck(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.real.stuck_words()

    def switch_col(self, t: int, slots, n: int) -> np.ndarray:
        return self.real.switch_words(t, slots, self.rows + 1)

    def switch_row(self, t: int, slots, n: int) -> np.ndarray:
        return self.real.switch_words(t, slots,
                                      self.cols + 1).transpose(0, 2, 1)

    def init_flip(self, t: int, i: int, c_idx, r_idx):
        full = self.real.init_words(t, i)
        return full[(slice(None),) + np.ix_(c_idx, r_idx)]


def make_fault_source(faults, rng, B: int, rows: int, cols: int):
    """``None`` | :class:`FaultRealization` → source (or ``None`` for
    fault-free execution). Every mask the source yields is in the canonical
    (W, ...) uint32 packed layout. A :class:`FaultModel` raises: sampling
    inside the executors is not ported yet."""
    if faults is None:
        return None
    if isinstance(faults, FaultRealization):
        return _RealizationSource(faults, rows, cols)
    if isinstance(faults, FaultModel):
        raise NotImplementedError(
            "FaultModel sampling (device/faults.py) is not ported to "
            "repro_torch yet; pass a FaultRealization instead")
    raise TypeError(f"unknown fault specification {type(faults).__name__}")
