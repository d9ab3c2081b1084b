"""End-to-end binarized-MLP inference on the crossbar substrate.

The port of ``src/repro/apps/bnn.py``; every layer's tiles run on a torch
``device`` (on ``backend="kernels"``, one ``binary_matmul`` launch per
64-tile batch). The paper's §II-B binary matvec is one layer; this module
composes it into a whole network (the ``matpim-bnn`` entry of
``repro_torch.configs``): every layer
runs in-crossbar as a tiled XNOR-popcount matvec whose native majority output
IS the sign activation, so the host's only jobs between layers are the tile
tree-reduction and moving the ±1 activation vector to the next layer's
arrays — both visible and priced in the :class:`~repro_torch.apps.pipeline.
PipelineReport`.

Weights are ±1 and array-resident (weight-stationary); activations are ±1
vectors. The final layer keeps its raw popcounts so classification is argmax
of the dot products ``2·pop − K`` rather than a single sign bit.

Monte-Carlo accuracy-under-faults rides the engine's bit-plane batching via
:meth:`~repro_torch.core.tiling.TiledBinaryMatvec.popcounts_many`: all
samples of a layer execute as engine batches, each sample under an
independent device-fault realization threaded through **every layer**
(faults compound across depth — the single-layer sweeps in
:mod:`repro_torch.device.montecarlo` are the depth-1 special case). Fault
runs replay on ``torch`` and draw their masks on the host, as the
reference's numpy path does, so the same seed gives the same points.

The weights are the reference's as given: ``BinaryMLP(model.weights)``
takes a reference model's ±1 arrays unchanged.

Run the demo (kernels and fused replay on the card, bit-identical check,
fault point):

    PYTHONPATH=src python -m repro_torch.apps.bnn
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..configs import get_config
from ..core.tiling import majority_sign
from ..device.faults import FaultModel
from ..device.montecarlo import SweepPoint, format_sweep
from .pipeline import BinaryMatvecStage, Pipeline, PipelineReport

# small-array geometry: the reduced nets here never exceed one tile per
# layer, and a 256x512 array simulates ~8x faster than the full 1024x1024
# (parts=16 keeps 32 columns per partition — enough offset budget for the
# popcount adder tree)
DEFAULT_PLAN_KW = dict(rows=256, cols=512, parts=16)


class BinaryMLP:
    """±1-weight MLP whose every layer executes as a compiled crossbar
    program (tree-popcount matvec + native sign activation)."""

    def __init__(self, weights: Sequence[np.ndarray], name: str = "bnn",
                 plan_kw: Optional[dict] = None):
        self.weights = [np.asarray(W, dtype=np.int64) for W in weights]
        assert self.weights, "need at least one layer"
        for i, W in enumerate(self.weights):
            assert set(np.unique(W)) <= {-1, 1}, f"layer {i} weights not ±1"
            if i:
                assert W.shape[1] == self.weights[i - 1].shape[0], \
                    f"layer {i} input dim mismatch"
        self.plan_kw = dict(DEFAULT_PLAN_KW, **(plan_kw or {}))
        last = len(self.weights) - 1
        self.stages: List[BinaryMatvecStage] = [
            BinaryMatvecStage(W, name=f"layer{i}_{W.shape[0]}x{W.shape[1]}",
                              keep_popcounts=(i == last), **self.plan_kw)
            for i, W in enumerate(self.weights)
        ]
        self.pipeline = Pipeline(self.stages, name=name)

    @classmethod
    def random(cls, dims: Sequence[int], seed: int = 0, **kw) -> "BinaryMLP":
        """Random ±1 net with layer sizes ``dims[0] -> ... -> dims[-1]``."""
        rng = np.random.default_rng(seed)
        ws = [rng.choice([-1, 1], size=(dims[i + 1], dims[i]))
              for i in range(len(dims) - 1)]
        return cls(ws, **kw)

    @classmethod
    def from_config(cls, name: str = "matpim-bnn", classes: int = 32,
                    n_layers: Optional[int] = None, seed: int = 0,
                    **kw) -> "BinaryMLP":
        """Net shaped by a ``repro_torch.configs`` entry (reduced to smoke
        size): d_model inputs, (n_layers − 1) hidden layers of d_ff,
        ``classes`` outputs."""
        cfg = get_config(name).reduced()
        n = n_layers if n_layers is not None else cfg.n_layers
        dims = [cfg.d_model] + [cfg.d_ff] * (n - 1) + [classes]
        return cls.random(dims, seed=seed, name=cfg.name, **kw)

    @property
    def dims(self) -> List[int]:
        return [self.weights[0].shape[1]] + [W.shape[0] for W in self.weights]

    # -- single-input forward (the Pipeline path) ----------------------------

    def forward(self, x: np.ndarray, backend: str = "torch", faults=None,
                rng=None, profile=None, device="cuda"
                ) -> Tuple[np.ndarray, PipelineReport]:
        """One input vector through all layers in-crossbar. Returns the final
        ±1 sign vector and the staged cost report; ``self.scores`` holds the
        last layer's dot products for argmax classification."""
        y, rep = self.pipeline.run(np.asarray(x), backend=backend,
                                   faults=faults, rng=rng, profile=profile,
                                   device=device)
        pop = self.stages[-1].last_popcounts
        self.scores = 2 * pop - self.weights[-1].shape[1]
        return y, rep

    def reference(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pure-numpy forward (sign ties → +1, like the plans). Returns
        (final sign vector, final-layer dot products)."""
        a = np.asarray(x)
        for W in self.weights[:-1]:
            a = np.where(W @ a >= 0, 1, -1)
        dots = self.weights[-1] @ a
        return np.where(dots >= 0, 1, -1), dots

    # -- batched forward (the Monte-Carlo path) ------------------------------

    def forward_batch(self, X: np.ndarray, backend: str = "torch",
                      faults=None, rng=None, device="cuda"
                      ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """All rows of ``X`` through the net as engine batches. Returns the
        final-layer dot products (J, classes) and the ±1 activations after
        each hidden layer. With ``faults``, every (sample, tile) pair draws
        an independent realization from one shared stream."""
        if faults is not None:
            rng = np.random.default_rng(rng)
        acts: List[np.ndarray] = []
        A = np.asarray(X)
        for i, (st, W) in enumerate(zip(self.stages, self.weights)):
            pops = st.tiled.popcounts_many(W, A, backend=backend,
                                           faults=faults, rng=rng,
                                           device=device)
            dots = 2 * pops - W.shape[1]
            if i < len(self.weights) - 1:
                A = np.where(dots >= 0, 1, -1)
                acts.append(A)
        return dots, acts

    def predict(self, X: np.ndarray, **kw) -> np.ndarray:
        dots, _ = self.forward_batch(X, **kw)
        return np.argmax(dots, axis=1)


def fault_sweep(model: BinaryMLP, rates: Sequence[float], samples: int = 256,
                backend: str = "torch", seed: int = 0,
                device="cuda") -> List[SweepPoint]:
    """Classification accuracy of the whole net vs uniform device-fault rate.

    Accuracy is scored against the fault-free net's own predictions (rate 0
    is exactly 1.0); ``bit_error_rate`` reports the flip rate of hidden-layer
    sign activations — the observable faults compound through.
    """
    rng = np.random.default_rng(seed)
    X = rng.choice([-1, 1], size=(samples, model.dims[0]))
    dots0, acts0 = model.forward_batch(X, backend=backend, device=device)
    labels = np.argmax(dots0, axis=1)

    points = []
    for rate in rates:
        dots, acts = model.forward_batch(
            X, backend=backend, faults=FaultModel.uniform(rate),
            rng=np.random.default_rng(seed + 1), device=device)
        preds = np.argmax(dots, axis=1)
        acc = float((preds == labels).mean())
        flips = [float((a != a0).mean()) for a, a0 in zip(acts, acts0)]
        ber = float(np.mean(flips)) if flips else 0.0
        points.append(SweepPoint(rate=float(rate), samples=samples,
                                 bit_error_rate=ber,
                                 sign_error_rate=1.0 - acc, accuracy=acc))
    return points


def main() -> None:
    model = BinaryMLP.from_config(n_layers=3)
    print(f"BNN {model.pipeline.name}: dims {model.dims} "
          f"({len(model.weights)} in-crossbar layers)")
    rng = np.random.default_rng(7)
    x = rng.choice([-1, 1], size=model.dims[0])

    y_k, rep = model.forward(x, backend="kernels")
    scores_k = model.scores
    ref_y, ref_dots = model.reference(x)
    assert np.array_equal(y_k, ref_y), "crossbar forward != numpy reference"
    assert np.array_equal(scores_k, ref_dots)
    print(rep)
    print(f"argmax class: {int(np.argmax(scores_k))}  "
          f"(reference {int(np.argmax(ref_dots))})")

    y_t, _ = model.forward(x, backend="torch")
    same = np.array_equal(y_k, y_t) and np.array_equal(scores_k,
                                                       model.scores)
    print(f"fused replay bit-identical to the kernels: {same}")
    assert same

    pts = fault_sweep(model, [1e-4, 1e-3], samples=128)
    print(format_sweep(pts, "accuracy under faults (128 samples/rate)"))


if __name__ == "__main__":
    main()
