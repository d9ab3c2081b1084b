"""PyTorch/CUDA port of the MatPIM reproduction (``repro`` is the reference).

The port runs the binary matrix-vector main path — plan, compiled trace,
torch executors, tiling and the serving layer — on a torch device, with the
TPU's Pallas ``binary_matmul`` rewritten by hand in CUDA for Hopper
(``kernels/``, ``csrc/``). Host-side program generation and compilation stay
numpy, byte-identical to the reference's. Module paths mirror ``repro``'s;
the one exception is ``core/kernel_exec.py``, the counterpart of
``repro/core/pallas_exec.py``. The package imports ``torch`` and ``numpy``,
never ``jax`` and never ``repro``.
"""
