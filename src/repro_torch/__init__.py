"""PyTorch/CUDA port of the MatPIM reproduction (``repro`` is the reference).

The port runs the simulator — plans, compiled traces, torch executors,
tiling, multi-device tile dispatch (``distributed/``), the serving layer,
device models and apps — and the model stack (``models/``), its serving
path (``serve/engine.py``, ``launch/serve.py``) and its training half
(``optim/``, ``train/``, ``data/``, ``checkpoint/``,
``distributed/fault_tolerance.py``, ``launch/train.py``) on a torch
device, with the TPU's Pallas
kernels rewritten by hand in CUDA for Hopper (``kernels/``, ``csrc/``). Host-side program generation and compilation stay
numpy, byte-identical to the reference's. Module paths mirror ``repro``'s;
the one exception is ``core/kernel_exec.py``, the counterpart of
``repro/core/pallas_exec.py``. The package imports ``torch`` and ``numpy``,
never ``jax`` and never ``repro``.
"""
