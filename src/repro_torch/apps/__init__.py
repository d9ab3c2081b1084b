"""Application pipelines: multi-stage workloads compiled onto crossbars.

The port of ``src/repro/apps``. The op library below this package
(``repro_torch.core`` plans + tiling on a torch device, priced by
``repro_torch.device``) executes single operations; this package composes
them into whole workloads with explicit, costed inter-stage data movement:

* :mod:`.pipeline` — the composition layer (stages, reports, fault threading)
* :mod:`.bnn`      — multi-layer binarized-MLP inference, every layer
  in-crossbar, with Monte-Carlo accuracy-under-faults
* :mod:`.imaging`  — image-processing chains (blur → Sobel/Roberts edges,
  sharpen) on the full-precision and binary conv paths

See ``docs/ARCHITECTURE.md`` §Pipelines for the dataflow.

Names resolve lazily (module ``__getattr__``) so ``python -m
repro_torch.apps.bnn`` does not re-import its own module through the
package.
"""
_LAZY = {
    "BinaryConvStage": "pipeline", "BinaryMatvecStage": "pipeline",
    "ConvStage": "pipeline", "HostStage": "pipeline",
    "MatvecStage": "pipeline", "ParallelStage": "pipeline",
    "Pipeline": "pipeline", "PipelineReport": "pipeline",
    "Stage": "pipeline", "StageReport": "pipeline",
    "decode_signed": "pipeline",
    "BinaryMLP": "bnn", "fault_sweep": "bnn",
    "BINARY_KERNELS": "imaging", "KERNELS": "imaging",
    "binary_edge_pipeline": "imaging", "demo_image": "imaging",
    "edge_pipeline": "imaging", "edge_reference": "imaging",
    "ref_correlate": "imaging",
    "sharpen_pipeline": "imaging",
    "pipeline": "pipeline", "bnn": "bnn", "imaging": "imaging",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod if name == mod_name else getattr(mod, name)
