"""Device-model subsystem of the port: energy accounting, stochastic fault
injection, Monte-Carlo reliability sweeps, and in-crossbar mitigation.

The port of ``src/repro/device/``. :mod:`.energy` prices compiled traces
statically (host numpy); :mod:`.faults` holds the fault models and the
packed masks the torch executors inject (drawn on the host, replayed on the
device); :mod:`.montecarlo` turns the engine's bit-plane batching into
thousands-of-samples reliability sweeps, and :mod:`.mitigation` measures
in-crossbar TMR (the FELIX MIN3 gate voting over re-executions).

Import structure: :mod:`.energy` and :mod:`.faults` are import-light (numpy
only) so ``repro_torch.core.engine`` can depend on them without a package
cycle; :mod:`.montecarlo` and :mod:`.mitigation` import
``repro_torch.core`` and load lazily via module ``__getattr__``.
"""
from .energy import (DEFAULT_PROFILE, PROFILES, DeviceProfile, EnergyReport,
                     energy_table, format_energy_rows, get_profile,
                     io_energy_fj, trace_energy)
from .faults import IDEAL, FaultModel, FaultRealization

_LAZY = {
    "binary_matvec_sweep": "montecarlo",
    "bnn_accuracy_sweep": "montecarlo",
    "format_sweep": "montecarlo",
    "SweepPoint": "montecarlo",
    "tmr_binary_matvec": "mitigation",
    "TMRReport": "mitigation",
    "montecarlo": "montecarlo",
    "mitigation": "mitigation",
}

__all__ = [
    "DEFAULT_PROFILE", "DeviceProfile", "EnergyReport", "FaultModel",
    "FaultRealization",
    "IDEAL", "PROFILES", "SweepPoint", "TMRReport", "binary_matvec_sweep",
    "bnn_accuracy_sweep", "energy_table", "format_energy_rows", "format_sweep",
    "get_profile", "io_energy_fj", "tmr_binary_matvec", "trace_energy",
]


def __getattr__(name):
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod if name == mod_name else getattr(mod, name)
