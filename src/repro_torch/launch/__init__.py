"""Launchers: device meshes, the serving and training CLIs and the
analytic roofline (the port of ``src/repro/launch``; the dry-run and the
HLO analysis are not ported), and ``precision``, the port's own
float32-drift report."""
