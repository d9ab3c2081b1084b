"""Launchers: device meshes and the serving CLI (the port of
``src/repro/launch``; training, the dry-run and the analytic roofline are
not ported yet), and ``precision``, the port's own float32-drift report."""
