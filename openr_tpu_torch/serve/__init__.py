"""Solver-as-a-service: a standalone device-owning solver process
serving many client daemons with continuous batching and SLO classes.

- ``serve.service`` — the ``SolverService`` scheduler + wave loop
  (imports torch through the tenant plane; server-side only).
- ``serve.client`` — the torch-free ``SolverClient`` daemons use.
- ``serve.slo`` — the SLO class table and wave admission ordering.

Import submodules directly (``from openr_tpu_torch.serve.client import
SolverClient``): this package ``__init__`` stays empty of imports so
client processes never pull torch in by accident.

Port note: a copy of ``openr_tpu/serve/__init__.py``.
"""
