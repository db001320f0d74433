"""Command-line entry points of the port and what they report:

  * :mod:`repro_torch.launch.solve_feti` — the FETI solve launcher
    (``--trace OUT.json`` and ``--report`` export its telemetry;
    ``--devices N`` splits the subdomains over N ranks)
  * :mod:`repro_torch.launch.mesh` — the ranks of distributed FETI
    (:class:`~repro_torch.launch.mesh.FetiMesh`, ``spawn_ranks``)
  * :mod:`repro_torch.launch.analytic` — the analytic FLOP / byte counts of
    the FETI solve phase (:func:`feti_solve_iter_counts`,
    :data:`FETI_SOLVE_N_RHS`)
  * :mod:`repro_torch.launch.roofline` — the device models that price the
    autotuner's candidates
"""
from repro_torch.launch.analytic import FETI_SOLVE_N_RHS, feti_solve_iter_counts

__all__ = ["FETI_SOLVE_N_RHS", "feti_solve_iter_counts"]
