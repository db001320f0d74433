"""Command-line entry points of the port and what they report:

  * :mod:`repro_torch.launch.solve_feti` — the FETI solve launcher
    (``--trace OUT.json`` and ``--report`` export its telemetry;
    ``--devices N`` splits the subdomains over N ranks)
  * :mod:`repro_torch.launch.serve`, :mod:`repro_torch.launch.train` —
    the LM serving and training launchers
  * :mod:`repro_torch.launch.mesh` — the ranks of distributed FETI
    (:class:`~repro_torch.launch.mesh.FetiMesh`, ``spawn_ranks``) and the
    LM meshes (``make_production_mesh``, ``make_local_mesh``)
  * :mod:`repro_torch.launch.shapes` — the LM cells' input-shape grid
  * :mod:`repro_torch.launch.analytic` — the analytic FLOP / byte counts of
    the LM cells (:func:`lm_cell_counts`) and of the FETI solve phase
    (:func:`feti_solve_iter_counts`, :data:`FETI_SOLVE_N_RHS`)
  * :mod:`repro_torch.launch.roofline` — the card's figures and the cells'
    roofline terms, and the device models that price the autotuner's
    candidates
  * :mod:`repro_torch.launch.dryrun` — every (arch × shape × mesh) cell:
    its counts, whether it fits, and with ``--devices 1 --run`` a run on
    the card; :mod:`repro_torch.launch.report` and
    :mod:`repro_torch.launch.finalize` render its rows
"""
from repro_torch.launch.analytic import FETI_SOLVE_N_RHS, feti_solve_iter_counts

__all__ = ["FETI_SOLVE_N_RHS", "feti_solve_iter_counts"]
