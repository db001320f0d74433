"""Golden analytic counts of the reference's full-size FETI dry-run cells,
for the port's dry-run to meet on the card, where there is no JAX.

    PYTHONPATH=src python tests/torch_dryrun_golden.py   # rewrites the file

For every FETI arch of :data:`ARCHS`, shape of :data:`SHAPES` and mesh of
:data:`MESHES`, ``tests/data/torch_dryrun_golden.json`` keeps, under
``<arch>/<shape>/<mesh>``, the reference's
``repro.launch.dryrun.feti_cell_counts(get_config(arch), shape,
chips).as_dict()`` at the full-size config. ``tests/test_torch_launch.py``
recomputes it with the reference and holds the port's rows to it;
``chip_smoke.py``'s dryrun phase holds the card's rows to it.

:func:`reference_counts` imports the reference; :func:`load` and
:func:`mismatches` do not.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_dryrun_golden.json"
ARCHS = ("feti-heat-2d", "feti-heat-3d", "feti-elasticity-2d",
         "feti-elasticity-3d")
SHAPES = ("assembly", "solve_iter", "solve_iter_multi", "dirichlet")
MESHES = {"16x16": 256, "2x16x16": 512}


def _plain(x):
    """numpy scalars as Python numbers, for JSON."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "item"):
        return x.item()
    return x


def import_reference_dryrun():
    """``repro.launch.dryrun`` without its process-wide side effect: the
    module asks XLA for 512 host devices through ``XLA_FLAGS`` when it is
    imported, which must not reach a process whose JAX backend is not up
    yet, nor the processes it starts. The backend is brought up first and
    the variable put back after the import."""
    import jax

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


def reference_counts(archs=ARCHS, smoke: bool = False) -> dict:
    """``{"<arch>/<shape>/<mesh>": CellCounts.as_dict()}`` of the
    reference (its smoke configs with ``smoke``)."""
    from repro.configs import get_config, get_smoke_config

    ref = import_reference_dryrun()
    out = {}
    for arch in archs:
        fc = (get_smoke_config if smoke else get_config)(arch)
        for shape in SHAPES:
            for mesh, chips in MESHES.items():
                out[f"{arch}/{shape}/{mesh}"] = _plain(
                    ref.feti_cell_counts(fc, shape, chips).as_dict())
    return out


def load(path=GOLDEN) -> dict:
    with open(path) as f:
        return json.load(f)


def mismatches(rec: dict, want: dict) -> list:
    """Where a port dry-run row (as written to its JSONL) differs from a
    golden entry: its per-device flops and bytes, residency, model flops
    and every note, each compared exactly."""
    ro = rec["roofline"]
    got = {"flops_per_dev": ro["flops_per_dev"],
           "hbm_bytes_per_dev": ro["bytes_per_dev"],
           "hbm_resident_per_dev": rec["analytic_resident_bytes_per_dev"],
           "model_flops": ro["model_flops"],
           "notes": rec["analytic"]}
    exp = {"flops_per_dev": want["flops_per_dev"],
           "hbm_bytes_per_dev": want["hbm_bytes_per_dev"],
           "hbm_resident_per_dev": int(want["hbm_resident_per_dev"]),
           "model_flops": want["model_flops"],
           "notes": want["notes"]}
    return [k for k in got if got[k] != exp[k]]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    counts = reference_counts()
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(counts, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(counts)} cells to {GOLDEN}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
