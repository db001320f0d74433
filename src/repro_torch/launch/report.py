"""Render the dry-run's rows (:mod:`repro_torch.launch.dryrun`) as tables
(counterpart of ``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report dryrun.jsonl

The collective columns of a production-mesh row are the port's own
schedule (``analytic.lm_collectives`` / ``feti_collectives``); a
``--devices 1`` row sends nothing and prints "—". The ``run s`` column
(``measured_s`` of a ``--devices 1 --run`` row) takes the place of the
reference's ``compile s``.
"""
from __future__ import annotations

import json
import sys

__all__ = ["load", "fmt_bytes", "fmt_s", "dryrun_table", "roofline_table",
           "pick_hillclimb", "main"]

DASH = "—"


def load(path: str) -> list[dict]:
    """The rows of a JSONL file, the last one kept for each (arch, shape,
    mesh)."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    seen = {}
    for r in recs:
        seen[(r["arch"], r["shape"], r.get("mesh", "-"))] = r
    return list(seen.values())


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}µs"


def _coll(r) -> tuple:
    """(collective GiB a device, collective count) cells of a row."""
    if r.get("collectives") is None:
        return DASH, DASH
    return (fmt_bytes(r["roofline"]["coll_bytes_per_dev"]),
            str(sum(r["collectives"]["count"].values())))


def dryrun_table(recs) -> str:
    rows = ["| arch | shape | mesh | status | res GiB/dev | FLOPs/dev "
            "| coll GiB/dev | #coll | run s |",
            "|---|---|---|---|---|---|---|---|---|"]
    key = lambda x: (x["arch"], x["shape"], x.get("mesh", ""))  # noqa: E731
    for r in sorted(recs, key=key):
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | - "
                        f"| SKIP: {r['reason']} | | | | | |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                        f"| error: {r.get('error', '')} | | | | | |")
            continue
        ro = r["roofline"]
        coll_b, coll_n = _coll(r)
        run = r.get("measured_s")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
            f"| {fmt_bytes(r['analytic_resident_bytes_per_dev'])} "
            f"| {ro['flops_per_dev']:.2e} | {coll_b} | {coll_n} "
            f"| {DASH if run is None else f'{run:.4f}'} |"
        )
    return "\n".join(rows)


def roofline_table(recs, mesh="16x16") -> str:
    rows = ["| arch | shape | compute s | memory s | collective s "
            "| dominant | MODEL_FLOPS | useful ratio | bottleneck note |",
            "|---|---|---|---|---|---|---|---|---|"]
    notes = {
        "compute": "more tensor-core-efficient schedule / fewer executed "
                   "flops",
        "memory": "raise arithmetic intensity (cache dtype, fusion, batch)",
        "collective": "shard to cut payloads / overlap with compute",
    }
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r["status"] != "ok" or r.get("mesh") != mesh:
            continue
        ro = r["roofline"]
        coll = (DASH if r.get("collectives") is None
                else fmt_s(ro["collective_s"]))
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_s(ro['compute_s'])} | {fmt_s(ro['memory_s'])} "
            f"| {coll} | **{ro['dominant']}** "
            f"| {ro['model_flops']:.2e} "
            f"| {ro['useful_ratio']:.3f} "
            f"| {notes[ro['dominant']]} |"
        )
    return "\n".join(rows)


def pick_hillclimb(recs) -> dict:
    """worst useful ratio / most collective-bound / paper-representative."""
    ok = [r for r in recs if r["status"] == "ok" and r.get("mesh") == "16x16"
          and not r["arch"].startswith("feti")]
    worst = min(ok, key=lambda r: r["roofline"]["useful_ratio"])
    coll = max(ok, key=lambda r: (r["roofline"]["collective_s"]
                                  / max(max(r["roofline"]["compute_s"],
                                            r["roofline"]["memory_s"]), 1e-30)))
    return {
        "worst_useful": (worst["arch"], worst["shape"]),
        "most_collective": (coll["arch"], coll["shape"]),
        "paper_representative": ("feti-heat-3d", "assembly"),
    }


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m repro_torch.launch.report DRYRUN.jsonl",
              file=sys.stderr)
        return 2
    recs = load(args[0])
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    print(f"## Dry-run census: {n_ok} counted cells, {n_skip} documented "
          "skips\n")
    print(dryrun_table(recs))
    for mesh in sorted({r.get("mesh") for r in recs if r["status"] == "ok"}):
        print(f"\n## Roofline ({mesh})\n")
        print(roofline_table(recs, mesh))
    meshes = {r.get("mesh") for r in recs}
    if "16x16" in meshes:
        print("\n## Hillclimb picks\n")
        print(json.dumps(pick_hillclimb(recs), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
