"""Render the dry-run's reports and the roofline-fraction summary
(counterpart of ``repro.launch.finalize``).

    PYTHONPATH=src python -m repro_torch.launch.finalize BASELINE.jsonl \\
        OPTIMIZED.jsonl [--out-dir DIR]

Roofline fraction per cell = unavoidable_time / dominant_term, where
unavoidable_time = max(model-flops time, mandatory-stream time):
  * model-flops time  = MODEL_FLOPS / (chips × peak)  (compute floor)
  * mandatory stream  = weight+cache bytes that must move once per step
    (memory floor; relevant for decode)
both at the H100's data-sheet rates (``roofline.HW``). A row measured on
the card (``measured_s``, ``dryrun --devices 1 --run``) also gets
floor / measured_s: the share of the floor the card reached.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
from typing import Optional

from repro_torch.launch.report import dryrun_table, load, roofline_table
from repro_torch.launch.roofline import HW

__all__ = ["floor_s", "fraction", "measured_fraction", "main"]


def floor_s(rec) -> float:
    """The cell's unavoidable time a step, in seconds."""
    ro = rec["roofline"]
    model_t = ro["model_flops"] / (rec["chips"] * HW["peak_flops"])
    an = rec.get("analytic", {})
    stream = an.get("weight_stream_dev", 0.0) + an.get("cache_stream_dev", 0.0)
    return max(model_t, stream / HW["hbm_bw"])


def fraction(rec) -> float:
    ro = rec["roofline"]
    dom = max(ro["compute_s"], ro["memory_s"], ro["collective_s"])
    return min(floor_s(rec) / max(dom, 1e-30), 1.0)


def measured_fraction(rec) -> Optional[float]:
    """floor / measured_s of a row run on the card, else None."""
    t = rec.get("measured_s")
    return None if t is None else floor_s(rec) / t


def _report(name: str, recs, path: str) -> None:
    with open(path, "w") as f:
        n_ok = sum(r["status"] == "ok" for r in recs)
        n_skip = sum(r["status"] == "skipped" for r in recs)
        f.write(f"# Dry-run report ({name}): {n_ok} counted cells, "
                f"{n_skip} skips\n\n")
        f.write(dryrun_table(recs) + "\n")
        for mesh in sorted({r.get("mesh") for r in recs
                            if r["status"] == "ok"}):
            f.write(f"\n## Roofline ({mesh})\n\n")
            f.write(roofline_table(recs, mesh) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("baseline", help="dry-run JSONL without --opt")
    p.add_argument("optimized", help="dry-run JSONL with --opt")
    p.add_argument("--out-dir", default=None,
                   help="write report_baseline.md and report_optimized.md "
                        "here")
    args = p.parse_args(argv)
    base, opt = load(args.baseline), load(args.optimized)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for name, recs in (("baseline", base), ("optimized", opt)):
            _report(name, recs, os.path.join(args.out_dir,
                                             f"report_{name}.md"))

    def ok(recs):
        return {(r["arch"], r["shape"], r.get("mesh")): r for r in recs
                if r["status"] == "ok"}

    bmap, omap = ok(base), ok(opt)
    print("| cell | mesh | baseline dominant | baseline fraction "
          "| optimized dominant | optimized fraction | gain on dominant "
          "| floor / measured |")
    print("|---|---|---|---|---|---|---|---|")
    gains = []
    for key in sorted(omap):
        if key not in bmap:
            continue
        b, o = bmap[key], omap[key]
        bd = max(b["roofline"]["compute_s"], b["roofline"]["memory_s"],
                 b["roofline"]["collective_s"])
        od = max(o["roofline"]["compute_s"], o["roofline"]["memory_s"],
                 o["roofline"]["collective_s"])
        gains.append(bd / max(od, 1e-30))
        meas = [measured_fraction(r) for r in (b, o)]
        meas_s = " / ".join("—" if m is None else f"{m:.4f}" for m in meas)
        print(f"| {key[0]} × {key[1]} | {key[2]} "
              f"| {b['roofline']['dominant']} {bd * 1e3:.2f}ms "
              f"| {fraction(b):.3f} "
              f"| {o['roofline']['dominant']} {od * 1e3:.2f}ms "
              f"| {fraction(o):.3f} | {gains[-1]:.2f}x | {meas_s} |")
    if gains:
        print(f"\nmedian dominant-term gain across the grid: "
              f"{statistics.median(gains):.2f}x; max: {max(gains):.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
