"""Schema validation for the port's observability artifacts (a copy of the
framework-free ``repro.obs.validate``).

Two artifact families, both carrying an explicit ``schema_version``:

  * Chrome-trace JSON (``*.json``, :meth:`Tracer.to_chrome_trace`): a
    top-level object with ``schema_version``, a non-empty ``traceEvents``
    list of complete events (``ph == "X"`` with ``name``/``ts``/``dur``/
    ``pid``/``tid``), and an embedded ``metrics`` dict.
  * JSONL records (``*.jsonl``: the span export, :meth:`Tracer.to_jsonl`):
    one JSON object per line, every object carrying an integer
    ``schema_version``.

``python -m repro_torch.obs.validate <files...>`` checks the trace that
``python -m repro_torch.launch.solve_feti --trace OUT.json`` writes (and
``chip_smoke.py`` runs it on the card's trace), so schema drift fails
instead of shipping an unreadable artifact.
"""
from __future__ import annotations

import json
import sys

__all__ = ["validate_chrome_trace", "validate_jsonl", "main"]

_EVENT_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def validate_chrome_trace(path: str) -> list:
    """Return a list of error strings (empty = valid)."""
    errors = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable JSON: {e}"]
    if not isinstance(doc, dict):
        return [f"{path}: top level must be an object"]
    if not isinstance(doc.get("schema_version"), int):
        errors.append(f"{path}: missing integer schema_version")
    if not isinstance(doc.get("metrics"), dict):
        errors.append(f"{path}: missing metrics dict")
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        errors.append(f"{path}: traceEvents must be a non-empty list")
        return errors
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"{path}: traceEvents[{i}] is not an object")
            continue
        missing = [k for k in _EVENT_KEYS if k not in ev]
        if missing:
            errors.append(f"{path}: traceEvents[{i}] missing {missing}")
            continue
        if ev["ph"] != "X":
            errors.append(f"{path}: traceEvents[{i}] ph={ev['ph']!r}, "
                          f"expected complete event 'X'")
        if not isinstance(ev["name"], str):
            errors.append(f"{path}: traceEvents[{i}] name is not a string")
        for k in ("ts", "dur"):
            if not isinstance(ev[k], (int, float)) or ev[k] < 0:
                errors.append(
                    f"{path}: traceEvents[{i}] {k}={ev[k]!r} is not a "
                    f"non-negative number")
    return errors


def validate_jsonl(path: str) -> list:
    """Every line a JSON object with an integer ``schema_version``."""
    errors = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [f"{path}: unreadable: {e}"]
    if not any(ln.strip() for ln in lines):
        return [f"{path}: empty"]
    for i, ln in enumerate(lines, start=1):
        if not ln.strip():
            continue
        try:
            rec = json.loads(ln)
        except ValueError as e:
            errors.append(f"{path}:{i}: invalid JSON: {e}")
            continue
        if not isinstance(rec, dict):
            errors.append(f"{path}:{i}: record is not an object")
        elif not isinstance(rec.get("schema_version"), int):
            errors.append(f"{path}:{i}: missing integer schema_version")
    return errors


def validate(path: str) -> list:
    """Dispatch on extension: ``.jsonl`` records, anything else a trace."""
    if path.endswith(".jsonl"):
        return validate_jsonl(path)
    return validate_chrome_trace(path)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate <file.json|file.jsonl>...",
              file=sys.stderr)
        return 2
    n_err = 0
    for path in argv:
        errors = validate(path)
        if errors:
            n_err += len(errors)
            for e in errors[:20]:
                print(f"[obs.validate] FAIL {e}", file=sys.stderr)
        else:
            print(f"[obs.validate] OK   {path}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
