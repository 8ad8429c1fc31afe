"""The port's cost gate over its kernel ledger.

The JAX package gates the XLA cost model of each program
(``ci/perf_gate.py`` over ``perf_budgets.json``).  Eager torch has no
cost model; what it can count deterministically on the CPU is what the
port's ledger records (``opendht_tpu_torch/profiling.py``): per
canonical call, the ops it dispatches (``launches``, with the split by
op), the bytes of its arguments and outputs, and the analytic byte and
operation counts.  This gate diffs a live ledger against the port's own
budgets, ``opendht_tpu_torch/perf_budgets.json``:

- **Hard failures** (exit 1): a canonical SHAPE drift (a silently moved
  shape would re-base the budget without review), a ``launches``,
  ``argument_bytes`` or ``output_bytes`` change beyond its tolerance, a
  changed ``bytes_bound`` / ``flops_model``, a budgeted spec missing
  from the ledger or a spec without a budget.  ``launches`` is gated
  against a ledger of the budgets' platform (the CPU); a card's
  dispatch count differs where a hand kernel replaces the plain ops, so
  it is printed beside the budget, not gated.
- **Soft warnings** (never fail): a card ledger's ``peak_temp_bytes``
  against the budget taken from a card run's ledger record, and the
  wall-clock ``timing_soft`` ceilings against the smoke records in
  ``--records`` / ``$OPENDHT_TPU_SMOKE_RECORD_DIR`` (``chip_smoke.py``
  writes ``ledger.json``, ``swarm_storm.json`` and, through the bench
  twin, ``bench.json`` there).
- **Open bounds**: the JAX package's ``open: true`` accelerator bounds,
  with their metrics and settling commands pointed at the port; every
  time or rate target is null until a run on the card settles it.

Usage::

    python -m opendht_tpu_torch.perf_gate              # gate (CPU ledger)
    python -m opendht_tpu_torch.perf_gate --update     # re-base budgets
    python -m opendht_tpu_torch.perf_gate --records DIR  # + timing warns

The budgets' ``launches`` are ops dispatched on the CPU, so the command
gates a CPU ledger: its pass is not a card check.  ``chip_smoke.py``'s
ledger phase gates the card's ledger (every field but ``launches``, and
its peak temporaries).  Re-base
(``--update``, then review and commit the diff) only when a change to a
program's launches or bytes is intended; with ``--records DIR`` holding
a card run's ``ledger.json``, the re-base also takes that run's
``peak_temp_bytes``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

BUDGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "perf_budgets.json")

#: relative tolerance per hard-gated field.  All of them are counts of
#: one torch version's dispatch or pure shape math; a refactor of
#: interest (2x-class) clears every band, and a torch upgrade that moves
#: a decomposition by a few ops does not.
DEFAULT_TOL = {
    "launches": 0.10,
    "argument_bytes": 0.0,
    "output_bytes": 0.0,
    "bytes_bound": 0.0,
    "flops_model": 0.0,
}
SOFT_TOL = {"peak_temp_bytes": 0.60}


def _load_budgets(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _check_field(failures, warnings, name, field, budget, observed, tol,
                 soft=False):
    if budget == 0 and observed == 0:
        return
    lo, hi = budget * (1 - tol), budget * (1 + tol)
    if lo <= observed <= hi:
        return
    ratio = observed / budget if budget else float("inf")
    msg = (f"{name}.{field}: observed {observed:.6g} vs budget "
           f"{budget:.6g} ({ratio:.2f}x, tolerance ±{tol:.0%})")
    (warnings if soft else failures).append(msg)


def check_costs(budgets: dict, ledger: dict, failures: list,
                warnings: list) -> None:
    tol = dict(DEFAULT_TOL, **budgets.get("tolerance", {}))
    stol = dict(SOFT_TOL, **budgets.get("soft_tolerance", {}))
    plat = budgets.get("platform", "cpu")
    for name, b in sorted(budgets.get("kernels", {}).items()):
        e = ledger.get(name)
        if e is None:
            failures.append(f"{name}: budgeted spec missing from the "
                            f"ledger (KERNEL_SPECS) — removing one needs a "
                            f"deliberate --update")
            continue
        if "error" in e:
            failures.append(f"{name}: ledger failed to run: {e['error']}")
            continue
        if e.get("shape") != b.get("shape"):
            failures.append(
                f"{name}: canonical shape drifted — budget {b.get('shape')}"
                f" vs ledger {e.get('shape')}; re-base with --update if "
                f"intentional")
            continue
        for field, t in tol.items():
            if field == "launches" and e.get("platform") != plat:
                warnings.append(
                    f"{name}.launches: {e.get('platform')} dispatched "
                    f"{e.get('launches')} ops ({e.get('device_kernels', '?')}"
                    f" device kernels) vs the {plat} budget "
                    f"{b.get('launches')} — not gated across platforms")
                continue
            _check_field(failures, warnings, name, field,
                         float(b.get(field, 0.0)), float(e.get(field, 0.0)),
                         t)
        for field, t in stol.items():
            # card-measured fields, budgeted once a card run committed them
            if b.get(field) is not None and field in e:
                _check_field(failures, warnings, name, field,
                             float(b[field]), float(e[field]), t, soft=True)
    for name in sorted(ledger):
        if name not in budgets.get("kernels", {}) \
                and "error" not in ledger[name]:
            failures.append(f"{name}: spec has no budget entry — run "
                            f"python -m opendht_tpu_torch.perf_gate "
                            f"--update and commit perf_budgets.json")


def check_timing(budgets: dict, records_dir: str, warnings: list) -> None:
    """Wall-clock ceilings from the smoke records — soft by design: a
    breach WARNS with the number while the counted gate decides."""
    if not records_dir or not os.path.isdir(records_dir):
        return
    recs = {}
    for p in glob.glob(os.path.join(records_dir, "*.json")):
        try:
            with open(p) as f:
                recs[os.path.splitext(os.path.basename(p))[0]] = json.load(f)
        except (OSError, ValueError):
            continue
    for key, spec in sorted(budgets.get("timing_soft", {}).items()):
        rec = recs.get(spec["record"])
        if rec is None:
            warnings.append(
                f"timing[{key}]: no {spec['record']}.json in "
                f"{records_dir} — the ceiling was not checked")
            continue
        val = rec.get(spec["field"])
        if val is None:
            for srec in rec.get("stages", {}).values():
                val = srec.get(spec["field"])
                if val is not None:
                    break
        if val is None:
            warnings.append(
                f"timing[{key}]: {spec['record']}.json carries no "
                f"{spec['field']!r} field — the ceiling was not checked")
            continue
        if spec.get("max") is None:
            warnings.append(
                f"timing[{key}]: {spec['record']}.{spec['field']} = {val} "
                f"{spec.get('unit', '')}; no ceiling set until a card run "
                f"settles one")
            continue
        if float(val) > float(spec["max"]):
            warnings.append(
                f"timing[{key}]: {spec['record']}.{spec['field']} = "
                f"{val} exceeds the soft ceiling {spec['max']} "
                f"{spec.get('unit', '')} — wall-clock only, not failing "
                f"({spec.get('note', '')})".rstrip())


def print_open_bounds(budgets: dict) -> None:
    ob = budgets.get("open_bounds", {})
    if not ob:
        return
    print("perf_gate: %d OPEN bound(s) awaiting settlement on the card "
          "(not gated):" % len(ob))
    for key, b in sorted(ob.items()):
        print(f"  - {key}: target {b['target']} on {b['metric']}\n"
              f"    settle: {b['settle']}")


def gate(budgets: dict, ledger: dict, records: str = "") -> tuple:
    """(failures, warnings) of ``ledger`` ({name: entry}, a CPU or card
    ledger) against ``budgets``."""
    failures: list = []
    warnings: list = []
    check_costs(budgets, ledger, failures, warnings)
    check_timing(budgets, records, warnings)
    return failures, warnings


def compute_ledger() -> dict:
    """The CPU ledger the budgets are kept against."""
    from . import profiling
    return profiling.get_ledger().compute(device="cpu")


def card_record(records_dir: str) -> dict:
    """The card ledger a ``chip_smoke.py`` run wrote as ``ledger.json``
    into ``records_dir`` ({} when there is none)."""
    p = os.path.join(records_dir or "", "ledger.json")
    if not records_dir or not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def update_budgets(path: str, ledger: dict, card: dict = None) -> None:
    """Re-base the budget file from a CPU ledger, keeping the curated
    sections (tolerances, open bounds, timing ceilings).  The
    card-measured soft fields come from ``card`` (a card ledger) where
    it has them, else they are kept as they were."""
    old = _load_budgets(path) if os.path.exists(path) else {}
    card = card or {}
    kernels = {}
    for name, e in sorted(ledger.items()):
        if "error" in e:
            raise SystemExit(f"--update refused: {name} failed to run "
                             f"({e['error']})")
        if e.get("platform") != "cpu":
            raise SystemExit("--update refused: the budgets are kept "
                             "against a CPU ledger")
        kernels[name] = {
            "shape": e["shape"],
            "argument_bytes": e["argument_bytes"],
            "output_bytes": e["output_bytes"],
            "launches": e["launches"],
            "launches_by_op": e["launches_by_op"],
            "bytes_bound": e["bytes_bound"],
            "flops_model": e["flops_model"],
        }
        for field in SOFT_TOL:          # card-measured
            if card.get(name, {}).get(field) is not None:
                kernels[name][field] = card[name][field]
            elif field in old.get("kernels", {}).get(name, {}):
                kernels[name][field] = old["kernels"][name][field]
    out = {
        "_note": ("The port's cost budgets per program per canonical "
                  "shape (opendht_tpu_torch/profiling.py KERNEL_SPECS), "
                  "counted on the CPU; peak_temp_bytes (soft) from a card "
                  "run's ledger record.  Gated by python -m "
                  "opendht_tpu_torch.perf_gate; re-base deliberately with "
                  "--update."),
        "platform": "cpu",
        "tolerance": old.get("tolerance", DEFAULT_TOL),
        "soft_tolerance": old.get("soft_tolerance", SOFT_TOL),
        "kernels": kernels,
        "open_bounds": old.get("open_bounds", {}),
        "timing_soft": old.get("timing_soft", {}),
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"perf_gate: budgets re-based for {len(kernels)} specs -> {path}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--budgets", default=BUDGETS)
    p.add_argument("--update", action="store_true",
                   help="re-base the budgets from a CPU ledger "
                        "(deliberate; review the diff)")
    p.add_argument("--records",
                   default=os.environ.get("OPENDHT_TPU_SMOKE_RECORD_DIR",
                                          ""),
                   help="smoke-record dir for the timing soft-warn pass "
                        "(and, with --update, a card run's ledger.json)")
    args = p.parse_args(argv)

    ledger = compute_ledger()

    if args.update:
        update_budgets(args.budgets, ledger, card_record(args.records))
        return 0

    if not os.path.exists(args.budgets):
        print(f"perf_gate: {args.budgets} missing — run "
              f"'python -m opendht_tpu_torch.perf_gate --update'",
              file=sys.stderr)
        return 1
    budgets = _load_budgets(args.budgets)
    failures, warnings = gate(budgets, ledger, args.records)
    for w in warnings:
        print("perf_gate WARN:", w)
    print_open_bounds(budgets)
    if failures:
        print("perf_gate: COST REGRESSION vs the port's perf_budgets.json:",
              file=sys.stderr)
        for fmsg in failures:
            print(" -", fmsg, file=sys.stderr)
        print("(if the change is intentional, re-base with 'python -m "
              "opendht_tpu_torch.perf_gate --update' and commit the diff)",
              file=sys.stderr)
        return 1
    print("perf_gate: %d spec budgets within tolerance on a CPU ledger "
          "(launches = ops dispatched on the CPU, not a card check; %d soft "
          "warnings)" % (len(budgets.get("kernels", {})), len(warnings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
