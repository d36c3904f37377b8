"""The suite sweep of the port, held to the reference's r5 sweep.

Runs ``sleqp_tpu_torch.harness.run_problem`` over the 101 rows of
``artifacts/suite_all_{f64,mixed}_r5.csv`` (or the rows given by
``--names``; the three large banded rows go through ``banded_solve``) on one route and one device, writes the CSV in the
reference's schema, and applies the end gate against the r5 CSV of the
same route:

* each row has the r5 status;
* on each ``optimal`` row the objective is within 1e-6 of the r5 one,
  relative (absolute where |f| < 1);
* the count of rows solved with the objective matched (the driver's own
  accounting, 1e-4 of f_opt) is no lower than the r5 count on the same
  rows.

The exceptions are the named rounding ties of ``TIES``, each shown by
``tools/suite_tie_check.py`` (ROADMAP.md queue C): there the status may
differ, and the solved counts leave the row out.  Rows more than 3
iterations from the r5 CSV are listed.  Usage:

    python3 tools/torch_suite.py --route float64 --device cpu \
        --out artifacts/suite_torch_f64_cpu.csv

exits 1 when the gate fails.  The route ``mixed`` is
``Settings(compute_dtype="float32")``; the iteration cap is the r5 sweep's,
1000.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

ORACLES = {
    "float64": os.path.join(REPO, "artifacts", "suite_all_f64_r5.csv"),
    "mixed": os.path.join(REPO, "artifacts", "suite_all_mixed_r5.csv"),
}
MAX_ITERATIONS = 1000
OBJ_TOL = 1e-6
ITER_SLACK = 3

# (route, row) -> the evidence that the row's difference from the r5 CSV
# is a rounding tie (tools/suite_tie_check.py, CPU).
TIES = {
    ("mixed", "extrosnb100"): (
        "r5 OPTIMAL in 46, the port's CPU sweep 1000 (the card's 67): the port takes JAX's "
        "decisions from 45 of JAX's 47 states (of the 2 others JAX without jit takes the "
        "port's at 1), and JAX the port's from 977 of the port's 1000"),
    ("mixed", "powellsg100"): (
        "r5 OPTIMAL in 102, the port's CPU sweep 1000 (the card's 84): the port takes JAX's "
        "decisions from 95 of JAX's 103 states (of the 8 others JAX without jit takes the "
        "port's at 5), and JAX the port's from 983 of the port's 1000"),
}


def read_rows(path: str) -> dict:
    """name -> row fields of a suite CSV (header and '#' lines skipped)."""
    rows = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("name;"):
                continue
            fields = line.split(";")
            rows[fields[0]] = fields
    return rows


def settings_of(route: str):
    from sleqp_tpu_torch import Settings

    return Settings(compute_dtype="float32") if route == "mixed" else Settings()


def objective_solved(fields, f_opt) -> bool:
    """The driver's accounting: optimal, and the objective within 1e-4 of
    the published optimum (when one is known)."""
    if fields[3] != "optimal":
        return False
    return f_opt is None or abs(float(fields[4]) - f_opt) <= 1e-4 * (1.0 + abs(f_opt))


def gate(rows: dict, oracle: dict, f_opts: dict, route: str) -> dict:
    """The end gate of ``rows`` (name -> fields) against ``oracle`` on the
    same names: a dict with the failures, the named ties that differ, the
    solved counts and the rows whose iterations differ by more than
    ITER_SLACK."""
    status_bad, obj_bad, iter_far, ties = [], [], [], []
    solved = solved_ref = 0
    for name, fields in rows.items():
        ref = oracle[name]
        if (route, name) in TIES and fields[3] != ref[3]:
            ties.append(f"{name}: {fields[3]} {fields[8]} iterations (r5 {ref[3]} {ref[8]})")
            continue
        if fields[3] != ref[3]:
            status_bad.append(f"{name}: {fields[3]} (r5 {ref[3]})")
        elif fields[3] == "optimal":
            f, f_ref = float(fields[4]), float(ref[4])
            if abs(f - f_ref) > OBJ_TOL * max(1.0, abs(f_ref)):
                obj_bad.append(f"{name}: {f!r} (r5 {f_ref!r})")
        if abs(int(fields[8]) - int(ref[8])) > ITER_SLACK:
            iter_far.append(f"{name}: {fields[8]} (r5 {ref[8]})")
        solved += objective_solved(fields, f_opts[name])
        solved_ref += objective_solved(ref, f_opts[name])
    return {
        "ok": not status_bad and not obj_bad and solved >= solved_ref,
        "status": status_bad,
        "objective": obj_bad,
        "ties": ties,
        "solved": solved,
        "solved_r5": solved_ref,
        "iterations_far": iter_far,
        "iterations": sum(int(f[8]) for f in rows.values()),
        "iterations_r5": sum(int(oracle[n][8]) for n in rows),
    }


def run(route: str, device: str, names=None, out=None, verbose=True):
    """Sweep ``names`` (default: every r5 row) on ``route`` and
    ``device``; returns (rows, gate result, seconds)."""
    import torch

    from sleqp_tpu_torch.harness.driver import ALL_PROBLEMS, CSV_HEADER, get_problem, run_problem

    oracle = read_rows(ORACLES[route])
    names = list(names) if names else [n for n in oracle if n in ALL_PROBLEMS]
    settings = settings_of(route)
    rows, f_opts = {}, {}
    fh = open(out, "w") if out else None
    if fh:
        fh.write(CSV_HEADER + "\n")
    start = time.perf_counter()
    for name in names:
        _, _, f_opts[name] = get_problem(name, "cpu")
        row, _, _ = run_problem(name, settings, MAX_ITERATIONS, device=torch.device(device))
        rows[name] = row.split(";")
        if verbose:
            print(row, flush=True)
        if fh:
            fh.write(row + "\n")
            fh.flush()
    seconds = time.perf_counter() - start
    result = gate(rows, oracle, f_opts, route)
    if fh:
        fh.write(f"# solved {result['solved']}/{len(rows) - len(result['ties'])} "
                 f"(r5 {result['solved_r5']}; named ties left out: {result['ties']}), "
                 f"gate {'pass' if result['ok'] else 'FAIL'}, {seconds:.1f} s\n")
        fh.close()
    return rows, result, seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", choices=sorted(ORACLES), default="float64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--names", nargs="*", help="rows to run (default: the 101 rows)")
    ap.add_argument("--out", help="CSV to write")
    ap.add_argument("--threads", type=int, default=1,
                    help="CPU threads of torch (default 1: the problems are small)")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(args.threads)
    rows, result, seconds = run(args.route, args.device, args.names, args.out)
    print(f"# route {args.route} device {args.device}: {len(rows)} rows in {seconds:.1f} s, "
          f"{result['iterations']} iterations (r5 {result['iterations_r5']})")
    print(f"# solved {result['solved']} (r5 {result['solved_r5']})")
    for key in ("status", "objective", "ties", "iterations_far"):
        print(f"# {key}: {result[key]}")
    print(f"# gate {'pass' if result['ok'] else 'FAIL'}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
