"""Times the port's single-lane main path in two checkouts on one card:
``chip_smoke.py``'s phases 7 (the dense solve), 9 (the PDLP Cauchy LP) and
11 (the suite sweep on both routes), each checkout in a process of its own,
in the order A, B, B, A, so that a drift of the card or the host during the
call shows as a gap between the two runs of one checkout.

Usage, on a machine with a card:

    python3 tools/main_path_ab.py DIR_A DIR_B [--phases 7 9 11]

DIR_A and DIR_B are checkouts of the repository (``git archive`` of a
commit unpacked into a directory that ``.gitignore`` lists, or the
repository itself).  Prints the card's name and power limit, every run's
phase lines with its label, then one table of the times those lines give.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

PHASES = {7: "dense_phase", 9: "pdlp_phase", 11: "suite_phase"}
# (label of a row, pattern of its line, the groups it reads)
TIMES = (
    (r"7 {0}: ms per iteration",
     r"phase 7: dense (\S+ \(\w+\)):.*card [\d.]+ s per solve, ([\d.]+) ms per iteration"),
    ("9 PDLP LP: ms per PDHG iteration",
     r"phase 9: (PDLP) Cauchy LP.*card [\d.]+ ms per LP, ([\d.]+) ms per PDHG iteration"),
    ("9 {0} Solver: s",
     r"phase 9: (hs35) Solver on PDLP.*; card ([\d.]+) s"),
    ("11 suite {0}: ms per iteration",
     r"phase 11: suite (\w+) on the card:.*iterations \(r5 \d+\), ([\d.]+) ms per iteration"),
)


def run(label: str, root: str, phases: list[int]) -> list[str]:
    """The phase lines of one run of ``phases`` in the checkout ``root``."""
    calls = "; ".join(f"cs.{PHASES[p]}(log)" for p in phases)
    code = f"import chip_smoke as cs; log = cs.Log(); {calls}"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if "] phase " in ln]
    for ln in lines:
        print(f"{label} {ln}", flush=True)
    if proc.returncode != 0:
        print(f"{label} exited {proc.returncode}:\n{proc.stderr[-4000:]}", flush=True)
        raise SystemExit(1)
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a", help="the first checkout (A)")
    parser.add_argument("b", help="the second checkout (B)")
    parser.add_argument("--phases", type=int, nargs="+", default=sorted(PHASES),
                        choices=sorted(PHASES))
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    order = (("A1", args.a), ("B1", args.b), ("B2", args.b), ("A2", args.a))
    table: dict[str, dict[str, str]] = {}
    for label, root in order:
        for ln in run(label, root, args.phases):
            for row, pattern in TIMES:
                m = re.search(pattern, ln)
                if m:
                    table.setdefault(row.format(m.group(1)), {})[label] = m.group(2)
    print("row | " + " | ".join(label for label, _ in order))
    for row, cells in table.items():
        print(f"{row} | " + " | ".join(cells.get(label, "-") for label, _ in order))


if __name__ == "__main__":
    main()
