"""Minimal AMPL ``.nl`` front end (text/g format).

Port of ``sleqp_tpu/harness/ampl.py``.  The reference ships an AMPL
executable built on the AMPL Solver Library (bindings/ampl/ampl_main.c:
11-26: ASL_alloc + pfgh_read, evaluations through ASL).  Without ASL, this
module reads the TEXT (``g``) flavor of the ``.nl`` format, the encoding
documented in D. Gay, "Writing .nl Files" (Sandia, 2005), and builds the
constraint and objective expression graphs as torch functions on the
problem's device, so derivatives come from ``torch.func`` AD instead of
ASL's pfgh evaluators.

Scope (a documented subset): continuous variables, one objective, general
nonlinear + linear constraint parts (C/J/O/G/r/b/x segments), the common
operator opcodes (arithmetic, powers, abs/min/max, exp/log/sqrt,
trig/hyperbolic, sum lists).  Integer variables, logical constraints,
common subexpressions (``V`` segments), user functions and suffixes are
rejected with a clear error.  Solutions are written in the text ``.sol``
layout AMPL reads back (the ampl_output.c analogue).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from ..problem import Func, Problem

# opcode -> torch implementation; the numbers are ASL's opcode table
# ("Hooking Your Solver to AMPL", table 6 / opcode.hd)
_UNARY = {
    13: torch.floor,
    14: torch.ceil,
    15: torch.abs,
    16: lambda a: -a,
    37: torch.tanh,
    38: torch.tan,
    39: torch.sqrt,
    40: torch.sinh,
    41: torch.sin,
    42: torch.log10,
    43: torch.log,
    44: torch.exp,
    45: torch.cosh,
    46: torch.cos,
    47: torch.atanh,
    49: torch.atan,
    50: torch.asinh,
    51: torch.asin,
    52: torch.acosh,
    53: torch.acos,
    77: lambda a: a * a,  # OP2POW
}

_BINARY = {
    0: lambda a, b: a + b,
    1: lambda a, b: a - b,
    2: lambda a, b: a * b,
    3: lambda a, b: a / b,
    4: lambda a, b: a - b * torch.trunc(a / b),  # rem
    5: lambda a, b: a**b,
    6: lambda a, b: torch.maximum(a - b, torch.zeros_like(a - b)),  # less
    48: torch.atan2,
    76: lambda a, b: a**b,  # OP1POW (expr ^ const)
    78: lambda a, b: a**b,  # OPCPOW (const ^ expr)
}

_NARY = {
    11: lambda parts: torch.min(torch.stack(parts)),  # MINLIST
    12: lambda parts: torch.max(torch.stack(parts)),  # MAXLIST
    54: lambda parts: sum(parts[1:], parts[0]),  # OPSUMLIST
}


class NLFormatError(ValueError):
    pass


@dataclasses.dataclass
class _Expr:
    """Parsed prefix expression; evaluate(x) builds the torch graph."""

    kind: str  # "op" | "var" | "num"
    op: int = 0
    operands: tuple = ()
    value: float = 0.0
    var: int = 0

    def evaluate(self, x):
        if self.kind == "num":
            # filled on x's device: a copy from the host would synchronize,
            # which a CUDA graph of the iteration cannot capture
            return torch.full((), self.value, dtype=x.dtype, device=x.device)
        if self.kind == "var":
            return x[self.var]
        if self.op in _UNARY:
            return _UNARY[self.op](self.operands[0].evaluate(x))
        if self.op in _BINARY:
            return _BINARY[self.op](self.operands[0].evaluate(x), self.operands[1].evaluate(x))
        if self.op in _NARY:
            return _NARY[self.op]([o.evaluate(x) for o in self.operands])
        raise NLFormatError(f"unsupported opcode o{self.op}")


class _Reader:
    def __init__(self, text: str):
        # strip per-line comments ('#' to end of line)
        self.lines = [
            line.split("#")[0].rstrip() for line in text.splitlines()
        ]
        self.pos = 0

    def peek(self) -> Optional[str]:
        while self.pos < len(self.lines) and not self.lines[self.pos].strip():
            self.pos += 1
        if self.pos >= len(self.lines):
            return None
        return self.lines[self.pos]

    def next(self) -> str:
        line = self.peek()
        if line is None:
            raise NLFormatError("unexpected end of .nl file")
        self.pos += 1
        return line

    def read_expr(self) -> _Expr:
        tok = self.next().strip()
        head, rest = tok[0], tok[1:].strip()
        if head == "n":
            return _Expr("num", value=float(rest))
        if head == "v":
            return _Expr("var", var=int(rest))
        if head != "o":
            raise NLFormatError(f"unexpected expression line {tok!r}")
        op = int(rest)
        if op in _UNARY:
            return _Expr("op", op=op, operands=(self.read_expr(),))
        if op in _BINARY:
            return _Expr(
                "op", op=op, operands=(self.read_expr(), self.read_expr())
            )
        if op in _NARY:
            count = int(self.next().strip())
            return _Expr(
                "op",
                op=op,
                operands=tuple(self.read_expr() for _ in range(count)),
            )
        raise NLFormatError(f"unsupported opcode o{op}")


def _read_bounds(reader: _Reader, count: int):
    """One r/b-segment body: count lines of bound codes."""
    lb = np.full(count, -np.inf)
    ub = np.full(count, np.inf)
    for i in range(count):
        parts = reader.next().split()
        code = int(parts[0])
        if code == 0:  # lb <= . <= ub
            lb[i], ub[i] = float(parts[1]), float(parts[2])
        elif code == 1:  # . <= ub
            ub[i] = float(parts[1])
        elif code == 2:  # lb <= .
            lb[i] = float(parts[1])
        elif code == 3:  # free
            pass
        elif code == 4:  # equality
            lb[i] = ub[i] = float(parts[1])
        else:
            raise NLFormatError(f"unsupported bound code {code}")
    return lb, ub


def read_nl(path_or_text: str, device: Any = None):
    """Parse a text-format .nl file into (Problem, x0, sense).

    ``path_or_text`` is a filesystem path or the raw file contents.
    ``sense`` is +1 for minimize, -1 for maximize (the Problem is always
    a minimization; maximization objectives are negated on the way in
    and the reported objective must be negated on the way out).  The
    problem and x0 live on ``device`` (``None`` means CUDA).
    """
    if os.path.exists(path_or_text):
        with open(path_or_text) as fh:
            text = fh.read()
    else:
        text = path_or_text

    reader = _Reader(text)
    header = reader.next()
    if not header.lstrip().startswith("g"):
        raise NLFormatError(
            "only the text ('g') .nl flavor is supported (binary 'b' "
            "files: re-export with `ampl -og`)"
        )
    counts = [int(t) for t in reader.next().split()]
    n_vars, n_cons, n_objs = counts[0], counts[1], counts[2]
    if n_objs > 1:
        raise NLFormatError("multiple objectives are not supported")
    # skip the remaining header lines (nonlinear/network/discrete counts,
    # nnz, name lengths, common exprs) up to the first segment marker —
    # robust to the exact header length across format revisions
    while True:
        line = reader.peek()
        if line is None or line.strip()[0].isalpha():
            break
        reader.next()

    cons_nl: dict[int, _Expr] = {}
    obj_nl: Optional[_Expr] = None
    obj_sense = 0
    jac: dict[int, list] = {i: [] for i in range(n_cons)}
    grad: list = []
    x0 = np.zeros(n_vars)
    cons_lb = np.full(n_cons, -np.inf)
    cons_ub = np.full(n_cons, np.inf)
    var_lb = np.full(n_vars, -np.inf)
    var_ub = np.full(n_vars, np.inf)

    while True:
        line = reader.peek()
        if line is None:
            break
        head = line.strip()[0]
        if head == "C":
            idx = int(reader.next().strip()[1:])
            cons_nl[idx] = reader.read_expr()
        elif head == "O":
            parts = reader.next().strip()[1:].split()
            obj_sense = int(parts[1]) if len(parts) > 1 else 0
            obj_nl = reader.read_expr()
        elif head == "x":
            count = int(reader.next().strip()[1:])
            for _ in range(count):
                parts = reader.next().split()
                x0[int(parts[0])] = float(parts[1])
        elif head == "r":
            reader.next()
            cons_lb, cons_ub = _read_bounds(reader, n_cons)
        elif head == "b":
            reader.next()
            var_lb, var_ub = _read_bounds(reader, n_vars)
        elif head == "k":
            count = int(reader.next().strip()[1:])
            for _ in range(count):
                reader.next()  # cumulative column counts: unused
        elif head == "J":
            parts = reader.next().strip()[1:].split()
            idx, count = int(parts[0]), int(parts[1])
            for _ in range(count):
                vp = reader.next().split()
                jac[idx].append((int(vp[0]), float(vp[1])))
        elif head == "G":
            parts = reader.next().strip()[1:].split()
            count = int(parts[1])
            for _ in range(count):
                vp = reader.next().split()
                grad.append((int(vp[0]), float(vp[1])))
        elif head == "d":
            count = int(reader.next().strip()[1:])
            for _ in range(count):
                reader.next()  # initial duals: unused
        elif head in ("S", "V", "F", "L"):
            raise NLFormatError(
                f"unsupported .nl segment {head!r} (suffixes, defined "
                "variables, user functions, logical constraints)"
            )
        else:
            raise NLFormatError(f"unrecognized segment {line!r}")

    sense = -1.0 if obj_sense == 1 else 1.0

    def obj(x):
        val = (obj_nl.evaluate(x) if obj_nl is not None
               else torch.zeros((), dtype=x.dtype, device=x.device))
        for var, coeff in grad:
            val = val + coeff * x[var]
        return sense * val

    cons_fn = None
    if n_cons:

        def cons_fn(x):
            rows = []
            for i in range(n_cons):
                v = (cons_nl[i].evaluate(x) if i in cons_nl
                     else torch.zeros((), dtype=x.dtype, device=x.device))
                for var, coeff in jac[i]:
                    v = v + coeff * x[var]
                rows.append(v)
            return torch.stack(rows)

    func = Func(obj, num_variables=n_vars, cons=cons_fn, num_cons=n_cons)
    problem = Problem(
        func,
        var_lb=var_lb,
        var_ub=var_ub,
        general_lb=cons_lb if n_cons else None,
        general_ub=cons_ub if n_cons else None,
        device=device,
    )
    return problem, torch.as_tensor(x0, dtype=problem.dtype, device=problem.device), sense


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


_STATUS_SOLVED = 0
_STATUS_LIMIT = 400
_STATUS_INFEASIBLE = 200
_STATUS_FAILURE = 500


def write_sol(path: str, message: str, x, duals=None, solve_result=0):
    """Write a text .sol file AMPL reads back (ampl_output.c analogue)."""
    x = _host(x)
    duals = _host(duals) if duals is not None else np.zeros(0)
    with open(path, "w") as fh:
        fh.write(message.rstrip("\n") + "\n\n")
        fh.write("Options\n3\n0\n1\n0\n")
        fh.write(f"{len(duals)}\n{len(duals)}\n{len(x)}\n{len(x)}\n")
        for v in duals:
            fh.write(f"{v:.17g}\n")
        for v in x:
            fh.write(f"{v:.17g}\n")
        fh.write(f"objno 0 {int(solve_result)}\n")


def solve_nl(
    path: str,
    settings=None,
    max_iterations: int = 1000,
    sol_path: Optional[str] = None,
    device: Any = None,
):
    """Read, solve, and (optionally) write the .sol next to the .nl —
    the reference's ampl_main.c flow with the solver swapped in.  The
    solve runs on ``device`` (``None`` means CUDA)."""
    from ..solver import Solver
    from ..types import Status

    problem, x0, sense = read_nl(path, device=device)
    solver = Solver(problem, x0, settings, device=problem.device)
    status = solver.solve(max_iterations=max_iterations)
    obj_val = sense * solver.obj_val
    if sol_path is None and path.endswith(".nl"):
        sol_path = path[: -len(".nl")] + ".sol"
    if sol_path:
        code = {
            Status.OPTIMAL: _STATUS_SOLVED,
            Status.ABORT_ITER: _STATUS_LIMIT,
            Status.INFEASIBLE: _STATUS_INFEASIBLE,
        }.get(status, _STATUS_FAILURE)
        write_sol(
            sol_path,
            f"sleqp_tpu: {status.name}, objective {obj_val:.10g}",
            solver.solution,
            solver.cons_dual,
            code,
        )
    return solver, status, obj_val
