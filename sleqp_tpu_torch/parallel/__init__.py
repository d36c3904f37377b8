"""Batched dense solves (``batch.py``): B instances of one problem in
lockstep lanes."""

from .batch import (
    batched_initial_state,
    batched_solve,
    batched_solve_chunked,
    batched_solve_mp,
    batched_step,
    multistart_from,
    multistart_solve,
)

__all__ = [
    "batched_initial_state",
    "batched_solve",
    "batched_solve_chunked",
    "batched_solve_mp",
    "batched_step",
    "multistart_from",
    "multistart_solve",
]
