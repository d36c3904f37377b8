"""Batched dense solves (``batch.py``): B instances of one problem in
lockstep lanes; and the sharded paths over ``torch.distributed``: the
scenario batch across ranks (``batch.sharded_solve``) and the Schur-complement
KKT solve (``schur.py``), on the collectives of ``collectives.py`` among the
ranks that ``ranks.py`` starts."""

from .batch import (
    batched_initial_state,
    batched_solve,
    batched_solve_chunked,
    batched_solve_mp,
    batched_step,
    gather_shards,
    multistart_from,
    multistart_solve,
    sharded_solve,
)
from .schur import chunk_layout, sharded_schur_solve

__all__ = [
    "batched_initial_state",
    "batched_solve",
    "batched_solve_chunked",
    "batched_solve_mp",
    "batched_step",
    "chunk_layout",
    "gather_shards",
    "multistart_from",
    "multistart_solve",
    "sharded_schur_solve",
    "sharded_solve",
]
