"""Structured linear algebra of the port: batched inverses, cyclic
reduction and block-tridiagonal solves."""
