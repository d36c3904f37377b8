"""The port's package offers every public name of the reference's: each
name of ``sleqp_tpu.__all__`` and each name that ``sleqp_tpu.__getattr__``
provides lazily resolves on ``sleqp_tpu_torch``."""

import inspect
import re

import pytest

import sleqp_tpu
import sleqp_tpu_torch


def lazy_names():
    """The names ``sleqp_tpu.__getattr__`` answers (``if name == "..."``)."""
    return re.findall(r'name == "(\w+)"', inspect.getsource(sleqp_tpu.__getattr__))


def test_lazy_names_found():
    assert {"minimize", "Solver", "ScaledProblem", "derive_scaling", "ocp_solve"} <= set(
        lazy_names())


@pytest.mark.parametrize("name", sorted(set(sleqp_tpu.__all__) | set(lazy_names())))
def test_reference_name_resolves_on_the_port(name):
    assert getattr(sleqp_tpu_torch, name) is not None
    # a name the reference exports eagerly is exported by the port too
    if name in sleqp_tpu.__all__:
        assert name in sleqp_tpu_torch.__all__
