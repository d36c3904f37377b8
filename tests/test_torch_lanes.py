"""``lanes.device_resident()``: the lanes' loops and branches without a host
read (sleqp_tpu_torch/lanes.py), the form a CUDA graph captures.

A capped ``lockstep`` loop there runs all its trips masked and gives the
reading loop's state, on one lane and under ``vmap``; an uncapped one
raises.  ``lanes_any`` answers ``True`` unread, and ``lanes_where`` then
selects per lane.
"""

import pytest
import torch

from sleqp_tpu_torch import lanes


def halve(carry, trip):
    x, k = carry
    return x / 2.0, k + 1


def above_one(carry):
    return carry[0] > 1.0


def starts(n=5):
    return torch.tensor([0.5, 3.0, 17.0, 1.0, 1000.0][:n], dtype=torch.float64)


@pytest.fixture
def no_reads(monkeypatch):
    """Every host read of a tensor raises (truth values, items, Python
    numbers and ``lanes_any``'s read)."""
    def refuse(*args, **kwargs):
        raise AssertionError("host read")

    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(lanes, "read_flag", refuse)


def run(x, resident, max_trips=40):
    carry = (x, torch.zeros((), dtype=torch.int32))
    if resident:
        with lanes.device_resident():
            return lanes.lockstep(above_one, halve, carry, max_trips=max_trips)
    return lanes.lockstep(above_one, halve, carry, max_trips=max_trips)


@pytest.mark.parametrize("max_trips", [40, 3, 0])
def test_capped_loop_gives_the_reading_loop_state(max_trips):
    for x in starts():
        want = run(x, resident=False, max_trips=max_trips)
        got = run(x, resident=True, max_trips=max_trips)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # under vmap: lanes stop on different trips
    want = torch.func.vmap(lambda x: run(x, resident=False, max_trips=max_trips))(starts())
    got = torch.func.vmap(lambda x: run(x, resident=True, max_trips=max_trips))(starts())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if max_trips == 40:
        assert got[1].tolist() == [0, 2, 5, 0, 10]


def test_first_mask_is_the_first_trip(no_reads):
    """``first=`` gives the first trip's active lanes, ``cond`` the later
    trips'."""
    x = torch.tensor(8.0, dtype=torch.float64)
    k = torch.tensor(0)
    with lanes.device_resident():
        off = lanes.lockstep(above_one, halve, (x, k), max_trips=1, first=torch.tensor(False))
        on = lanes.lockstep(above_one, halve, (x, k), max_trips=1, first=torch.tensor(True))
        later = lanes.lockstep(above_one, halve, (x, k), max_trips=3, first=torch.tensor(False))
    assert torch.equal(off[0], x) and torch.equal(off[1], k)
    assert torch.equal(on[0], x / 2) and torch.equal(on[1], k + 1)
    assert torch.equal(later[0], x / 4) and torch.equal(later[1], k + 2)


def test_read_free_loop_reads_nothing(no_reads):
    got = run(starts()[2], resident=True)
    assert torch.equal(got[1], torch.tensor(5, dtype=torch.int32))
    vmapped = torch.func.vmap(lambda x: run(x, resident=True))(starts())
    assert torch.equal(vmapped[1], torch.tensor([0, 2, 5, 0, 10], dtype=torch.int32))


def test_uncapped_loop_raises():
    with lanes.device_resident(), pytest.raises(ValueError, match="max_trips"):
        lanes.lockstep(above_one, halve, (starts()[1], torch.tensor(0)))
    # outside the mode the same loop reads and ends
    assert torch.equal(lanes.lockstep(above_one, halve, (starts()[1], torch.tensor(0)))[1],
                       torch.tensor(2))


def test_branches_without_a_read(no_reads):
    flag = torch.tensor(False)
    a, b = torch.tensor(1.0), torch.tensor(2.0)
    with lanes.device_resident():
        assert lanes.is_device_resident()
        assert lanes.lanes_any(flag) is True
        assert torch.equal(lanes.lanes_where(flag, a, b), b)
        assert lanes.lanes_any(False) is False  # a Python flag is no read
    assert not lanes.is_device_resident()


def test_mode_is_restored_after_an_error():
    with pytest.raises(RuntimeError):
        with lanes.device_resident():
            raise RuntimeError("inside")
    assert not lanes.is_device_resident()
    assert lanes.lanes_any(torch.tensor(False)) is False
