"""The traffic generator: frame sets deterministic from the seed, the
sample drawn from it, and the open loop's schedule of due times."""

import time

import torch

from benchmark import drive, frames


def test_pool_is_deterministic_from_the_seed():
    a = frames.make_pool(2**31 + 99, 2, 3, (64, 32), "cpu")
    b = frames.make_pool(2**31 + 99, 2, 3, (64, 32), "cpu")
    c = frames.make_pool(2**31 + 100, 2, 3, (64, 32), "cpu")
    assert len(a) == 2 and all(len(s) == 3 for s in a)
    for sa, sb, sc in zip(a, b, c):
        for fa, fb, fc in zip(sa, sb, sc):
            assert fa.dtype == torch.uint8 and tuple(fa.shape) == (96, 32)
            assert torch.equal(fa, fb)
            assert tuple(fc.shape) == tuple(fa.shape) and not torch.equal(fa, fc)
    # distinct sets and cameras, with structure (not a constant)
    assert not torch.equal(a[0][0], a[1][0]) and not torch.equal(a[0][0], a[0][1])
    assert a[0][0][:64].float().std() > 10


def test_sample_is_drawn_from_the_seed():
    s = drive.sample_indices(2**31 + 5, 20.0, 4)
    assert s == drive.sample_indices(2**31 + 5, 20.0, 4)
    assert len(set(s)) == 4 and all(0 <= i < 160 for i in s)
    assert s != drive.sample_indices(2**31 + 6, 20.0, 4)


class _Echo:
    """A pipeline stand-in that hands each pushed set back at once."""

    def __init__(self):
        self.pushed = []

    def push(self, frames):
        self.pushed.append((time.perf_counter(), frames))

    def pop(self):
        while len(self.pushed) <= getattr(self, "n", 0):
            time.sleep(0.0005)
        self.n = getattr(self, "n", 0) + 1
        return [self.pushed[self.n - 1][1]]


def test_open_loop_pushes_on_schedule_in_order():
    amm = _Echo()
    pool = [[f"set{k}"] for k in range(3)]
    rate = 50.0
    due, popped, late, kept, errors = drive._open_loop(amm, pool, rate, 0.3, 0, (2,))
    assert not errors and len(due) == 15
    for i in range(1, len(due)):
        assert abs((due[i] - due[0]) - i / rate) < 1e-9
    for (t, f), d, i in zip(amm.pushed, due, range(len(due))):
        assert t >= d and f == pool[i % 3]
    assert all(p is not None and p >= d for p, d in zip(popped, due))
    assert max(late) < 0.05
    assert sorted(kept) == [2, 14] and kept[2][0] == 2 and kept[2][1] == [pool[2]]
