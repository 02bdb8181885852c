"""The window's kept outputs: each item's first and a bounded sample of
the rest, drawn from the seed."""

from chanbench import harness


def _fill(n_items, n, seed):
    s = harness.Sample(n_items, seed)
    for k in range(n):
        s.offer(k, {"k": k})
    return s


def test_sample_keeps_each_first_and_at_most_sample():
    s = _fill(8, 3000, 2147483901)
    ks = [o["k"] for o in s.outputs()]
    assert ks[:8] == list(range(8))
    assert len(ks) == 8 + harness.SAMPLE
    assert ks[8:] == sorted(ks[8:]) and len(set(ks)) == len(ks)
    assert s.items() == [k % 8 for k in ks]


def test_sample_is_drawn_from_the_seed():
    a = [o["k"] for o in _fill(8, 3000, 7).outputs()]
    b = [o["k"] for o in _fill(8, 3000, 7).outputs()]
    c = [o["k"] for o in _fill(8, 3000, 8).outputs()]
    assert a == b and a != c


def test_short_window_keeps_everything():
    s = _fill(4, 3, 1)
    assert [o["k"] for o in s.outputs()] == [0, 1, 2]
