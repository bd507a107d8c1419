"""The open-loop schedule is fixed by the seed, and every seed offers the
same work in another order."""
import numpy as np

from portbench.harness import traffic as tr

MIX = {"loop": "open", "rate_per_s": 200.0, "sizes": [1, 2, 4, 8, 16], "classes": "uniform"}


def _flat(plan):
    return [(p.due, p.classes.tolist()) for p in plan]


def test_same_seed_same_schedule():
    a = tr.open_schedule(MIX, {"classes": 102}, 10.0, 2**31 + 77)
    b = tr.open_schedule(MIX, {"classes": 102}, 10.0, 2**31 + 77)
    assert _flat(a) == _flat(b)


def test_seeds_order_the_same_work():
    a = tr.open_schedule(MIX, {"classes": 102}, 10.0, 5)
    b = tr.open_schedule(MIX, {"classes": 102}, 10.0, 6)
    assert _flat(a) != _flat(b)
    sizes_a = sorted(len(p.classes) for p in a)
    sizes_b = sorted(len(p.classes) for p in b)
    # the same multiset of sizes and gaps, up to the last arrivals cut at the end
    assert abs(len(a) - len(b)) <= 3
    assert abs(sum(sizes_a) - sum(sizes_b)) <= 3 * 16
    gaps_a = np.sort(np.diff([p.due for p in a]))
    gaps_b = np.sort(np.diff([p.due for p in b]))
    n = min(len(gaps_a), len(gaps_b)) - 3
    assert np.allclose(gaps_a[:n], gaps_b[:n], rtol=0.2, atol=1e-4)
    assert 1900 <= len(a) <= 2000  # ~ rate x seconds
    assert all(0 <= p.due < 10.0 for p in a)
    assert all(((p.classes >= 0) & (p.classes < 102)).all() for p in a)


def test_grid_request():
    mix = {"classes": "grid", "class_ids": list(range(10)), "per_class": 5}
    assert tr.grid_classes(mix).tolist() == [c for c in range(10) for _ in range(5)]
    assert tr.request_sizes(mix) == [50]
    assert tr.request_sizes(MIX) == [1, 2, 4, 8, 16]
