"""The traffic generator: the same seed gives the same inputs, any whole
number is a seed, and lengths are uniform over their ranges."""

import itertools

import numpy as np
import pytest

from bench import harness, traffic

MAN = harness.load_manifest()
TRAIN = harness.resolve(MAN, "gpt2-124m.train_b64").traffic
SERVE = harness.resolve(MAN, "yi-6b.doc_qa").traffic
SMALL_TRAIN = dict(TRAIN, batch=3, seq_len=40, pool_batches=4)
SEEDS = [0, 7, 2**31 + 12345, 2**40 + 3]


def _requests(seed, n, params=SERVE, vocab=64000):
    return list(itertools.islice(traffic.requests(seed, params, vocab), n))


@pytest.mark.parametrize("seed", SEEDS)
def test_train_pool_repeats_from_its_seed(seed):
    a = traffic.train_pool(seed, SMALL_TRAIN, 1000)
    b = traffic.train_pool(seed, SMALL_TRAIN, 1000)
    assert a.shape == (4, 3, 41) and np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 1000
    rows = a.reshape(-1, 41)
    assert len({r.tobytes() for r in rows}) == len(rows)


def test_train_pool_differs_by_seed_and_follows_its_rule():
    a = traffic.train_pool(1, SMALL_TRAIN, 1000)
    assert not np.array_equal(a, traffic.train_pool(2, SMALL_TRAIN, 1000))
    rows = a.reshape(-1, 41).astype(np.int64)
    x, y = rows[:, :-1], rows[:, 1:]
    # token t+1 is (mult * token t + c) mod V but where noise replaced it:
    # some odd multiplier makes nine in ten steps agree on one c
    best = max(np.bincount(((y - mult * x) % 1000).ravel()).max()
               for mult in range(7, 47, 2))
    assert best >= 0.9 * x.size


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_repeat_from_their_seed(seed):
    a, b = _requests(seed, 40), _requests(seed, 40)
    assert all(np.array_equal(p, q) and n == m
               for (p, n), (q, m) in zip(a, b))
    lo, hi = SERVE["prompt_len"]
    olo, ohi = SERVE["output_len"]
    assert all(lo <= p.size <= hi and olo <= n <= ohi for p, n in a)
    assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 64000
               for p, _ in a)


def test_requests_differ_by_seed():
    a, b = _requests(1, 8), _requests(2, 8)
    assert [p.size for p, _ in a] != [p.size for p, _ in b]


@pytest.mark.parametrize("seed", SEEDS)
def test_lengths_are_uniform_over_their_range(seed):
    reqs = _requests(seed, 4000)
    for lens, (lo, hi) in (([p.size for p, _ in reqs], SERVE["prompt_len"]),
                           ([n for _, n in reqs], SERVE["output_len"])):
        lens = np.asarray(lens)
        span = hi - lo + 1
        assert lo <= lens.min() < lo + span // 50
        assert hi - span // 50 < lens.max() <= hi
        # each eighth of the range holds about an eighth of the draws
        counts = np.bincount(8 * (lens - lo) // span, minlength=8)
        assert np.all(np.abs(counts - 500) < 5 * np.sqrt(500 * 7 / 8))
