"""The traffic generator: the same seed gives the same inputs, every seed
the same multiset of sizes and gaps in another order, and the mixes'
medians and clips."""
import numpy as np
import pytest

from bench import traffic
from bench.common import BENCH, load_json

BIG = 2 ** 31 + 12345


def mix(name):
    return load_json(BENCH / "mixes" / f"{name}.json")


@pytest.mark.parametrize("name", ["chat", "code"])
def test_serve_block_deterministic_and_same_work(name):
    m = mix(name)
    a = traffic.serve_block(m, 131072, BIG, 1, 45)
    b = traffic.serve_block(m, 131072, BIG, 1, 45)
    c = traffic.serve_block(m, 131072, BIG + 1, 1, 45)
    assert len(a) == round(m["rate_per_s"] * 45)
    assert all(x.due == y.due and x.max_new == y.max_new
               and np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    key = lambda rs: sorted((len(r.prompt), r.max_new) for r in rs)  # noqa
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in c)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in c)
    gaps = lambda rs: sorted(np.diff([r.due for r in rs]).round(9))  # noqa
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]
    assert key(a) != [] and a[0].due == 0.0
    assert max(r.due for r in a) < 45 * 1.05
    assert len(gaps(a)) == len(a) - 1


@pytest.mark.parametrize("name", ["chat", "code"])
def test_medians_and_clips(name):
    m = mix(name)
    rs = traffic.serve_block(m, 1000, 7, 1, 500)
    p = np.array([len(r.prompt) for r in rs])
    o = np.array([r.max_new for r in rs])
    assert abs(np.median(p) / m["prompt"]["median"] - 1) < 0.02
    assert abs(np.median(o) / m["output"]["median"] - 1) < 0.05
    assert p.min() >= m["prompt"]["min"] and p.max() == m["prompt"]["max"]
    assert o.min() >= m["output"]["min"] and o.max() <= m["output"]["max"]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 1000 for r in rs)
    assert p.max() + o.max() <= m["max_seq"]
    gaps = np.diff([r.due for r in rs])
    assert abs(np.mean(gaps) * m["rate_per_s"] - 1) < 0.05


def test_train_rows_differ_by_learner_and_step():
    m = mix("ps-4k")
    a = traffic.train_batch(m, 100352, BIG, 0, 0)
    assert a["tokens"].shape == (1, 4096)
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert np.array_equal(a["tokens"],
                          traffic.train_batch(m, 100352, BIG, 0, 0)["tokens"])
    others = [traffic.train_batch(m, 100352, BIG, i, k)["tokens"]
              for i, k in ((1, 0), (0, 1), (1, 1))]
    assert all(not np.array_equal(a["tokens"], o) for o in others)
