"""The traffic generators: the same seed gives the same inputs, every seed
the same sizes and counts, and the FSC-147 count composition."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.generators import fsc147_points, serve_requests

ROOT = harness.ROOT
SMALL_SERVE = {"heights": [64, 96], "widths": [64, 128], "per_size": 3, "bucket": [128, 128]}


def mix(name, **kw):
    return {**json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text()), **kw}


@pytest.mark.parametrize("name", ["serve_b32", "serve_b1"])
def test_serve_same_seed_same_requests(name):
    m = mix(name, **SMALL_SERVE)
    a = serve_requests.generate(m, 2**31 + 5, "cpu")
    b = serve_requests.generate(m, 2**31 + 5, "cpu")
    c = serve_requests.generate(m, 7, "cpu")
    assert len(a["requests"]) == 12
    for (ia, ba), (ib, bb) in zip(a["requests"], b["requests"]):
        assert ia.dtype == np.uint8 and np.array_equal(ia, ib) and np.array_equal(ba, bb)
    sizes = lambda t: sorted(r[0].shape for r in t["requests"])
    assert sizes(a) == sizes(c)  # every seed the same sizes, in its own order
    assert [r[0].shape for r in a["requests"]] != [r[0].shape for r in c["requests"]] or \
        not all(np.array_equal(x[0], y[0]) for x, y in zip(a["requests"], c["requests"]))
    lo, hi = m["exemplar_area"]
    for _, boxes in a["requests"]:
        assert boxes.shape == (3, 4) and (boxes >= lo).all() and (boxes <= hi).all()
        assert (boxes[:, 2:] > boxes[:, :2]).all()
    assert a["requests_per_call"] == m["requests_per_call"]
    assert a["requests"][a["largest"]][0].shape[:2] == (96, 128)


def test_serve_calls_cycle_the_pool():
    t = {"requests": list(range(5)), "requests_per_call": 2}
    assert serve_requests.calls(t, 0, 3) == [[0, 1], [2, 3], [4, 0]]
    assert serve_requests.calls(t, 3, 1) == [[1, 2]]


def test_fsc147_count_composition():
    m = mix("fsc147_pseudo")
    counts = fsc147_points.dataset_counts(m)
    assert len(counts) == 6144 and counts[-1] == 3731 and max(counts) == 3731
    assert min(counts) == 7 and counts == sorted(counts) and counts.count(3731) == 1
    # the (i + 0.5) / 6144 quantiles of the log-normal of median 35, sigma 1:
    # FSC-147's mean of 56 and its 343,818 objects over 6135 images
    assert counts[3071] == 35 and counts[-2] == 1144
    assert 55 < np.mean(counts) < 60 and 340_000 < sum(counts) < 360_000
    # the point tiers: 594 images over 128 dots, 8 over 700
    assert sum(c > 128 for c in counts) == 594 and sum(c > 700 for c in counts) == 8


def test_fsc147_same_seed_same_dataset():
    m = mix("fsc147_pseudo", height=32, widths=[32, 64], block=6, dataset_images=9,
            warm_widths=[32, 64], warm_counts=[3, 9], max_points=50, lognormal_median=5)
    a = fsc147_points.generate(m, 12345678901, "cpu")
    b = fsc147_points.generate(m, 12345678901, "cpu")
    c = fsc147_points.generate(m, 4, "cpu")
    da, db, dc = a["dataset"](3), b["dataset"](3), c["dataset"](3)
    assert len(da) == 18 and a["block"] == 6
    for i in range(len(da)):
        sa, sb = da[i], db[i]
        assert np.array_equal(sa["image"], sb["image"]) and np.array_equal(sa["points"], sb["points"])
        assert sa["orig_size"] == (sa["image"].shape[1], sa["image"].shape[0])
    # every seed the same counts over each pass through the dataset, in its own order
    per_pass = lambda d: [sorted(d.num_points(i) for i in range(r * 9, r * 9 + 9)) for r in range(2)]
    assert per_pass(da) == per_pass(dc) == [fsc147_points.dataset_counts(m)] * 2
    assert [da.num_points(i) for i in range(18)] != [dc.num_points(i) for i in range(18)]
    widths = lambda d: sorted(d.image_size(i)[1] for i in range(6))
    assert widths(da) == widths(dc) == [32, 32, 32, 64, 64, 64]
    # fresh dots in every block, the pixels shared by reference
    assert not np.array_equal(da[0]["points"], da[6]["points"]) or da.num_points(0) != da.num_points(6)
    assert da[0]["image"] is da[6]["image"]
    warm = a["warm"]
    assert sorted((warm.image_size(i)[1], warm.num_points(i)) for i in range(len(warm))) == \
        [(32, 3), (32, 9), (64, 3), (64, 9)]


def test_fsc147_blocks_are_a_prefix():
    m = mix("fsc147_pseudo", height=32, widths=[32, 64], block=6, warm_widths=[32],
            warm_counts=[3], max_points=50, lognormal_median=5)
    t = fsc147_points.generate(m, 99, "cpu")
    short, long = t["dataset"](2), t["dataset"](5)
    for i in range(len(short)):  # a longer window sends the same first blocks
        assert np.array_equal(short[i]["points"], long[i]["points"])
    third = t["dataset"](1, 3)  # and any one block alone, as the traced run sends it
    for i in range(len(third)):
        assert np.array_equal(third[i]["points"], long[18 + i]["points"])
        assert third.image_size(i) == long.image_size(18 + i)
