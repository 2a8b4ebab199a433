"""The lane scan and the lane merge of the CUDA best-2 searches, as tensor
functions on the CPU.

``csrc/hamming.cu`` gives a warp to each query: lane l scans targets
l, l + 32, ..., and the lanes merge their (d1, i1, d2) triples by a
butterfly of shuffles. ``hamming.lane_best2`` is that scan and
``hamming.merge_lane_best2`` that merge; merged, they must give what
``masked_best2`` gives on the whole row: the first index of the minimum, a
second-best that counts ties, and (BIG, 0, BIG) for a row with every target
gated out. Tolerance: exact. The inputs are full of ties: distances drawn
from a handful of values, equal minima planted in neighbouring lanes
(columns j and j + 1), in one lane's successive steps (j and j + 32), the two
best equal, and rows with every target gated.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from orb_slam3_detailed_comments_tpu_torch.ops import hamming

torch.set_num_threads(2)

KS = [1, 31, 33, 1000]


def _merged(dist, mask, lanes=hamming.LANES):
    return hamming.merge_lane_best2(*hamming.lane_best2(dist, mask, lanes))


def _assert_same(dist, mask, lanes=hamming.LANES):
    got = _merged(dist, mask, lanes)
    ref = hamming.masked_best2(dist, mask)
    for g, r, name in zip(got, ref, ("d1", "i1", "d2")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r.numpy(), err_msg=name)


def _tie_rows(K, rng):
    """[6, K] distances and masks: ties in neighbouring lanes, in one lane's
    successive steps, the two best equal, one admissible column, none."""
    d = rng.integers(40, 200, (6, K)).astype(np.int32)
    m = np.ones((6, K), bool)
    j = int(rng.integers(0, K))
    for row, other in ((0, j + 1), (1, j + 32), (2, K - 1)):
        d[row, j] = 3
        d[row, other % K] = 3                # equal minima: the first index wins
    d[3, :] = 7                              # every column ties
    m[4, :] = False
    m[4, j] = True                           # one admissible column: d2 = BIG
    m[5, :] = False                          # every target gated
    return torch.from_numpy(d), torch.from_numpy(m), j


@pytest.mark.parametrize("K", KS)
def test_merged_lanes_equal_the_whole_row_scan_on_ties(K):
    rng = np.random.default_rng(K)
    d, m, j = _tie_rows(K, rng)
    _assert_same(d, m)
    d1, i1, d2 = _merged(d, m)
    first = min(j, (j + 1) % K)
    assert int(i1[0]) == first and int(d1[0]) == 3
    assert int(d2[0]) == (3 if K > 1 else hamming.BIG)
    assert int(i1[3]) == 0 and int(d1[3]) == 7
    assert (int(d1[4]), int(i1[4]), int(d2[4])) == (int(d[4, j]), j,
                                                    hamming.BIG)
    assert (int(d1[5]), int(i1[5]), int(d2[5])) == (hamming.BIG, 0,
                                                    hamming.BIG)


@pytest.mark.parametrize("K", KS)
@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_values=st.integers(1, 4),
       p_mask=st.sampled_from([0.0, 0.05, 0.5, 1.0]))
def test_merged_lanes_equal_the_whole_row_scan(K, seed, n_values, p_mask):
    """Distances from n_values distinct values (ties everywhere), a mask
    that admits a column with probability p_mask."""
    rng = np.random.default_rng(seed)
    d = torch.from_numpy(rng.integers(0, n_values, (8, K)).astype(np.int32)
                         * 17)
    m = torch.from_numpy(rng.uniform(size=(8, K)) < p_mask)
    _assert_same(d, m)


@pytest.mark.parametrize("lanes", [1, 2, 16])
def test_any_power_of_two_lane_count(lanes):
    rng = np.random.default_rng(lanes)
    d, m, _ = _tie_rows(70, rng)
    _assert_same(d, m, lanes)


def test_lane_triples_are_what_a_lane_holds():
    """Lane l holds the best two of columns l, l + 32, ...; a lane without
    an admissible column holds (BIG, 0, BIG)."""
    d = torch.arange(100, 140, dtype=torch.int32)[None, :].clone()
    m = torch.ones((1, 40), dtype=torch.bool)
    m[0, 5] = False                       # lane 5 keeps column 37 only
    d[0, 33] = 50                         # lane 1: column 33 beats column 1
    d1, i1, d2 = hamming.lane_best2(d, m)
    assert d1.shape == (1, 32)
    assert (int(d1[0, 1]), int(i1[0, 1]), int(d2[0, 1])) == (50, 33, 101)
    assert (int(d1[0, 5]), int(i1[0, 5]), int(d2[0, 5])) == (137, 37,
                                                             hamming.BIG)
    assert (int(d1[0, 9]), int(i1[0, 9]), int(d2[0, 9])) == (109, 9,
                                                             hamming.BIG)
    none = hamming.lane_best2(d, torch.zeros_like(m))
    assert bool((none[0] == hamming.BIG).all() and (none[1] == 0).all()
                and (none[2] == hamming.BIG).all())


def test_merge_refuses_a_lane_count_that_is_no_power_of_two():
    z = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        hamming.merge_lane_best2(z, z, z)


def test_searches_through_the_lanes_equal_the_plain_versions():
    """The plain searches recomputed through the lane scan and merge."""
    rng = np.random.default_rng(9)
    Q, K = 64, 100
    desc = lambda n: torch.from_numpy(rng.integers(
        0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    da, db = desc(Q), desc(K)
    db[7] = da[0]
    db[39] = da[0]                        # lane 7 twice: steps 0 and 1
    db[8] = da[1]
    db[9] = da[1]                         # neighbouring lanes
    vb = torch.from_numpy(rng.uniform(size=K) < 0.8)
    vb[[7, 39, 8, 9]] = True
    dist = hamming.hamming_matrix(da, db)
    got = _merged(dist, vb[None, :].expand(Q, K))
    ref = hamming.hamming_best2_plain(da, db, vb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert (int(got[0][0]), int(got[1][0]), int(got[2][0])) == (0, 7, 0)
    assert (int(got[0][1]), int(got[1][1]), int(got[2][1])) == (0, 8, 0)
