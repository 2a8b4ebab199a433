"""The port's kernel modules on the CPU against the JAX package's Pallas
kernels run in interpret mode.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests pin the plain versions to the Pallas kernels exactly (values and
indices, ties and gated rows included). The CUDA kernels are held against
the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerance everywhere here: exact equality.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.ops import (pallas_hamming,
                                                 pallas_patches, pallas_topk)
from orb_slam3_detailed_comments_tpu_torch import native
from orb_slam3_detailed_comments_tpu_torch.ops import hamming, patches, topk

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nms_like_cells(rng, rows):
    x = np.where(rng.uniform(size=(rows, 1024)) < 0.08,
                 rng.integers(7, 100, (rows, 1024)).astype(np.float32), 0.0)
    x = x.astype(np.float32)
    x[0, :] = 0.0                          # all-zero cell: ties everywhere
    x[1, 5] = x[1, 900] = 42.0             # tie: lower index must win
    x[2, :] = -np.inf                      # -inf padding row
    x[3, :] = -np.inf                      # fewer than k finite values
    x[3, [7, 700]] = 3.0
    return x


@pytest.mark.parametrize("k", [4, 8])
def test_cell_topk_plain_matches_pallas(rng, k):
    x = _nms_like_cells(rng, 137)
    v_ref, i_ref = pallas_topk.cell_topk(jnp.asarray(x[:2]), k,
                                         interpret=True)
    v, i = topk.cell_topk(_t(x), k)
    np.testing.assert_array_equal(v[:2].numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i[:2].numpy(), np.asarray(i_ref))
    # rows 4.. hold no all--inf row: the Pallas masking scheme is exact there
    v_ref, i_ref = pallas_topk.cell_topk(jnp.asarray(x[4:]), k,
                                         interpret=True)
    np.testing.assert_array_equal(v[4:].numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i[4:].numpy(), np.asarray(i_ref))
    assert i.dtype == torch.int32 and v.dtype == torch.float32


def test_cell_topk_plain_matches_lax_top_k_on_inf_rows(rng):
    """Rows with fewer than k finite values: the port's contract is
    lax.top_k's (distinct indices, lowest first), the reference the Pallas
    kernel replaces."""
    import jax
    x = _nms_like_cells(rng, 8)
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x), 8)
    v, i = topk.cell_topk(_t(x), 8)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_build_atlas_and_gather_match_pallas(rng):
    shapes = [(480, 752), (400, 632), (136, 256)]
    lv_np = [rng.uniform(0, 255, s).astype(np.float32) for s in shapes]
    atlas_ref, offs_ref = pallas_patches.build_atlas(
        [jnp.asarray(a) for a in lv_np], 752)
    atlas, offs = patches.build_atlas([_t(a) for a in lv_np], 752)
    assert offs == offs_ref
    np.testing.assert_array_equal(atlas.numpy(), np.asarray(atlas_ref))
    n = 48
    for pw in (31, 37):
        rcs = []
        for lv, s in enumerate(shapes):
            r = rng.integers(0, s[0] - pw, n)
            c = rng.integers(0, s[1] - pw, n)
            rcs.append(np.stack([r + offs[lv], c], 1))
        # corners past the atlas edge are clamped like lax.dynamic_slice
        rcs.append(np.array([[atlas.shape[0] - 3, atlas.shape[1] - 5],
                             [-4, -9]]))
        rc = np.concatenate(rcs).astype(np.int32)
        ref = pallas_patches.gather_patches_atlas(
            atlas_ref, jnp.asarray(rc[:-2]), pw, interpret=True)
        ref_xla = pallas_patches.gather_patches_atlas_xla(
            atlas_ref, jnp.asarray(rc), pw)
        out = patches.gather_patches(atlas, _t(rc), pw)
        assert out.shape == (len(rc), pw, pw)
        np.testing.assert_array_equal(out[:-2].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_xla))


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_hamming_best2_plain_matches_pallas(rng):
    Q, K = 256, 384
    da, db = _desc(rng, Q), _desc(rng, K)
    db[10] = da[0]                       # exact hits
    db[200] = da[0]                      # tie at a later index: d2 == d1
    db[11] = da[1]
    vb = rng.uniform(size=K) < 0.8
    vb[[10, 200, 11]] = True
    d1r, i1r, d2r = pallas_hamming.hamming_best2(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(vb), interpret=True)
    d1, i1, d2 = hamming.hamming_best2(_t(da.view(np.int32)),
                                       _t(db.view(np.int32)), _t(vb))
    for a, b in ((d1, d1r), (i1, i1r), (d2, d2r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(i1[0]) == 10 and int(d1[0]) == 0 and int(d2[0]) == 0
    # every target masked out: d1 = d2 = BIG, i1 = 0
    d1, i1, d2 = hamming.hamming_best2(_t(da.view(np.int32)),
                                       _t(db.view(np.int32)),
                                       torch.zeros(K, dtype=torch.bool))
    assert (d1 == hamming.BIG).all() and (d2 == hamming.BIG).all()
    assert (i1 == 0).all()


def test_hamming_windowed_plain_matches_pallas(rng):
    Q, K = 256, 256
    da, db = _desc(rng, Q), _desc(rng, K)
    q_uv = rng.uniform(0, 200, (Q, 2)).astype(np.float32)
    t_xy = rng.uniform(0, 200, (K, 2)).astype(np.float32)
    # on-the-edge window: |du| == r exactly must pass the float32 gate
    q_uv[3] = (50.0, 60.0)
    t_xy[5] = (58.0, 52.0)
    db[5] = da[3]
    q_r = rng.uniform(5, 40, Q).astype(np.float32)
    q_r[3] = 8.0
    q_lv = rng.integers(0, 8, Q).astype(np.int32)
    t_lv = rng.integers(0, 8, K).astype(np.int32)
    t_lv[5] = q_lv[3]
    lo = np.full(Q, -1, np.int32)
    hi = np.ones(Q, np.int32)
    qv = rng.uniform(size=Q) < 0.9
    qv[3] = True
    qv[4] = False                         # gated-out query row
    tv = rng.uniform(size=K) < 0.9
    tv[5] = True
    q_r[6] = 0.0                          # empty window: all-gated row
    ref = pallas_hamming.hamming_best2_windowed(
        jnp.asarray(da), jnp.asarray(q_uv), jnp.asarray(q_lv),
        jnp.asarray(q_r), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(qv),
        jnp.asarray(db), jnp.asarray(t_xy), jnp.asarray(t_lv),
        jnp.asarray(tv), interpret=True)
    out = hamming.hamming_best2_windowed(
        _t(da.view(np.int32)), _t(q_uv), _t(q_lv), _t(q_r), _t(lo), _t(hi),
        _t(qv), _t(db.view(np.int32)), _t(t_xy), _t(t_lv), _t(tv))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    d1, i1, d2 = out
    assert int(d1[3]) == 0 and int(i1[3]) == 5
    for row in (4, 6):
        assert int(d1[row]) == hamming.BIG == int(d2[row])
        assert int(i1[row]) == 0


def test_wrappers_do_not_count_cpu_calls(rng):
    native.reset_launches()
    topk.cell_topk(torch.zeros(4, 1024), 8)
    patches.gather_patches(torch.zeros(64, 128), torch.zeros(2, 2, dtype=torch.int32), 5)
    da = _t(_desc(rng, 128).view(np.int32))
    hamming.hamming_best2(da, da, torch.ones(128, dtype=torch.bool))
    assert all(v == 0 for v in native.launches.values())
