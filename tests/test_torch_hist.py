"""Port parity: the level histogram of ``h2o_tpu_torch`` against the
reference's kernels layer (``h2o_tpu/backend/kernels/hist.py``), flat and
grouped, and the engine's grouped plan and scatter-back.

The same seeded numpy inputs go through the reference's Pallas kernels (run
interpreted on the CPU, as tests/test_kernels.py runs them), its XLA scans,
and the port's plain versions — what a wrapper takes for a CPU tensor.
Integer-valued channels (row weights) must be exactly equal: sums of
small integers are exact in f32 in any order. Real channels match
at rtol 1e-5, atol 1e-5, because the two sum each block in different
orders (XLA's dot vs torch's einsum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.backend import kernels as jkernels
from h2o_tpu.backend.kernels import hist as jhist
from h2o_tpu.models.tree import engine as jengine
from h2o_tpu_torch.backend import kernels as tkernels
from h2o_tpu_torch.backend.kernels import hist as thist
from h2o_tpu_torch.models.tree import engine as tengine

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


def _inputs(R, F, B, n_lv, V, dtype, seed=0, na_frac=0.1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B - 1, (R, F))
    codes = np.where(rng.random((R, F)) < na_frac, B - 1, codes)  # NA bucket
    lc = rng.integers(0, n_lv, R).astype(np.int32)
    vv = rng.normal(size=(R, V)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 4, R)          # integer-valued weights
    return codes.astype(dtype), lc, vv


def _numpy(h):
    """A flat histogram, or each of a grouped call's, as numpy."""
    if isinstance(h, tuple):
        return tuple(_numpy(x) for x in h)
    return h.numpy() if isinstance(h, torch.Tensor) else np.asarray(h)


def _both(codes, lc, vv, **kw):
    ref = {bk: _numpy(jhist.level_hist_blocks(
        jnp.asarray(codes), jnp.asarray(lc), jnp.asarray(vv), backend=bk,
        **kw)) for bk in ("pallas", "xla")}
    port = _numpy(thist.level_hist_blocks(torch.from_numpy(codes),
                                          torch.from_numpy(lc),
                                          torch.from_numpy(vv), **kw))
    return ref, port


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("n_lv", [1, 4, 16])
def test_flat_matches_reference_kernel_and_scan(dtype, n_lv):
    codes, lc, vv = _inputs(4096, 7, 21, n_lv, 3, dtype)
    ref, port = _both(codes, lc, vv, n_lv=n_lv, nbins_tot=21, block=1024)
    assert port.shape == (7, n_lv, 21, 3)
    for h in ref.values():
        assert np.array_equal(port[..., 0], h[..., 0])   # weights: exact
        np.testing.assert_allclose(port, h, rtol=RTOL, atol=ATOL)
    assert port[:, :, -1, 0].sum() > 0                  # NA mass in last bin


def test_out_of_range_codes_and_nodes_add_nothing():
    """One-hot semantics at the edges: a code outside [0, B) or a node id
    outside [0, n_lv) matches no column, on both packages."""
    codes, lc, vv = _inputs(2048, 5, 9, 4, 3, np.int16)
    codes[::7, 2] = -1
    codes[::11, 3] = 9
    lc[::13] = 4
    ref, port = _both(codes, lc, vv, n_lv=4, nbins_tot=9, block=512)
    assert np.array_equal(port[..., 0], ref["xla"][..., 0])
    np.testing.assert_allclose(port, ref["xla"], rtol=RTOL, atol=ATOL)


def test_cpu_tensor_takes_the_plain_version_and_grouped_plans_refuse():
    """A CPU tensor takes the plain version, flat or grouped, and launches
    nothing (the name dates from when grouped plans were refused)."""
    codes, lc, vv = _inputs(1024, 3, 11, 2, 3, np.int8)
    args = (torch.from_numpy(codes), torch.from_numpy(lc),
            torch.from_numpy(vv))
    before = (thist.LAUNCHES, thist.GROUPED_LAUNCHES)
    flat = thist.level_hist_blocks(*args, n_lv=2, nbins_tot=11, block=256)
    grouped = thist.level_hist_blocks(*args, n_lv=2, nbins_tot=11, block=256,
                                      groups=(((0, 1, 2), 16, "onehot"),))
    assert (thist.LAUNCHES, thist.GROUPED_LAUNCHES) == before
    assert len(grouped) == 1 and grouped[0].shape == (3, 2, 16, 3)
    # one group at width 16 holds the 11-bin flat histogram, NA in slot 15
    assert torch.equal(grouped[0][:, :, :10], flat[:, :, :10])
    assert torch.equal(grouped[0][:, :, 15], flat[:, :, 10])


#: mixed widths of a 33-bin space: a narrow segsum bucket, a onehot bucket
#: and a full-width bucket whose NA slot is the global one
_GROUPS = (((0, 2, 4), 8, "segsum"), ((1, 3, 5), 16, "onehot"),
           ((6,), 33, "onehot"))
#: the width of each feature's codes: data bins 0..w-2 (NA is B-1)
_FEATURE_BINS = (7, 15, 7, 15, 7, 15, 32)


def _grouped_inputs(R, n_lv, dtype, seed=0, B=33):
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, w, R) for w in _FEATURE_BINS], 1)
    codes = np.where(rng.random(codes.shape) < 0.1, B - 1, codes)  # NA
    lc = rng.integers(0, n_lv, R).astype(np.int32)
    vv = rng.normal(size=(R, 3)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 4, R)          # integer-valued weights
    return codes.astype(dtype), lc, vv


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
@pytest.mark.parametrize("n_lv", [1, 4, 16])
def test_grouped_matches_reference_kernel_and_scan(dtype, n_lv):
    """Per group: the port's plain version against the reference's XLA
    scan and its Pallas kernel (interpreted), segsum and onehot buckets,
    NA remapped to each group's last slot."""
    codes, lc, vv = _grouped_inputs(4096, n_lv, dtype)
    kw = dict(n_lv=n_lv, nbins_tot=33, block=1024, groups=_GROUPS)
    ref, port = _both(codes, lc, vv, **kw)
    assert len(port) == len(_GROUPS)
    for bk, hs in ref.items():
        for (idxs, Bg, _mode), h, p in zip(_GROUPS, hs, port):
            assert p.shape == h.shape == (len(idxs), n_lv, Bg, 3)
            assert np.array_equal(p[..., 0], h[..., 0]), bk  # weights: exact
            np.testing.assert_allclose(p, h, rtol=RTOL, atol=ATOL)
            assert p[:, :, Bg - 1, 0].sum() > 0             # NA in last slot


@pytest.mark.parametrize("mode", ["segsum", "onehot"])
def test_one_group_matches_the_reference(mode):
    codes, lc, vv = _grouped_inputs(2048, 4, np.int16, seed=2)
    xg = np.ascontiguousarray(codes[:, [0, 2, 4]])
    kw = dict(Bg=8, mode=mode, n_lv=4, nbins_tot=33, block=512)
    ref = np.asarray(jhist.level_hist_one_group(
        jnp.asarray(xg), jnp.asarray(lc), jnp.asarray(vv), backend="xla",
        **kw))
    port = thist.level_hist_one_group(torch.from_numpy(xg),
                                      torch.from_numpy(lc),
                                      torch.from_numpy(vv), **kw).numpy()
    assert np.array_equal(port[..., 0], ref[..., 0])
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)


def test_scatter_group_hists_matches_the_reference():
    rng = np.random.default_rng(5)
    hists = [rng.normal(size=(len(idxs), 4, Bg, 3)).astype(np.float32)
             for idxs, Bg, _mode in _GROUPS]
    ref = np.asarray(jengine._scatter_group_hists(
        [jnp.asarray(h) for h in hists], _GROUPS, 7, 4, 33, 3))
    port = tengine._scatter_group_hists(
        [torch.from_numpy(h) for h in hists], _GROUPS, 7, 4, 33, 3).numpy()
    assert np.array_equal(port, ref)
    assert np.array_equal(port[1, :, 32], hists[1][0, :, 15])   # NA slot


def test_norm_groups_is_the_reference():
    groups = (((0, 1), 8), ((2,), 16, "segsum"))
    assert tengine._norm_groups(groups) == jengine._norm_groups(groups)


@pytest.mark.parametrize("n_lv,B,V", [(16, 1025, 3), (16, 301, 3),
                                      (4, 21, 1), (32, 9, 4)])
def test_tile_plan_covers_every_cell_once(n_lv, B, V):
    """The kernel's tile plan (host-side, so checked here): every output
    cell is owned by exactly one item, no tile exceeds shared memory, and a
    feature too wide for one tile is cut into node ranges."""
    feats = tuple((f, B, f * n_lv * B * V) for f in range(3))
    items, starts, tile_cells = thist._tile_plan(feats, n_lv, V)
    owned = np.zeros(3 * n_lv * B * V, np.int64)
    for col, n0, n1, bg, _smem, out in items:
        assert bg == B and 0 <= n0 < n1 <= n_lv
        assert out == col * n_lv * B * V + n0 * B * V
        owned[out:out + (n1 - n0) * B * V] += 1
    assert (owned == 1).all()
    assert starts[0] == 0 and starts[-1] == len(items)
    assert tile_cells * 8 + thist._ITEM_BYTES <= thist._MAX_TILE_BYTES
    if n_lv * B * V * 8 > thist._TILE_BYTES:
        assert len(items) > 3                                # node ranges
    with pytest.raises(NotImplementedError, match="shared memory"):
        thist._tile_plan(((0, 10_000, 0),), 1, 3)


@pytest.mark.parametrize("rl,want", [(8192, 8192), (11_001_856, 8192),
                                     (20224, 8192), (3000, 1024), (7, 4)])
def test_pow2_block_rows_is_the_reference(rl, want):
    assert tkernels.pow2_block_rows(rl, want) == \
        jkernels.pow2_block_rows(rl, want)


@pytest.mark.parametrize("nedges,budget", [
    ([19] * 28, None),                      # HIGGS: flat, one width
    ([19] * 6 + [299, 299, 21, 5], None),   # airlines-like: grouped
    ([19] * 28, 64 << 20),                  # tight budget: smaller block
])
def test_plan_hist_groups_is_the_reference(nedges, budget):
    kw = dict(budget_bytes=budget, n_lv_max=16, nvals=3)
    B = max(nedges) + 2
    assert tengine.plan_hist_groups(nedges, B, 8192, **kw) == \
        jengine.plan_hist_groups(nedges, B, 8192, **kw)
