"""Card tests of the port's CUDA kernels against their plain versions: the
level histogram through its flat and grouped wrappers, the weighted Gram,
and small GLM, DRF, GBM-option and XGBoost fits on the card against the
same fits on the CPU; a CSV imported on both devices and a GBM with
cross-validation and calibration on it, and the multinomial AUC types;
the chunk decode on the card against the CPU decode for every codec
(bit-equal), a model saved on one device and loaded on the other, a GBM
killed and resumed on the card (bit-equal forest), a background job
training on the card; the Gram at PCA's MNIST design (z = None, a 0/1
mask), a DeepLearning run bit-equal twice on the card, and KMeans and PCA
on the card against the CPU (assignments agreeing on >= 99.9% of rows,
``tot_withinss`` and standard deviations within 1e-5 relative, vectors
equal up to sign where the eigenvalues are separated); a tiny AutoML plan
(GLM, GBM, DRF, DeepLearning, a GBM grid, both ensembles) on the card
against the CPU (metrics and predictions within 1e-4); the model surface
of a set-split GBM under three encodings on the card against the CPU
(encoded columns, covers, leaf ids and paths bit-equal, contributions
within 1e-5, staged predictions within 1e-6); GAM, RuleFit (built and
streamed) and CoxPH on the card against the CPU at ``chip_smoke.py``'s
tolerances for them, each Gram call on the card a launch; a MOJO of a
model trained on the card scored on the host and as a ``Generic`` model
whose frame lands on the card, and an SVMLight file imported on the card
bit-equal to the CPU's import; the kernel at V = 4 on uplift's channels
(every channel exact), an uplift forest and both isolation forests on the
card against the CPU.

They need a CUDA GPU and skip without one. On the card (which has no JAX,
so the repo's conftest must not load):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Integer-valued channels must match the plain version exactly (sums of
small integers are exact in f32 in any order); real channels within 1e-4
of each cell's absolute mass, the plain version's f32 rounding (its float
adds, in whatever order the card runs them) being well below that. Gram entries within 1e-5 of
each entry's absolute mass (the plain Gram of |X|, |W|, |z|): the kernel
and the plain version add the same products in other orders; on operands
TF32 cannot hold, within 1e-5 of the float64 Gram, which TF32 operands miss
by more than 1e-4.
"""

import numpy as np
import pytest
import torch

from h2o_tpu_torch.backend.kernels import gram, hist

pytestmark = pytest.mark.cuda

REAL_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest "
                    "tests/test_torch_cuda.py on the card")
    return torch.device("cuda")


def _inputs(R, F, B, n_lv, V, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, B + 1, (R, F))      # out-of-range codes add nothing
    lc = rng.integers(0, n_lv, R).astype(np.int32)
    vv = rng.normal(size=(R, V)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 5, R)             # integer-valued weights
    return (torch.from_numpy(codes).to(dtype).to(dev),
            torch.from_numpy(lc).to(dev), torch.from_numpy(vv).to(dev))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("R,F,B,n_lv,V", [(10007, 7, 21, 1, 3),
                                          (8192, 1, 33, 5, 1),
                                          (30000, 40, 9, 32, 4)])
def test_kernel_matches_plain(dev, dtype, R, F, B, n_lv, V):
    Xb, lc, vv = _inputs(R, F, B, n_lv, V, dtype, dev)
    before = hist.LAUNCHES
    k1 = hist.level_hist_blocks(Xb, lc, vv, n_lv=n_lv, nbins_tot=B, block=1024)
    k2 = hist.level_hist_blocks(Xb, lc, vv, n_lv=n_lv, nbins_tot=B, block=1024)
    assert hist.LAUNCHES == before + 2
    plain = hist._torch_flat(Xb, lc, vv, n_lv, B, 1024)
    mass = hist._torch_flat(Xb, lc, vv.abs(), n_lv, B, 1024)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)                            # deterministic
    assert torch.equal(k1[..., 0], plain[..., 0])         # integer channel
    assert bool(((k1 - plain).abs() <= REAL_TOL * mass).all())


def test_nonfinite_channel_comes_out_nan(dev):
    Xb, lc, vv = _inputs(4096, 3, 11, 2, 3, torch.int8, dev)
    vv[7, 1] = float("inf")
    h = hist._cuda_flat(Xb, lc, vv, 2, 11)
    assert bool(torch.isnan(h[..., 1]).all())
    assert bool(torch.isfinite(h[..., 0]).all() and torch.isfinite(h[..., 2]).all())


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """Wrong dtypes, devices, layouts and shapes raise in both wrappers; so
    does a feature whose one-node slice cannot fit in shared memory (a
    10,000-bin feature at V = 3 is 240,000 bytes)."""
    Xb, lc, vv = _inputs(1024, 3, 11, 2, 3, torch.int8, dev)
    groups = (((0, 1), 8, "segsum"), ((2,), 16, "onehot"))
    for call in (lambda *a: hist._cuda_flat(*a, 2, 11),
                 lambda *a: hist._cuda_grouped(*a, groups, 2, 10)):
        with pytest.raises(TypeError):
            call(Xb.to(torch.int64), lc, vv)
        with pytest.raises(TypeError):
            call(Xb, lc.long(), vv)
        with pytest.raises(ValueError):
            call(Xb, lc.cpu(), vv)
        with pytest.raises(ValueError):
            call(Xb.T.contiguous().T, lc, vv)
        with pytest.raises(ValueError):
            call(Xb, lc[:-1].contiguous(), vv)
        with pytest.raises(ValueError):
            call(Xb, lc, torch.zeros((1024, 5), device=dev))
    with pytest.raises(ValueError):
        hist._cuda_grouped(Xb, lc, vv, (((0, 3), 8, "onehot"),), 2, 10)
    with pytest.raises(NotImplementedError):
        hist._cuda_flat(Xb, lc, vv, 2, 10_000)


def test_flat_kernel_tiles_wide_features_by_node_range(dev):
    """B = 1025 at n_lv = 16: one feature's tile (16 x 1025 x 3 int64,
    393 KB) exceeds shared memory, so the plan cuts it into node ranges."""
    Xb, lc, vv = _inputs(50_000, 3, 1025, 16, 3, torch.int16, dev)
    k1 = hist._cuda_flat(Xb, lc, vv, 16, 1025)
    k2 = hist._cuda_flat(Xb, lc, vv, 16, 1025)
    plain = hist._torch_flat(Xb, lc, vv, 16, 1025, 1024)
    mass = hist._torch_flat(Xb, lc, vv.abs(), 16, 1025, 1024)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    assert torch.equal(k1[..., 0], plain[..., 0])
    assert bool(((k1 - plain).abs() <= REAL_TOL * mass).all())


def _grouped_inputs(R, widths, n_lv, dtype, dev, na_code, seed=1):
    """Codes per feature in [-2, w + 2): out of range on both sides, plus
    the global NA code; int64 first so int8 wraps nothing."""
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(-2, w + 2, R) for w in widths], 1)
    codes = np.where(rng.random(codes.shape) < 0.05, na_code, codes)
    lc = rng.integers(0, n_lv, R).astype(np.int32)
    vv = rng.normal(size=(R, 3)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 5, R)
    vv[rng.random(R) < 0.2] = 0.0                    # inactive rows
    return (torch.from_numpy(codes).to(dtype).to(dev),
            torch.from_numpy(lc).to(dev), torch.from_numpy(vv).to(dev))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("n_lv", [1, 16])
def test_grouped_kernel_matches_plain(dev, dtype, n_lv):
    """Mixed widths in one launch (segsum and onehot buckets, a 301-wide
    bucket that needs node ranges at n_lv = 16), negative and too-large
    codes, the NA remap, and run-to-run bit equality. int8 codes stay below
    128, so the 301-wide bucket runs at int16/int32 only."""
    wide = dtype != torch.int8
    B = 301 if wide else 33
    groups = (((0, 2, 4, 7, 8), 32, "onehot"), ((1,), 16, "onehot"),
              ((3,), 8, "segsum")) + ((((5, 6), 301, "onehot"),) if wide
                                      else (((5, 6), 33, "onehot"),))
    widths = [30, 14, 30, 6, 30, 299 if wide else 31, 299 if wide else 31,
              20, 20]
    Xb, lc, vv = _grouped_inputs(40_000, widths, n_lv, dtype, dev, B - 1)
    before = (hist.LAUNCHES, hist.GROUPED_LAUNCHES)
    k1 = hist.level_hist_blocks(Xb, lc, vv, n_lv=n_lv, nbins_tot=B,
                                block=1024, groups=groups)
    k2 = hist.level_hist_blocks(Xb, lc, vv, n_lv=n_lv, nbins_tot=B,
                                block=1024, groups=groups)
    assert (hist.LAUNCHES, hist.GROUPED_LAUNCHES) == (before[0],
                                                      before[1] + 2)
    xgs = [Xb[:, list(idxs)] for idxs, _Bg, _mode in groups]
    plain = hist._torch_grouped(xgs, lc, vv, groups, n_lv, B - 1, 1024)
    mass = hist._torch_grouped(xgs, lc, vv.abs(), groups, n_lv, B - 1, 1024)
    torch.cuda.synchronize()
    assert len(k1) == len(groups)
    for (idxs, Bg, _mode), a, b, p, m in zip(groups, k1, k2, plain, mass):
        assert a.shape == (len(idxs), n_lv, Bg, 3)
        assert torch.equal(a, b)                             # deterministic
        assert torch.equal(a[..., 0], p[..., 0])             # integer channel
        assert bool(((a - p).abs() <= REAL_TOL * m).all())
        assert float(a[:, :, Bg - 1, 0].sum()) > 0           # NA remapped


def _airlines_level(R, n_lv, dev, seed=3):
    """int16 codes at the airlines plan's widths with 5% NA (code 300),
    node ids, and [weight, g, h] channels with integer weights."""
    rng = np.random.default_rng(seed)
    widths = (22, 12, 31, 7, 22, 300, 300, 20, 20)
    codes = np.stack([rng.integers(0, w, R) for w in widths], 1)
    codes = np.where(rng.random(codes.shape) < 0.05, 300, codes)
    lc = rng.integers(0, n_lv, R).astype(np.int32)
    vv = rng.normal(size=(R, 3)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 4, R)
    return (torch.from_numpy(codes.astype(np.int16)).to(dev),
            torch.from_numpy(lc).to(dev), torch.from_numpy(vv).to(dev))


def _exact_count(codes, lc, w, groups, n_lv, na_code):
    """Each cell's int64 sum of integer weights, in the grouped output's
    packed order (NA remapped to each group's last slot)."""
    keys, n = [], 0
    for idxs, Bg, _mode in groups:
        c = codes[:, list(idxs)].long()
        c = torch.where(c == na_code, Bg - 1, c)
        slot = torch.arange(len(idxs), device=c.device)[None, :]
        keys.append(n + (slot * n_lv + lc[:, None].long()) * Bg + c)
        n += len(idxs) * n_lv * Bg
    keys = torch.cat(keys, 1).reshape(-1)
    return torch.zeros(n, dtype=torch.int64, device=codes.device).index_add_(
        0, keys, w.long()[:, None].expand(-1, codes.shape[1]).reshape(-1))


_AIRLINES_GROUPS = (((0, 2, 4, 7, 8), 32, "onehot"), ((1,), 16, "onehot"),
                    ((3,), 8, "segsum"), ((5, 6), 301, "onehot"))


@pytest.mark.parametrize("n_lv,R", [(16, 300_007), (32, 100_003)])
def test_clustered_grouped_kernel_matches_plain_and_the_exact_count(dev, n_lv,
                                                                     R):
    """The airlines plan at n_lv = 16 is one cluster of two CTAs (each row
    block multicast to both); at n_lv = 32 one cluster of five. Against the
    plain version (integer channel equal, real channels within 1e-4 of the
    cell mass), bit-identical over two launches, and the weight channel
    equal to the exact int64 count; R is ragged against the staged block."""
    from h2o_tpu_torch.backend.kernels import hist as h

    codes, lc, vv = _airlines_level(R, n_lv, dev)
    feats = tuple((f, Bg, 0) for idxs, Bg, _m in _AIRLINES_GROUPS
                  for f in idxs)
    _rb, ring = h._ring_plan(9, 2, 3, 301 * 3)
    cluster = h._tile_plan(feats, n_lv, 3, ring)[3]
    assert cluster == {16: 2, 32: 5}[n_lv]
    k1 = h._cuda_grouped(codes, lc, vv, _AIRLINES_GROUPS, n_lv, 300)
    k2 = h._cuda_grouped(codes, lc, vv, _AIRLINES_GROUPS, n_lv, 300)
    xgs = [codes[:, list(idxs)] for idxs, _Bg, _m in _AIRLINES_GROUPS]
    plain = h._torch_grouped(xgs, lc, vv, _AIRLINES_GROUPS, n_lv, 300, 1024)
    mass = h._torch_grouped(xgs, lc, vv.abs(), _AIRLINES_GROUPS, n_lv, 300,
                            1024)
    exact = _exact_count(codes, lc, vv[:, 0], _AIRLINES_GROUPS, n_lv, 300)
    torch.cuda.synchronize()
    w = torch.cat([a[..., 0].reshape(-1) for a in k1])
    assert torch.equal(w, exact.float())
    for a, b, p, m in zip(k1, k2, plain, mass):
        assert torch.equal(a, b)
        assert torch.equal(a[..., 0], p[..., 0])
        assert bool(((a - p).abs() <= REAL_TOL * m).all())


def test_plan_of_two_clusters_matches_the_exact_count(dev):
    """Sixteen 1025-bin features at n_lv = 16 need more tiles than one
    cluster of eight: every cluster makes its own pass over the rows, and
    the weight channel still equals the exact int64 count, bit for bit,
    with the real channels within 1e-4 of the plain version's cell mass."""
    rng = np.random.default_rng(4)
    R, F, B, n_lv = 60_001, 16, 1025, 16
    codes = torch.from_numpy(rng.integers(0, B, (R, F)).astype(np.int16)
                             ).to(dev)
    lc = torch.from_numpy(rng.integers(0, n_lv, R).astype(np.int32)).to(dev)
    vv = rng.normal(size=(R, 3)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 4, R)
    vv = torch.from_numpy(vv).to(dev)
    feats = tuple((f, B, f * n_lv * B * 3) for f in range(F))
    _rb, ring = hist._ring_plan(F, 2, 3, B * 3)
    _i, starts, _c, cluster = hist._tile_plan(feats, n_lv, 3, ring)
    assert (len(starts) - 1) // cluster > 1
    groups = ((tuple(range(F)), B, "onehot"),)
    k1 = hist._cuda_flat(codes, lc, vv, n_lv, B)
    k2 = hist._cuda_flat(codes, lc, vv, n_lv, B)
    plain = hist._torch_flat(codes, lc, vv, n_lv, B, 1024)
    mass = hist._torch_flat(codes, lc, vv.abs(), n_lv, B, 1024)
    exact = _exact_count(codes, lc, vv[:, 0], groups, n_lv, B - 1)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    assert torch.equal(k1[..., 0].reshape(-1), exact.float())
    assert bool(((k1 - plain).abs() <= REAL_TOL * mass).all())


_COVTYPE_GROUPS = ((tuple(range(10)), 21, "onehot"),
                   (tuple(range(10, 54)), 4, "segsum"))


def test_grouped_kernel_at_covtype_depth_12_matches_plain_and_exact(dev):
    """DRF's deepest level (depth 12: n_lv = 2,048) at covertype's plan,
    int8 codes of 10 continuous and 44 one-hot columns, 5% NA: 168 CTAs in
    21 clusters of 8, each a pass over the rows. The weight channel equals
    the exact int64 count and the plain version, the real channels lie
    within 1e-4 of the plain version's cell mass, and two launches are
    bit-identical."""
    rng = np.random.default_rng(12)
    R, n_lv = 200_003, 2048
    codes = np.concatenate([rng.integers(0, 20, (R, 10)),
                            rng.integers(0, 2, (R, 44))], axis=1)
    codes = np.where(rng.random(codes.shape) < 0.05, 20, codes)
    codes = torch.from_numpy(codes.astype(np.int8)).to(dev)
    lc = torch.from_numpy(rng.integers(0, n_lv, R).astype(np.int32)).to(dev)
    vv = rng.normal(size=(R, 3)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 2, R)
    vv = torch.from_numpy(vv).to(dev)
    shape = hist.launch_shape(codes, lc, vv, n_lv, 21, _COVTYPE_GROUPS)
    assert shape["clusters"] > 1
    k1 = hist._cuda_grouped(codes, lc, vv, _COVTYPE_GROUPS, n_lv, 20)
    k2 = hist._cuda_grouped(codes, lc, vv, _COVTYPE_GROUPS, n_lv, 20)
    xgs = [codes[:, list(idxs)] for idxs, _Bg, _m in _COVTYPE_GROUPS]
    plain = hist._torch_grouped(xgs, lc, vv, _COVTYPE_GROUPS, n_lv, 20)
    mass = hist._torch_grouped(xgs, lc, vv.abs(), _COVTYPE_GROUPS, n_lv, 20)
    exact = _exact_count(codes, lc, vv[:, 0], _COVTYPE_GROUPS, n_lv, 20)
    torch.cuda.synchronize()
    w = torch.cat([a[..., 0].reshape(-1) for a in k1])
    assert torch.equal(w, exact.float())
    for a, b, p, m in zip(k1, k2, plain, mass):
        assert torch.equal(a, b)
        assert torch.equal(a[..., 0], p[..., 0])
        assert bool(((a - p).abs() <= REAL_TOL * m).all())


@pytest.mark.parametrize("F,B,n_lv,staged", [(2_000, 4, 2, False),
                                              (2, 8_000, 1, True),
                                              (1, 9_621, 1, False)])
def test_kernel_takes_wide_rows_and_wide_features(dev, F, B, n_lv, staged):
    """Rows of 2,000 int16 codes (too wide for the staging ring: every row
    is read from device memory, 32 tiles in 4 clusters), a feature of 8,000
    bins (a ring of fewer rows beside its 192 KB node) and one of 9,621
    (the widest node shared memory holds, no ring): against the plain
    version and the exact int64 count, bit-identical over two launches."""
    rng = np.random.default_rng(5)
    R = 5_003
    codes = torch.from_numpy(rng.integers(0, B, (R, F)).astype(np.int16)
                             ).to(dev)
    lc = torch.from_numpy(rng.integers(0, n_lv, R).astype(np.int32)).to(dev)
    vv = rng.normal(size=(R, 3)).astype(np.float32)
    vv[:, 0] = rng.integers(0, 4, R)
    vv = torch.from_numpy(vv).to(dev)
    assert (hist.launch_shape(codes, lc, vv, n_lv, B)["rows_per_block"] > 0
            ) == staged
    k1 = hist._cuda_flat(codes, lc, vv, n_lv, B)
    k2 = hist._cuda_flat(codes, lc, vv, n_lv, B)
    plain = hist._torch_flat(codes, lc, vv, n_lv, B, 1024)
    mass = hist._torch_flat(codes, lc, vv.abs(), n_lv, B, 1024)
    groups = ((tuple(range(F)), B, "onehot"),)
    exact = _exact_count(codes, lc, vv[:, 0], groups, n_lv, B - 1)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    assert torch.equal(k1[..., 0].reshape(-1), exact.float())
    assert bool(((k1 - plain).abs() <= REAL_TOL * mass).all())


@pytest.mark.parametrize("n_lv", [1, 2, 4])
def test_skewed_cells_at_early_levels_match_the_exact_count(dev, n_lv):
    """Codes skewed so that most lanes of a warp add into one cell of the
    narrow features (7 to 32 bins) at early levels, where those adds
    collide most: the weight channel equals the exact int64 count and the
    real channels (scaled up, so the low words carry into the high ones)
    the plain version within 1e-4 of the cell mass."""
    codes, lc, vv = _airlines_level(200_003, n_lv, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    codes[torch.rand(codes.shape, generator=g, device=dev) < 0.7] = 0
    vv[:, 1:] *= 1e6
    k1 = hist._cuda_grouped(codes, lc, vv, _AIRLINES_GROUPS, n_lv, 300)
    k2 = hist._cuda_grouped(codes, lc, vv, _AIRLINES_GROUPS, n_lv, 300)
    xgs = [codes[:, list(idxs)] for idxs, _Bg, _m in _AIRLINES_GROUPS]
    plain = hist._torch_grouped(xgs, lc, vv, _AIRLINES_GROUPS, n_lv, 300,
                                1024)
    mass = hist._torch_grouped(xgs, lc, vv.abs(), _AIRLINES_GROUPS, n_lv, 300,
                               1024)
    exact = _exact_count(codes, lc, vv[:, 0], _AIRLINES_GROUPS, n_lv, 300)
    torch.cuda.synchronize()
    w = torch.cat([a[..., 0].reshape(-1) for a in k1])
    assert torch.equal(w, exact.float())
    for a, b, p, m in zip(k1, k2, plain, mass):
        assert torch.equal(a, b)
        assert bool(((a - p).abs() <= REAL_TOL * m).all())


def test_inputs_off_16_bytes_match_aligned_copies(dev):
    """Views one row in (18 bytes off 16) cannot be bulk-copied: the kernel
    reads their rows from device memory, with the same bits as the
    staged launch on aligned copies of the same rows."""
    codes, lc, vv = _airlines_level(100_001, 4, dev)
    views = (codes[1:], lc[1:], vv[1:])
    copies = tuple(t.clone() for t in views)
    assert hist.launch_shape(*views, 4, 301, _AIRLINES_GROUPS)[
        "rows_per_block"] == 0
    assert hist.launch_shape(*copies, 4, 301, _AIRLINES_GROUPS)[
        "rows_per_block"] > 0
    a = hist._cuda_grouped(*views, _AIRLINES_GROUPS, 4, 300)
    b = hist._cuda_grouped(*copies, _AIRLINES_GROUPS, 4, 300)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_one_group_call_is_the_grouped_kernel(dev):
    Xb, lc, vv = _grouped_inputs(20_000, [299, 299], 4, torch.int16, dev, 300)
    before = hist.GROUPED_LAUNCHES
    one = hist.level_hist_one_group(Xb, lc, vv, Bg=301, mode="onehot",
                                    n_lv=4, nbins_tot=301, block=1024)
    both = hist._cuda_grouped(Xb, lc, vv, (((0, 1), 301, "onehot"),), 4, 300)
    torch.cuda.synchronize()
    assert hist.GROUPED_LAUNCHES == before + 2
    assert torch.equal(one, both[0])


GRAM_TOL = 1e-5


def _gram_inputs(R, P, dev, seed=2, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        X = rng.integers(-3, 4, (R, P)).astype(np.float32)
        W = rng.integers(0, 3, R).astype(np.float32)
        z = rng.integers(-2, 3, R).astype(np.float32)
    else:
        X = rng.normal(size=(R, P)).astype(np.float32)
        W = rng.random(R).astype(np.float32)
        z = rng.normal(size=R).astype(np.float32)
    return (torch.from_numpy(X).to(dev), torch.from_numpy(W).to(dev),
            torch.from_numpy(z).to(dev))


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("R,P", [(1000, 1), (70_001, 29), (5_003, 31),
                                 (6_007, 32), (4_099, 33), (20_011, 130),
                                 (9_999, 690)])
def test_gram_kernel_matches_plain(dev, R, P, with_z):
    """Ragged R against the kernel's chunk and staging sizes, both forms
    (one 32-wide tile when P + 1 <= 32, else the triangle of 128-wide
    tiles, whose rows are staged in 16-, 8- or 4-byte pieces as P allows),
    with and without z; two launches are bit-identical and G is exactly
    symmetric."""
    X, W, z = _gram_inputs(R, P, dev)
    z = z if with_z else None
    before = gram.GRAM_LAUNCHES
    G1, b1 = gram.gram_accumulate(X, W, z)
    G2, b2 = gram.gram_accumulate(X, W, z)
    assert gram.GRAM_LAUNCHES == before + 2
    Gp, bp = gram._torch_gram(X, W, z, R)      # one block: R * P <= 2^25
    Gm, bm = gram._torch_gram(X.abs(), W.abs(), None if z is None
                              else z.abs(), R)
    torch.cuda.synchronize()
    assert G1.shape == (P, P) and torch.equal(G1, G2)
    assert torch.equal(G1, G1.T)
    assert bool(((G1 - Gp).abs() <= GRAM_TOL * Gm).all())
    if with_z:
        assert b1.shape == (P,) and torch.equal(b1, b2)
        assert bool(((b1 - bp).abs() <= GRAM_TOL * bm).all())
    else:
        assert b1 is None


def test_gram_kernel_is_exact_on_integer_values(dev):
    X, W, z = _gram_inputs(50_000, 33, dev, integer=True)
    G, b = gram._cuda_gram(X, W, z)
    Gp, bp = gram._torch_gram(X, W, z, 50_000)
    torch.cuda.synchronize()
    assert torch.equal(G, Gp) and torch.equal(b, bp)


@pytest.mark.parametrize("R,P", [(70_001, 29), (20_011, 130)])
def test_gram_kernel_computes_in_float32_not_tf32(dev, R, P):
    """On operands that TF32 cannot hold (``chip_smoke.gram_tf32_probe``),
    both tile widths stay within 1e-5 of the float64 Gram, while the same
    product over TF32-truncated operands is off by more than 1e-4: a
    kernel that fed the tensor cores TF32 would fail here."""
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(5)
    f32_rel, tf32_rel = cs.gram_tf32_probe(dev, R, P, g)
    assert f32_rel <= GRAM_TOL
    assert tf32_rel >= 10 * GRAM_TOL


def test_gram_wrapper_refuses_what_the_kernel_does_not_take(dev):
    X, W, z = _gram_inputs(1024, 5, dev)
    with pytest.raises(TypeError):
        gram._cuda_gram(X.double(), W, z)
    with pytest.raises(TypeError):
        gram._cuda_gram(X, W.half(), z)
    with pytest.raises(ValueError):
        gram._cuda_gram(X, W.cpu(), z)
    with pytest.raises(ValueError):
        gram._cuda_gram(X, W, z.cpu())
    with pytest.raises(ValueError):
        gram._cuda_gram(X.T.contiguous().T, W, z)
    with pytest.raises(ValueError):
        gram._cuda_gram(X, W[:-1].contiguous(), z)


def test_small_glm_on_the_card_matches_the_cpu(dev):
    """The binomial lambda-search fit of ``chip_smoke.py``'s
    ``glm_card_vs_cpu`` at 20k rows: coefficients within 1e-4 x max(1,
    |beta|), residual deviance within a relative 1e-5, predictions within
    1e-4; every Gram pass on the card (iterations + the lambda_max pass)
    goes through the kernel."""
    import chip_smoke as cs

    fits = {}
    for d in (dev, "cpu"):
        fr = cs._higgs_frame(20_000, d)
        before = gram.GRAM_LAUNCHES
        m = cs._glm(fr, lambda_search=True)
        fits[d] = (m, gram.GRAM_LAUNCHES - before,
                   m.predict(fr).vec("ps").to_numpy())
    (a, la, pa), (b, lb, pb) = fits[dev], fits["cpu"]
    it = a.output.scoring_history[-1]["iterations"]
    assert la == it + 1 and lb == 0
    assert np.all(np.abs(a.beta - b.beta)
                  <= 1e-4 * np.maximum(1.0, np.abs(b.beta)))
    ra = a.output.training_metrics.residual_deviance
    rb = b.output.training_metrics.residual_deviance
    assert abs(ra - rb) <= 1e-5 * abs(rb)
    assert float(np.abs(pa - pb).max()) <= 1e-4


def test_small_drf_on_the_card_matches_the_cpu(dev):
    """``drf_card_vs_cpu`` at 20k rows, 2 iterations of the covertype DRF
    (7 classes, depth 12): DRF's channels are integers, so split features,
    NA directions, leaf values and the out-of-bag confusion matrix are
    identical, predictions within 1e-5; every level on the card goes
    through the kernel."""
    import chip_smoke as cs

    fits = {}
    for d in (dev, "cpu"):
        fr = cs._covtype_frame(20_000, d)
        before = hist.LAUNCHES + hist.GROUPED_LAUNCHES
        m = cs._drf(fr, 2)
        fits[d] = (m, hist.LAUNCHES + hist.GROUPED_LAUNCHES - before,
                   cs._class_probs(m, fr).cpu().numpy())
    (a, la, pa), (b, lb, pb) = fits[dev], fits["cpu"]
    assert la == 2 * 7 * 12 and lb == 0
    for k in ("feat", "nanL", "val"):
        assert torch.equal(a.forest[k].cpu(), b.forest[k])
    ma, mb = a.output.training_metrics, b.output.training_metrics
    assert ma.description == "Reported on OOB data"
    assert np.array_equal(ma.confusion_matrix, mb.confusion_matrix)
    assert float(np.abs(pa - pb).max()) <= 1e-5


@pytest.mark.parametrize("option", ["poisson", "gamma", "tweedie", "laplace",
                                    "quantile", "huber", "constrained",
                                    "exact", "early_stopped"])
def test_gbm_option_on_the_card_matches_the_cpu(dev, option):
    """``gbm_options_card_vs_cpu`` at 20k rows: equal split features, NA
    directions and tree counts, leaf values and predictions within 1e-5,
    the same variable-importance order; every level on the card goes
    through a histogram kernel."""
    import chip_smoke as cs

    fits = {}
    for d in (dev, "cpu"):
        fr = cs._higgs_option_frame(20_000, d)
        before = hist.LAUNCHES + hist.GROUPED_LAUNCHES
        m = cs._option_model(fr, option)
        fits[d] = (m, hist.LAUNCHES + hist.GROUPED_LAUNCHES - before,
                   m.predict(fr).vec(0).to_numpy())
    (a, la, pa), (b, lb, pb) = fits[dev], fits["cpu"]
    assert la == a.ntrees * a.cfg.max_depth and lb == 0
    assert a.ntrees == b.ntrees
    for k in ("feat", "nanL"):
        assert torch.equal(a.forest[k].cpu(), b.forest[k])
    assert float((a.forest["val"].cpu() - b.forest["val"]).abs().max()) <= 1e-5
    assert float(np.abs(pa - pb).max()) <= 1e-5
    assert (a.output.variable_importances["variable"]
            == b.output.variable_importances["variable"])


def test_small_xgboost_on_the_card_matches_the_cpu(dev):
    """``xgboost_card_vs_cpu`` at 20k rows: DART drops the same trees and
    grows equal forests (leaves within 1e-5); gblinear's coefficients within
    1e-4 x max(1, |beta|), one Gram launch per iteration on the card."""
    import chip_smoke as cs

    darts, lins = {}, {}
    for d in (dev, "cpu"):
        fr = cs._higgs_frame(20_000, d)
        # min_rows 10 keeps depth-6 nodes from ties between candidates
        # that split the same few rows (sums rounded apart by an ulp)
        darts[d] = cs._xgboost(fr, booster="dart", rate_drop=0.3, ntrees=5,
                               min_rows=10.0)
        before = gram.GRAM_LAUNCHES
        lins[d] = (cs._xgboost(fr, booster="gblinear"),
                   gram.GRAM_LAUNCHES - before)
    a, b = darts[dev], darts["cpu"]
    assert a.dropped_trees == b.dropped_trees
    for k in ("feat", "nanL"):
        assert torch.equal(a.forest[k].cpu(), b.forest[k])
    assert float((a.forest["val"].cpu() - b.forest["val"]).abs().max()) <= 1e-5
    (la, na), (lb, nb) = lins[dev], lins["cpu"]
    assert na == la.output.scoring_history[-1]["iterations"] and nb == 0
    assert np.all(np.abs(la.beta - lb.beta)
                  <= 1e-4 * np.maximum(1.0, np.abs(lb.beta)))


def test_import_and_cv_on_the_card_match_the_cpu(dev, tmp_path):
    """The front door at 20k rows: the airlines CSV parsed on both devices
    gives the same frame; ``take`` of the same rows, then a GBM with 3-fold
    CV and calibration: the same folds, equal fold and main forests (leaves
    within 1e-5), holdout predictions, CV metrics and Platt (a, b) within
    1e-5, and grouped launches = trees x depth on the card."""
    import chip_smoke as cs

    path = str(tmp_path / "airlines.csv")
    cs._write_airlines_csv(path, 20_000)
    idx = np.random.default_rng(0).permutation(20_000)
    models, launches, frames = {}, {}, {}
    for d in (dev, "cpu"):
        fr = frames[d] = cs._import_airlines(path, d)
        before = hist.GROUPED_LAUNCHES
        models[d] = cs._cv_gbm(fr.take(idx[:15_000]), fr.take(idx[15_000:]),
                               fr.take(idx[:5_000]), ntrees=3, max_depth=4,
                               nfolds=3, min_rows=10.0)
        launches[d] = hist.GROUPED_LAUNCHES - before
    a, b = models[dev], models["cpu"]
    trees = sum(m.ntrees for m in b.output.cv_models) + b.ntrees
    assert launches == {dev: trees * 4, "cpu": 0}
    for name in frames["cpu"].names:
        va, vb = frames[dev].vec(name), frames["cpu"].vec(name)
        assert va.type == vb.type and va.domain == vb.domain
        assert np.array_equal(va.data.cpu().numpy(), vb.data.numpy(),
                              equal_nan=True)
    assert np.array_equal(a.output.cv_fold_assignment.vec(0).to_numpy(),
                          b.output.cv_fold_assignment.vec(0).to_numpy())
    for ma, mb in zip(a.output.cv_models + [a], b.output.cv_models + [b]):
        for k in ("feat", "nanL", "catd"):
            assert torch.equal(ma.forest[k].cpu(), mb.forest[k])
        assert float((ma.forest["val"].cpu()
                      - mb.forest["val"]).abs().max()) <= 1e-5
        assert np.abs(np.subtract(ma.calib, mb.calib)).max() <= 1e-5
    ha = a.output.cv_holdout_predictions.vec("pYES").to_numpy()
    hb = b.output.cv_holdout_predictions.vec("pYES").to_numpy()
    assert float(np.abs(ha - hb).max()) <= 1e-5
    for k in ("auc", "logloss", "mse"):
        assert abs(getattr(a.output.cross_validation_metrics, k)
                   - getattr(b.output.cross_validation_metrics, k)) <= 1e-5
    assert trees == 12


def test_multinomial_auc_types_on_the_card_match_the_cpu(dev):
    """Each ``auc_type`` on the card within 1e-6 of the CPU's (float64
    sums; ties and weights included)."""
    from h2o_tpu_torch.models import metrics

    rng = np.random.default_rng(9)
    n, K = 50_000, 5
    y = rng.integers(0, K, n).astype(np.float32)
    p = np.round(rng.dirichlet(np.ones(K), n), 2).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    for t in ("MACRO_OVR", "WEIGHTED_OVR", "MACRO_OVO", "WEIGHTED_OVO"):
        out = {d: metrics.make_multinomial_metrics(
            torch.from_numpy(y).to(d), torch.from_numpy(p).to(d),
            torch.from_numpy(w).to(d), auc_type=t) for d in (dev, "cpu")}
        assert abs(out[dev].auc - out["cpu"].auc) <= 1e-6
        assert abs(out[dev].pr_auc - out["cpu"].pr_auc) <= 1e-6


# ---------------------------------------------------------------------------
# chunk codecs, model files and kill-and-resume on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["const", "int8", "cat8", "int16", "cat16",
                                  "sparse0"])
def test_decode_on_the_card_matches_the_cpu(dev, kind):
    from h2o_tpu_torch.frame import chunks

    rng = np.random.default_rng(4)
    n = 5000
    col = {"const": np.full(n, -1.25),
           "int8": rng.integers(0, 200, n) * 0.5 - 3,
           "cat8": rng.integers(0, 7, n),
           "int16": rng.integers(0, 40_000, n) * 0.25,
           "cat16": rng.integers(0, 3000, n),
           "sparse0": np.where(rng.random(n) < 0.02, rng.normal(size=n),
                               0.0)}[kind].astype(np.float32)
    if kind != "const":
        col[::53] = np.nan
    host = np.full(5120, np.nan, np.float32)
    host[:n] = col
    codes, meta = chunks.encode_column(host, n, is_cat=kind.startswith("cat"))
    assert meta.kind == kind
    cpu = chunks.decode_chunk(chunks._to_device(codes, "cpu"), meta)
    card = chunks.decode_chunk(chunks._to_device(codes, dev), meta)
    assert card.cpu().numpy().tobytes() == cpu.numpy().tobytes()


def _small_binomial(dev_name, n=2000, seed=3):
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.frame.vec import T_CAT, Vec

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    fr = Frame.from_dict({f"x{j}": x[:, j] for j in range(3)},
                         device=dev_name)
    fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["0", "1"],
                               device=dev_name))
    return fr


@pytest.mark.parametrize("saved_on", ["cuda", "cpu"])
def test_model_saved_on_one_device_loads_on_the_other(dev, tmp_path,
                                                      saved_on):
    from h2o_tpu_torch import GBM, GBMParameters, load_model

    other = "cpu" if saved_on == "cuda" else "cuda"
    m = GBM(GBMParameters(training_frame=_small_binomial(saved_on),
                          response_column="y", ntrees=5, max_depth=4,
                          seed=1)).train_model()
    m2 = load_model(m.save(str(tmp_path / "m.bin")), device=other)
    assert m2.forest["val"].device.type == other
    for k in m.forest:
        assert torch.equal(m2.forest[k].cpu(), m.forest[k].cpu()), k
    p_saved = m.predict(_small_binomial(saved_on)).vec(2).data.cpu()
    p_loaded = m2.predict(_small_binomial(other)).vec(2).data.cpu()
    torch.testing.assert_close(p_loaded, p_saved, rtol=0, atol=1e-6)


def test_kill_and_resume_on_the_card_is_bit_equal(dev, tmp_path,
                                                  monkeypatch):
    from h2o_tpu_torch import GBM, GBMParameters, resume_training
    from h2o_tpu_torch.utils import failpoints as fp

    monkeypatch.setenv("H2O_TORCH_CHECKPOINT_SECS", "0")

    def params(**kw):
        return GBMParameters(training_frame=_small_binomial("cuda"),
                             response_column="y", ntrees=6, max_depth=4,
                             score_tree_interval=2, seed=5, **kw)

    base = GBM(params()).train_model()
    for k in (1, 2, 3):
        rdir = str(tmp_path / f"k{k}")
        fp.reset()
        fp.arm("train.gbm.chunk", f"raise(preempt)@{k}")
        with pytest.raises(fp.InjectedPreemption):
            GBM(params(auto_recovery_dir=rdir)).train_model()
        fp.reset()
        m = resume_training(rdir)
        assert m.forest["val"].device.type == "cuda"
        for key in base.forest:
            assert torch.equal(m.forest[key], base.forest[key]), (k, key)


def test_background_job_trains_on_the_card(dev):
    """A background job makes the frame's card its worker thread's current
    device; its forest equals the inline build's."""
    from h2o_tpu_torch import GBM, GBMParameters

    def params():
        return GBMParameters(training_frame=_small_binomial("cuda"),
                             response_column="y", ntrees=4, max_depth=4,
                             seed=2)

    job = GBM(params()).train()
    m = job.join(timeout=300)
    assert job.status == "DONE" and m.forest["val"].device.type == "cuda"
    ref = GBM(params()).train_model()
    for k in ref.forest:
        assert torch.equal(m.forest[k], ref.forest[k]), k


# ---------------------------------------------------------------------------
# the unsupervised and neural slice
# ---------------------------------------------------------------------------
def _digits(n, dev, seed=784):
    """An MNIST-like frame: 300 pixel columns in 0..255 (a fifth nonzero,
    on class-dependent pixels, 20 always 0) and a 10-level ``label``."""
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.frame.vec import T_CAT, Vec

    rng = np.random.default_rng(seed)
    prob = rng.random((10, 300)) ** 3
    prob = np.clip(0.02 + 0.18 / prob.mean() * prob, 0, 0.95)
    prob[:, :20] = 0.0
    y = rng.integers(0, 10, n)
    u = rng.random((n, 300))
    pix = np.where(u < prob[y], 1 + np.floor(254 * rng.random((n, 300))), 0)
    fr = Frame.from_dict({f"C{j + 1}": pix[:, j].astype(np.float32)
                          for j in range(300)}, device=dev)
    fr.add("label", Vec.from_numpy(y.astype(np.float32), type=T_CAT,
                                   domain=[str(i) for i in range(10)],
                                   device=dev))
    return fr


def test_gram_kernel_at_the_pca_mnist_design(dev):
    """z = None with a 0/1 row mask at MNIST's 60,000 x 717 (a row of 2,868
    bytes, not a multiple of 16): two launches bit-identical, every entry
    within 1e-5 of its mass from ``_plain_gram``."""
    g = torch.Generator(device=dev).manual_seed(717)
    X = torch.randn((60_000, 717), generator=g, device=dev)
    W = (torch.rand((60_000,), generator=g, device=dev) < 0.9).float()
    G1, b1 = gram.gram_accumulate(X, W)
    G2, _ = gram.gram_accumulate(X, W)
    Gp, _ = gram._plain_gram(X, W, None)
    Gm, _ = gram._plain_gram(X.abs(), W, None)
    torch.cuda.synchronize()
    assert b1 is None and torch.equal(G1, G2) and torch.equal(G1, G1.T)
    assert bool(((G1 - Gp).abs() <= GRAM_TOL * Gm).all())


def test_deeplearning_is_bit_equal_twice_on_the_card(dev):
    from h2o_tpu_torch import DeepLearning, DeepLearningParameters

    fr = _digits(3000, "cuda")

    def train():
        return DeepLearning(DeepLearningParameters(
            training_frame=fr, response_column="label", hidden=[64, 64],
            epochs=2, seed=42)).train_model()

    a, b = train(), train()
    assert a.net[0]["W"].device.type == "cuda"
    for la, lb in zip(a.net, b.net):
        assert torch.equal(la["W"], lb["W"]) and torch.equal(la["b"], lb["b"])
    for slot in ("e_g", "e_x"):
        for la, lb in zip(a.opt_state[slot], b.opt_state[slot]):
            assert torch.equal(la["W"], lb["W"])
    assert a.output.training_metrics.logloss < np.log(10)


def test_kmeans_and_pca_on_the_card_match_the_cpu(dev):
    from h2o_tpu_torch import KMeans, KMeansParameters, PCA, PCAParameters

    frs = {d: _digits(2000, d) for d in ("cuda", "cpu")}
    km = {d: KMeans(KMeansParameters(training_frame=f, k=10, seed=42,
                                     ignored_columns=["label"])).train_model()
          for d, f in frs.items()}
    a = km["cuda"].predict(frs["cuda"]).vec(0).data[:2000].cpu()
    b = km["cpu"].predict(frs["cpu"]).vec(0).data[:2000]
    assert float((a == b).float().mean()) >= 0.999
    tw = [km[d].output.training_metrics.tot_withinss for d in ("cuda", "cpu")]
    assert tw[0] == pytest.approx(tw[1], rel=1e-5)
    pca = {d: PCA(PCAParameters(training_frame=f, k=8,
                                transform="STANDARDIZE",
                                ignored_columns=["label"])).train_model()
           for d, f in frs.items()}
    s_card = pca["cuda"].output.variable_importances["std_deviation"]
    s_cpu = pca["cpu"].output.variable_importances["std_deviation"]
    np.testing.assert_allclose(s_card, s_cpu, rtol=1e-5)
    Vc, Vh = pca["cuda"].V.cpu().numpy(), pca["cpu"].V.numpy()
    ev = s_cpu ** 2
    gaps = np.minimum(np.r_[np.inf, -np.diff(ev)], np.r_[-np.diff(ev), ev[-1]])
    cos = np.abs((Vc * Vh).sum(0)) / np.linalg.norm(Vc, axis=0) \
        / np.linalg.norm(Vh, axis=0)
    sep = gaps / ev > 1e-3
    assert sep.any() and cos[sep].min() >= 1 - 1e-5


def test_split_search_and_gradients_round_alike_on_card_and_cpu(dev):
    """The split search on one histogram, and each distribution's gradient
    and hessian and the softmax, bit-equal on the card and the CPU: their
    sums are elementwise adds in a fixed order or float64 sums rounded
    once, their exp and log float64 rounded once (a float32 reduction or
    exp differs between the devices in the last bit, enough to tip a
    near-tied split)."""
    from h2o_tpu_torch.models import distributions as tdist
    from h2o_tpu_torch.models.gbm import _softmax
    from h2o_tpu_torch.models.tree import engine

    rng = np.random.default_rng(9)
    hist = rng.normal(size=(28, 64, 21, 3)).astype(np.float32)
    hist[..., 0] = rng.integers(0, 50, (28, 64, 21))
    hist[..., 2] = np.abs(hist[..., 2])
    edge_ok = np.ones((28, 19), bool)
    colmask = rng.random((28, 64)) < 0.8
    cfg = engine.TreeConfig(nbins=20, min_rows=10.0, reg_lambda=1.0)
    out = [engine._find_splits(*(torch.from_numpy(a).to(d) for a in (
        hist, colmask, edge_ok)), cfg) for d in (dev, "cpu")]
    for a, b in zip(out[0][:7], out[1][:7]):
        assert torch.equal(a.cpu(), b)
    f = torch.from_numpy(rng.normal(0, 3, 100_000).astype(np.float32))
    y = torch.from_numpy(rng.gamma(2.0, 1.0, 100_000).astype(np.float32))
    w = torch.ones_like(f)
    for name in ("bernoulli", "poisson", "gamma", "tweedie"):
        dist = tdist.get_distribution(name)
        for fn in ("gradient", "hessian"):
            card = getattr(dist, fn)(y.to(dev), f.to(dev), w.to(dev))
            assert torch.equal(card.cpu(), getattr(dist, fn)(y, f, w)), \
                (name, fn)
    k = f.reshape(-1, 4)
    assert torch.equal(_softmax(k.to(dev), 1).cpu(), _softmax(k, 1))


# ---------------------------------------------------------------------------
# model search
# ---------------------------------------------------------------------------
def test_tiny_automl_plan_on_the_card_matches_the_cpu(dev):
    """``automl.small_plan()`` (GLM with lambda search, a depth-3 GBM, a
    DRF, a 1-epoch DeepLearning, a 2-model GBM grid and both ensembles)
    on 300 rows with 2 folds, card against CPU: the same
    steps and models, every leaderboard metric within 1e-4, the
    metalearners' coefficients within 1e-4 x max(1, |beta|), the leader's
    predictions within 1e-4; the flat kernel and the Gram ran."""
    from h2o_tpu_torch import H2OAutoML
    from h2o_tpu_torch.models import automl

    runs = {}
    for d in ("cuda", "cpu"):
        hist.LAUNCHES = gram.GRAM_LAUNCHES = 0
        fr = _small_binomial(d, n=300)
        aml = H2OAutoML(max_models=6, nfolds=2, seed=42,
                        modeling_plan=automl.small_plan())
        aml.train(y="y", training_frame=fr)
        runs[d] = (aml, fr, hist.LAUNCHES, gram.GRAM_LAUNCHES)
    (ca, cfr, flat, grams), (ha, hfr, _f, _g) = runs["cuda"], runs["cpu"]
    assert flat > 0 and grams > 0

    cs, hs = automl.models_by_step(ca), automl.models_by_step(ha)
    assert [lb for lb, _ in cs] == [lb for lb, _ in hs] and len(cs) == 8
    for (lb, cm), (_, hm) in zip(cs, hs):
        for name in ("auc", "logloss", "rmse"):
            assert ca.leaderboard._metric(cm, name) == pytest.approx(
                ha.leaderboard._metric(hm, name), abs=1e-4), (lb, name)
        if lb.startswith("StackedEnsemble"):
            hb = hm.metalearner.beta
            assert np.all(np.abs(cm.metalearner.beta - hb)
                          <= 1e-4 * np.maximum(1.0, np.abs(hb)))
    pc = ca.predict(cfr).vec(2).data[:300].cpu()
    ph = ha.predict(hfr).vec(2).data[:300]
    assert float((pc - ph).abs().max()) <= 1e-4


def _cat_frame(device, n=3000, seed=7):
    """A 24-level categorical (the signal in half its levels, so set
    splits), a numeric column with NAs and a binomial response."""
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.frame.vec import T_CAT, Vec

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 24, n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    effect = rng.permutation(24) % 2
    y = (2 * effect[codes.astype(int)] - 1 + 0.5 * x
         + rng.normal(0, 1.5, n) > 0).astype(np.float32)
    x[::53] = np.nan
    fr = Frame(["c", "x"], [
        Vec.from_numpy(codes, type=T_CAT, domain=[f"L{i}" for i in range(24)],
                       device=device),
        Vec.from_numpy(x, device=device)])
    fr.add("y", Vec.from_numpy(y, type=T_CAT, domain=["n", "p"],
                               device=device))
    return fr


@pytest.mark.parametrize("encoding", ["AUTO", "SortByResponse", "Eigen"])
def test_model_surface_on_the_card_matches_the_cpu(dev, encoding):
    """Covers, leaf ids and paths bit-equal; contributions within 1e-5 and
    staged predictions within 1e-6 of the CPU's, on a set-split GBM
    trained under each encoding (its encoded columns bit-equal)."""
    from h2o_tpu_torch import GBM, GBMParameters
    from h2o_tpu_torch.utils import linalg

    out = {}
    for d in ("cuda", "cpu"):
        fr = _cat_frame(d)
        m = GBM(GBMParameters(training_frame=fr, response_column="y",
                              ntrees=6, max_depth=4, seed=3,
                              categorical_encoding=encoding)).train_model()
        state = linalg.build_encoding_state(fr, encoding, skip=["y"],
                                            response="y")
        enc = fr if state is None else linalg.apply_encoding_state(fr,
                                                                   state)
        cols = lambda f: torch.stack([v.data[:f.nrow].cpu()
                                      for v in f.vecs], 1)
        m._ensure_covers()
        out[d] = dict(
            enc=cols(enc), cover=m.forest["cover"].cpu(),
            ids=cols(m.predict_leaf_node_assignment(fr, type="Node_ID")),
            paths=cols(m.predict_leaf_node_assignment(fr)),
            phi=cols(m.predict_contributions(fr)),
            staged=cols(m.staged_predict_proba(fr)))
    a, b = out["cuda"], out["cpu"]
    for k in ("enc", "cover", "ids", "paths"):     # float32, bit for bit
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k
    torch.testing.assert_close(a["phi"], b["phi"], rtol=0, atol=1e-5)
    torch.testing.assert_close(a["staged"], b["staged"], rtol=0, atol=1e-6)


def test_gam_on_the_card_matches_the_cpu(dev):
    """``gam_rulefit_coxph_card_vs_cpu``'s GAM fits at 20k rows: one Gram
    launch per IRLS iteration; iterations within one, predictions within
    1e-4, the cr fit's identified coefficients (each cr block with its mean
    removed) and the second fit's linear coefficients within 1e-4 x max(1,
    |beta|), its smooths within 1e-4 of their absolute mass."""
    import chip_smoke as cs

    for kw in ({}, cs.GAM_BS):
        fits = {}
        for d in (dev, "cpu"):
            fr = cs._higgs_frame(20_000, d)
            before = gram.GRAM_LAUNCHES
            m = cs._gam(fr, **kw)
            fits[d] = (m, gram.GRAM_LAUNCHES - before, fr,
                       m.predict(fr).vec("ps").to_numpy())
        (a, la, fa, pa), (b, lb, fb, pb) = fits[dev], fits["cpu"]
        it = a.output.scoring_history[0]["iterations"]
        assert la == it and lb == 0
        assert abs(it - b.output.scoring_history[0]["iterations"]) <= 1
        assert float(np.abs(pa - pb).max()) <= 1e-4
        lin = np.r_[0:len(a.dinfo.expanded_names), len(a.beta) - 1]
        ia, ib = cs._gam_identified(a), cs._gam_identified(b)
        keep = slice(None) if not kw else lin
        assert np.all(np.abs(ia[keep] - ib[keep])
                      <= 1e-4 * np.maximum(1.0, np.abs(ib[keep])))
        for (x, _), (y, mass) in zip(cs._gam_smooths(a, fa),
                                     cs._gam_smooths(b, fb)):
            assert np.all(np.abs(x - y) <= 1e-4 * np.maximum(1.0, mass))


@pytest.mark.parametrize("budget", ["built", "streamed"])
def test_rulefit_on_the_card_matches_the_cpu(dev, budget):
    """RuleFit (5 depth-3 DRF trees) at 20k rows, on the built design and
    streamed: the same rules, supports and lambda path, coefficients within
    1e-4 x max(1, |beta|); streamed, one Gram launch per block of every
    IRLS step."""
    import chip_smoke as cs
    from h2o_tpu_torch.models import rulefit

    old = rulefit._STREAM_CELL_BUDGET
    if budget == "streamed":
        rulefit._STREAM_CELL_BUDGET = 1
    try:
        fits = {}
        for d in (dev, "cpu"):
            fr = cs._higgs_frame(20_000, d)
            before = gram.GRAM_LAUNCHES
            fits[d] = (cs._rulefit(fr, 5), gram.GRAM_LAUNCHES - before, fr)
    finally:
        rulefit._STREAM_CELL_BUDGET = old
    (a, la, fa), (b, lb, _) = fits[dev], fits["cpu"]
    assert a.stream == b.stream == (budget == "streamed")
    assert [r.conds for r in a.rules] == [r.conds for r in b.rules]
    assert [r.support for r in a.rules] == [r.support for r in b.rules]
    assert abs(a.lambda_used - b.lambda_used) <= 1e-4 * b.lambda_used
    assert np.all(np.abs(a.beta - b.beta)
                  <= 1e-4 * np.maximum(1.0, np.abs(b.beta)))
    if a.stream:
        blocks = -(-fa.vec(0).plen // a.stream_block_rows)
        assert la == a.stream_steps * blocks and lb == 0
        assert (a.stream_steps, a.lambdas_walked) == (b.stream_steps,
                                                      b.lambdas_walked)


def test_coxph_on_the_card_matches_the_cpu(dev):
    """CoxPH (Efron, 4 strata) on 50k rows of ``chip_smoke``'s survival
    frame: bit-equal twice on the card, two Gram launches per Newton pass;
    coefficients within 1e-5 x max(1, |beta|), the log-likelihood within a
    relative 1e-6 and the baseline hazard within a relative 1e-5 of the
    CPU's."""
    import chip_smoke as cs

    fits = {}
    for d in (dev, dev, "cpu"):
        fr = cs._survival_frame(50_000, d)
        before = gram.GRAM_LAUNCHES
        m = cs._coxph(fr)
        fits.setdefault(str(d), []).append((m, gram.GRAM_LAUNCHES - before))
    (a, la), (a2, _) = fits[str(dev)]
    (b, lb), = fits["cpu"]
    names = list(b.coefficients)
    assert [a.coefficients[k] for k in names] == \
        [a2.coefficients[k] for k in names]
    assert la == 2 * a.newton_passes and lb == 0
    ca = np.array([a.coefficients[k] for k in names])
    cb = np.array([b.coefficients[k] for k in names])
    assert np.all(np.abs(ca - cb) <= 1e-5 * np.maximum(1.0, np.abs(cb)))
    la_, lb_ = (m.output.training_metrics.loglik for m in (a, b))
    assert abs(la_ - lb_) <= 1e-6 * abs(lb_)
    for k in b.baseline:
        assert np.array_equal(a.baseline[k][0], b.baseline[k][0])
        np.testing.assert_allclose(a.baseline[k][1], b.baseline[k][1],
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["gbm", "glm", "drf"])
def test_mojo_exported_on_the_card_scores_on_the_host(dev, tmp_path, kind):
    """A model trained on the card (a 20k-row HIGGS GBM or GLM, a 3,000-row
    covertype DRF) exported as a MOJO, scored by the host scorer within
    ``tests/test_mojo.py``'s round trip of the card's ``predict`` (atol
    1e-5, rtol 1e-4; GLM atol 1e-4; the DRF's rows every class tree
    scores 0 aside, held as such), and imported as a ``Generic`` model:
    its frame on the card, bit-equal to the scorer's output cast to
    float32; no kernel launch while exporting or scoring."""
    import chip_smoke as cs

    from h2o_tpu_torch import MojoModel, import_mojo

    if kind == "drf":
        fr = cs._covtype_frame(3_000, dev)
        model = cs._drf(fr, 1)
    else:
        fr = cs._higgs_frame(20_000, dev)
        model = cs._gbm(fr, 5) if kind == "gbm" else cs._glm(fr)
    before = (hist.LAUNCHES, hist.GROUPED_LAUNCHES, gram.GRAM_LAUNCHES)
    path = model.save_mojo(str(tmp_path / "m.zip"))
    got = MojoModel.load(path).predict(fr)
    pred = model.predict(fr)
    want = np.stack([pred.vec(i).to_numpy() for i in range(pred.ncol)],
                    axis=1).astype(np.float64)
    if kind == "drf":
        # a row whose every class tree gives 0: the MOJO scorer's rule
        # (`DrfMojoModel`) gives all zeros, the engine's 1e-9 floor
        # normalised 1/K each, in both packages (ROADMAP Queue 3 item 28)
        zero = (got[:, 1:] == 0).all(axis=1)
        np.testing.assert_allclose(want[zero, 1:], 1 / 7, rtol=1e-6)
        got, want = got[~zero], want[~zero]
    np.testing.assert_allclose(got[:, 1:], want[:, 1:],
                               atol=1e-4 if kind == "glm" else 1e-5,
                               rtol=1e-4)
    scores = MojoModel.load(path).predict(fr).astype(np.float32)
    g = import_mojo(path).predict(fr)
    for j in range(g.ncol):
        v = g.vec(j).data
        assert v.device.type == "cuda"
        assert np.array_equal(v[:fr.nrow].cpu().numpy().view(np.int32),
                              scores[:, j].view(np.int32))
    if kind != "drf":
        model.save_pojo(str(tmp_path / "m.java"))
    assert (hist.LAUNCHES, hist.GROUPED_LAUNCHES,
            gram.GRAM_LAUNCHES) == before


def test_svmlight_imported_on_the_card(dev, tmp_path):
    """An SVMLight file imported on the card and on the CPU: the same
    frame, bit for bit; a GBM on it goes through the flat kernel."""
    import chip_smoke as cs

    from h2o_tpu_torch import GBM, GBMParameters, import_file

    cols, y = cs._higgs_cols(5_000, seed=7)
    X = np.stack([cols[f"f{j}"] for j in range(cs.HIGGS_F)], axis=1)
    cs._write_svmlight_arff(str(tmp_path / "h.svm"),
                            str(tmp_path / "h.arff"), X, y)
    frs = {d: import_file(str(tmp_path / "h.svm"), device=d)
           for d in (dev, "cpu")}
    for name in frs["cpu"].names:
        a = frs[dev].vec(name).data.cpu().numpy()
        b = frs["cpu"].vec(name).data.numpy()
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    before = hist.LAUNCHES
    GBM(GBMParameters(training_frame=frs[dev], response_column="target",
                      distribution="bernoulli", ntrees=2, max_depth=3,
                      seed=42)).train_model()
    assert hist.LAUNCHES == before + 2 * 3


def test_v4_kernel_matches_plain_on_uplift_channels(dev):
    """The kernel at V = 4 on uplift's channels {w_t, w_t y, w_c, w_c y}
    (0/1 values) at n_lv 1 and 64: every channel equal to the plain
    version exactly, two launches bit-identical, one launch counted
    each."""
    import chip_smoke as cs

    from h2o_tpu_torch.frame.chunks import BinnedView
    from h2o_tpu_torch.models.tree.binning import compute_bin_edges

    fr, _ate = cs._criteo_frame(50_000, dev)
    names = [f"f{j}" for j in range(cs.CRITEO_F)]
    edges = compute_bin_edges(fr.as_matrix(names),
                              np.zeros(cs.CRITEO_F, bool), 20, seed=42)
    codes = BinnedView.build([fr.vec(n) for n in names], edges,
                             names=names).matrix
    B = edges.shape[1] + 2
    rl = codes.shape[0]
    t = torch.nan_to_num(fr.vec("treatment").data)
    y = torch.nan_to_num(fr.vec("visit").data)
    for n_lv in (1, 64):
        rng = np.random.default_rng(n_lv)
        s = torch.from_numpy((rng.random(rl) < 0.632).astype(np.float32)
                             ).to(dev)
        vv = torch.stack([s * t, s * t * y, s * (1 - t), s * (1 - t) * y],
                         dim=1).contiguous()
        lc = torch.from_numpy(rng.integers(0, n_lv, rl).astype(np.int32)
                              ).to(dev)
        before = hist.LAUNCHES
        k1 = hist.level_hist_blocks(codes, lc, vv, n_lv=n_lv, nbins_tot=B,
                                    block=8192)
        k2 = hist.level_hist_blocks(codes, lc, vv, n_lv=n_lv, nbins_tot=B,
                                    block=8192)
        assert hist.LAUNCHES == before + 2
        plain = hist._torch_flat(codes, lc, vv, n_lv, B)
        assert torch.equal(k1, k2)
        assert torch.equal(k1, plain)


def test_uplift_tree_on_the_card_matches_the_cpu(dev):
    """Uplift DRF (3 trees, depth 12) on a 30,000-row Criteo-shaped frame
    on the card and on the CPU: split features and thresholds equal, leaf
    rates bit-equal, gains within 1e-6 relative; one V = 4 launch per
    level on the card."""
    import chip_smoke as cs

    models = {}
    for d in (dev, torch.device("cpu")):
        before = hist.LAUNCHES + hist.GROUPED_LAUNCHES
        models[d.type] = cs._uplift(cs._criteo_frame(30_000, d)[0], 3)
        launched = hist.LAUNCHES + hist.GROUPED_LAUNCHES - before
        assert launched == (3 * 12 if d.type == "cuda" else 0)
    a, b = ({k: v.cpu().numpy() for k, v in m.forest.items()}
            for m in (models["cuda"], models["cpu"]))
    for k in ("feat", "thr", "val_t", "val_c"):
        assert np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(a["gain"], b["gain"], rtol=1e-6, atol=1e-7)


def test_isolation_forest_on_the_card_matches_the_cpu(dev):
    """Both isolation forests (10 trees) on 120,000 credit-card-shaped rows
    (the ``randint`` subsample): split flags and counts equal, the classic
    forest's directions and cuts bit-equal, the extended one's within
    1e-6; scores within 1e-6; no kernel launch."""
    import chip_smoke as cs

    before = (hist.LAUNCHES, hist.GROUPED_LAUNCHES, gram.GRAM_LAUNCHES)
    for extended in (False, True):
        out = {}
        for d in (dev, torch.device("cpu")):
            fr, _fraud = cs._creditcard_frame(cs.ISOFOR_CPU_ROWS, d)
            m = cs._isofor(fr, extended, cs.ISOFOR_CPU_TREES)
            out[d.type] = ([a.cpu().numpy() for a in m.forest],
                           m.predict(fr).vec(0).to_numpy())
        (wa, ta, sa, ca), pa = out["cuda"]
        (wb, tb, sb, cb), pb = out["cpu"]
        assert np.array_equal(sa, sb) and np.array_equal(ca, cb)
        if extended:
            np.testing.assert_allclose(wa, wb, rtol=0, atol=1e-6)
            np.testing.assert_allclose(ta, tb, rtol=1e-6, atol=1e-6)
        else:
            assert np.array_equal(wa, wb) and np.array_equal(ta, tb)
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-6)
    assert (hist.LAUNCHES, hist.GROUPED_LAUNCHES,
            gram.GRAM_LAUNCHES) == before


def _rapids_frames(dev, n=200_003, seed=17):
    """The same columns on the card and on the CPU: two keys (one with
    NAs, +-0 and +-inf), a float column with NAs, a categorical."""
    from h2o_tpu_torch import Frame, Vec

    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 50, n).astype(np.float32)
    k[rng.random(n) < 0.03] = np.nan
    k[rng.integers(0, n, 200)] = np.array([0.0, -0.0, np.inf, -np.inf],
                                          np.float32)[rng.integers(0, 4, 200)]
    x = (rng.normal(size=n) * 100 + 700).astype(np.float32)
    x[::37] = np.nan
    c = rng.integers(0, 30, n).astype(np.float32)
    out = []
    for d in (dev, "cpu"):
        fr = Frame.from_dict({"k": k, "x": x}, device=d)
        fr.add("c", Vec.from_numpy(c, type="enum",
                                   domain=[f"L{i}" for i in range(30)],
                                   device=d))
        out.append(fr)
    return out


def test_group_by_on_the_card_is_bit_equal_twice_and_matches_the_cpu(dev):
    """Group-by on the card twice: the same bits (no float atomics: a
    stable sort by group id, then fixed-order segment reductions); and
    the CPU's group-by: keys and counts exactly, min and max exactly,
    sums, means and deviations within 1e-6 relative (float64 sums of the
    same float32 values, in the CPU's and the card's segment orders)."""
    from h2o_tpu_torch.rapids import group_by

    card, cpu = _rapids_frames(dev)
    aggs = [("nrow", None), ("sum", "x", "rm"), ("mean", "x", "rm"),
            ("sd", "x", "rm"), ("min", "x", "rm"), ("max", "x", "all")]
    a = group_by(card, ["c", "k"], aggs)
    b = group_by(card, ["c", "k"], aggs)
    h = group_by(cpu, ["c", "k"], aggs)
    assert a.vec("nrow").device.type == "cuda"
    for name in a.names:
        assert torch.equal(a.vec(name).data.view(torch.int32),
                           b.vec(name).data.view(torch.int32)), name
        got, want = a.vec(name).to_numpy(), h.vec(name).to_numpy()
        if name in ("c", "k", "nrow", "min_x", "max_x"):
            assert np.array_equal(got, want, equal_nan=True), name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9,
                                       err_msg=name)


def test_sort_and_merge_on_the_card_equal_the_cpu(dev):
    """Sort (ties, NAs, +-0, +-inf, descending keys) and the device merge
    (duplicate right keys, NA keys, all_x) on the card: the CPU's rows in
    the CPU's order, bit for bit, and the same twice."""
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.rapids import merge, sort

    card, cpu = _rapids_frames(dev)
    for by, asc in ((["k"], [True]), (["c", "k", "x"], [True, False, True]),
                    (["k", "x"], [False, False])):
        a, b = sort(card, by, asc), sort(cpu, by, asc)
        for name in a.names:
            assert torch.equal(a.vec(name).data.cpu().view(torch.int32),
                               b.vec(name).data.view(torch.int32)), (by, name)
    rng = np.random.default_rng(4)
    rk = np.repeat(np.arange(-60, 60, dtype=np.float32), 2)
    rk[::17] = np.nan
    payload = rng.normal(size=rk.shape[0]).astype(np.float32)
    for all_x in (False, True):
        outs = []
        for fr, d in ((card, dev), (card, dev), (cpu, "cpu")):
            right = Frame.from_dict({"k": rk, "w": payload}, device=d)
            outs.append(merge(fr, right, ["k"], all_x=all_x))
        for name in outs[0].names:
            bits = [o.vec(name).data.cpu().view(torch.int32) for o in outs]
            assert torch.equal(bits[0], bits[1]) and \
                torch.equal(bits[0], bits[2]), (all_x, name)
