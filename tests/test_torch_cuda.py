"""Card tests of the port's CUDA kernels against their plain versions: the
level histogram through its flat and grouped wrappers, the weighted Gram,
and a small GLM fit on the card against the same fit on the CPU.

They need a CUDA GPU and skip without one. On the card (which has no JAX,
so the repo's conftest must not load):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Integer-valued channels must match the plain version exactly (sums of
small integers are exact in f32 in any order); real channels within 1e-4
of each cell's absolute mass, the plain version's worst f32 rounding over
its ascending row blocks being well below that. Gram entries within 1e-5 of
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
