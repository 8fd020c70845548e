"""Card tests of the port's CUDA kernel against its plain versions, through
the flat and the grouped wrapper.

They need a CUDA GPU and skip without one. On the card (which has no JAX,
so the repo's conftest must not load):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Integer-valued channels must match the plain version exactly (sums of
small integers are exact in f32 in any order); real channels within 1e-4
of each cell's absolute mass, the plain version's worst f32 rounding over
its ascending row blocks being well below that.
"""

import numpy as np
import pytest
import torch

from h2o_tpu_torch.backend.kernels import hist

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


def test_one_group_call_is_the_grouped_kernel(dev):
    Xb, lc, vv = _grouped_inputs(20_000, [299, 299], 4, torch.int16, dev, 300)
    before = hist.GROUPED_LAUNCHES
    one = hist.level_hist_one_group(Xb, lc, vv, Bg=301, mode="onehot",
                                    n_lv=4, nbins_tot=301, block=1024)
    both = hist._cuda_grouped(Xb, lc, vv, (((0, 1), 301, "onehot"),), 4, 300)
    torch.cuda.synchronize()
    assert hist.GROUPED_LAUNCHES == before + 2
    assert torch.equal(one, both[0])
