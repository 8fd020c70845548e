"""Port parity: frames, bin edges and bin codes of ``h2o_tpu_torch``
against the reference (``h2o_tpu/frame``, ``h2o_tpu/models/tree/
binning.py``).

Bin codes must be exactly equal, on 20k rows with NaNs (padded length
above the exact-binning limit, so the quantile sketch runs). Edges must
agree within 2 f32 ulps at the column's scale (2 * spacing(max |x|)): the
sketch reads each quantile as lo + (bin + frac) * width / 1024 with
frac = (q * (n - 1) - cum) / cnt, a cancellation, and XLA's CPU backend
contracts that numerator into an FMA in some lanes of its vectorised loops
and not in others. The port forms it exactly (as the FMA does), so most
edges are bit-equal and the rest differ by at most an ulp of the column's
magnitude — which, for an edge near zero, is many ulps of the edge itself.
The JAX side runs on a one-device mesh so both packages pad alike.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.models.tree import binning as jbinning
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu_torch.frame.chunks import BinnedView
from h2o_tpu_torch.frame.vec import Vec
from h2o_tpu_torch.models.tree import binning as tbinning
from h2o_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

MAX_ULPS = 2


@pytest.fixture
def one_mesh():
    one = meshmod.make_mesh(jax.devices()[:1])
    with meshmod.use_mesh(one):
        yield one


def _columns(n, seed=0):
    """Continuous columns of different shapes, with NaNs."""
    rng = np.random.default_rng(seed)
    cols = [rng.normal(size=n), np.exp(rng.normal(size=n)),
            rng.uniform(-3, 7, n), rng.standard_t(2, n) * 1e3,
            rng.normal(size=n) * 1e-4 + 5.0]
    cols = [c.astype(np.float32) for c in cols]
    cols[0][rng.random(n) < 0.1] = np.nan
    cols[3][rng.random(n) < 0.3] = np.nan
    return cols


def _assert_edges_close(je, te, cols):
    assert je.shape == te.shape
    assert np.array_equal(np.isnan(je), np.isnan(te))
    for f, c in enumerate(cols):
        tol = MAX_ULPS * np.spacing(np.nanmax(np.abs(c)))
        assert np.nanmax(np.abs(je[f] - te[f]), initial=0.0) <= tol


def _edges_both(cols, one_mesh, **kw):
    jv = [JVec.from_numpy(c, mesh=one_mesh) for c in cols]
    tv = [Vec.from_numpy(c, device="cpu") for c in cols]
    is_cat = np.zeros(len(cols), bool)
    je = jbinning.compute_bin_edges_cols(jv, is_cat, 20, **kw)
    te = tbinning.compute_bin_edges_cols(tv, is_cat, 20, **kw)
    return jv, tv, je, te


@pytest.mark.parametrize("histogram_type", ["AUTO", "QuantilesGlobal",
                                            "UniformAdaptive"])
def test_edges_and_codes_match_the_reference(one_mesh, histogram_type):
    cols = _columns(20_000)
    jv, tv, je, te = _edges_both(cols, one_mesh,
                                 histogram_type=histogram_type)
    assert tv[0].plen == jv[0].plen == 20_224 > 16_384   # sketch, not exact
    _assert_edges_close(je, te, cols)
    for f in range(len(cols)):
        jc = np.asarray(jbinning.bin_column(
            jv[f].data, jnp.asarray(je[f]), dtype=jnp.int8))
        tc = tbinning.bin_column(tv[f].data, torch.from_numpy(te[f]),
                                 dtype=torch.int8).numpy()
        assert np.array_equal(jc, tc)


def test_exact_small_data_binning_matches_the_reference(one_mesh):
    """Padded length under the exact-binning limit: few-valued columns cut
    at the midpoints between distinct values (``_distinct_values``)."""
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 12, 3000).astype(np.float32),
            (rng.integers(0, 200, 3000) * 0.5).astype(np.float32),
            rng.normal(size=3000).astype(np.float32)]   # > 1024 values: sketch
    cols[0][::17] = np.nan
    _, _, je, te = _edges_both(cols, one_mesh)
    assert je.shape == (3, 199)                   # exact cuts widen the edges
    _assert_edges_close(je, te, cols)


@pytest.mark.parametrize("nbins_cats", [1024, 16])
def test_categorical_edges_and_codes_match_the_reference(one_mesh,
                                                         nbins_cats):
    """Categorical columns cut once per observed level (cardinality =
    largest code + 1, not the domain's size), capped by ``nbins_cats`` —
    levels at or above the cap share the top bin — and skip the exact
    small-data cuts even under the exact-binning row limit. Edges and codes
    are integers, so both must be exactly equal; the int16 view packs a
    300-level column."""
    rng = np.random.default_rng(7)
    n = 3000                                       # under the exact limit
    cols = [rng.integers(0, 300, n).astype(np.float32),   # wide categorical
            rng.integers(0, 7, n).astype(np.float32),     # narrow categorical
            rng.integers(0, 12, n).astype(np.float32),    # numeric, exact
            rng.normal(size=n).astype(np.float32)]        # numeric, sketch
    cols[0][::13] = np.nan
    cols[1][cols[1] == 6] = 5                      # domain 7, observed 6
    is_cat = np.array([True, True, False, False])
    jv = [JVec.from_numpy(c, mesh=one_mesh) for c in cols]
    tv = [Vec.from_numpy(c, device="cpu") for c in cols]
    je = jbinning.compute_bin_edges_cols(jv, is_cat, 20,
                                         nbins_cats=nbins_cats)
    te = tbinning.compute_bin_edges_cols(tv, is_cat, 20,
                                         nbins_cats=nbins_cats)
    card = min(300, nbins_cats)
    assert te.shape == (4, max(card - 1, 19))
    assert np.array_equal(te[0, :card - 1], np.arange(card - 1))
    assert int((~np.isnan(te[1])).sum()) == 5      # observed levels 0..5
    assert np.array_equal(np.isnan(je), np.isnan(te))
    assert np.array_equal(np.nan_to_num(je[:3], nan=-1),
                          np.nan_to_num(te[:3], nan=-1))
    _assert_edges_close(je[3:], te[3:], cols[3:])
    dtype = BinnedView.code_dtype(te.shape[1] + 1)
    jdt = jnp.int16 if dtype == torch.int16 else jnp.int8
    for f in range(4):
        jc = np.asarray(jbinning.bin_column(jv[f].data, jnp.asarray(je[f]),
                                            dtype=jdt))
        tc = tbinning.bin_column(tv[f].data, torch.from_numpy(te[f]),
                                 dtype=dtype).numpy()
        assert np.array_equal(jc, tc)
    codes = tbinning.bin_column(tv[0].data, torch.from_numpy(te[0]))
    lv = torch.from_numpy(np.nan_to_num(cols[0], nan=0)).to(torch.int32)
    ok = torch.from_numpy(~np.isnan(cols[0]))
    assert torch.equal(codes[:n][ok], torch.clamp(lv, max=card - 1)[ok])
    assert int(codes[:n][~ok].min()) == te.shape[1] + 1      # NA bucket
    bv = BinnedView.build(tv, te)
    assert bv.matrix.dtype == (torch.int16 if nbins_cats > 127
                               else torch.int8)


def test_sketch_quantiles_match_the_reference():
    X = np.stack(_columns(20_224, seed=5), axis=1)
    X[20_000:] = np.nan                                  # padding rows
    qs = tuple(np.linspace(0, 1, 21)[1:-1])
    ref = np.asarray(jbinning._hist_quantile_rows(jnp.asarray(X), qs))
    port = tbinning._hist_quantile_rows(torch.from_numpy(X), qs).numpy()
    _assert_edges_close(ref.T, port.T, X.T)


def test_binned_view_packs_int8_codes():
    cols = [Vec.from_numpy(c, device="cpu") for c in _columns(20_000)]
    edges = tbinning.compute_bin_edges_cols(cols, np.zeros(5, bool), 20)
    bv = BinnedView.build(cols, edges)
    assert bv.matrix.dtype == torch.int8 and bv.matrix.is_contiguous()
    assert tuple(bv.matrix.shape) == (20_224, 5)
    assert int(bv.matrix[20_000:].min()) == 20              # padding -> NA bin
    assert BinnedView.code_dtype(300) == torch.int16


@pytest.mark.parametrize("nrow", [1, 9_999, 10_000, 999_999, 1_000_000])
def test_padded_len_is_the_one_device_reference(one_mesh, nrow):
    assert tmesh.padded_len(nrow) == meshmod.padded_len(nrow, one_mesh)


def test_vec_rollups_match_the_reference(one_mesh):
    c = _columns(20_000)[3]
    jr = JVec.from_numpy(c, mesh=one_mesh).rollups()
    tr = Vec.from_numpy(c, device="cpu").rollups()
    assert (tr.mins, tr.maxs, tr.nacnt) == (jr.mins, jr.maxs, jr.nacnt)
    assert tr.mean == pytest.approx(jr.mean, rel=1e-5)
    assert tr.sigma == pytest.approx(jr.sigma, rel=1e-5)


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vec.from_numpy(np.zeros(4, np.float32))
