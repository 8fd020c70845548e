"""Port parity: the weighted Gram of ``h2o_tpu_torch`` (its plain version,
which the CPU runs) against the reference's ``gram_accumulate`` through both
of its backends, the blocked ``xla`` scan and the ``pallas`` kernel run
interpreted.

Contracts and tolerances:

- integer-valued X, W and z are exact in float32 in any order, so G and b
  must be bit-equal to both reference backends;
- real values: every entry within 1e-6 of that entry's absolute mass (the
  Gram of |X|, |W|, |z|), the two packages' float32 matrix products adding
  the same terms in other orders;
- ``block=999`` at 5,000 rows engages the zero-row padding (6 blocks of 834
  rows, 4 padded) on both sides: the port's plain version takes the block
  size directly (``_plain_gram``), ``gram_accumulate`` has no such option.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.backend.kernels import gram as jgram
from h2o_tpu_torch.backend.kernels import gram as tgram

torch.set_num_threads(2)

MASS_TOL = 1e-6


def _inputs(R, P, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-3, 4, (R, P)).astype(np.float32),
                rng.integers(0, 3, R).astype(np.float32),
                rng.integers(-2, 3, R).astype(np.float32))
    return (rng.normal(size=(R, P)).astype(np.float32),
            rng.random(R).astype(np.float32),
            rng.normal(size=R).astype(np.float32))


def _port(X, W, z, block):
    """``gram_accumulate`` at the default blocking; the plain version with
    ``block`` rows per block where the reference is given ``block=``."""
    args = (torch.from_numpy(X), torch.from_numpy(W),
            None if z is None else torch.from_numpy(z))
    G, b = (tgram.gram_accumulate(*args) if block is None
            else tgram._plain_gram(*args, block))
    return G.numpy(), None if b is None else b.numpy()


#: the reference under jit, as its GLM step calls it: one compile per
#: signature serves the integer and the real-valued cases alike
_ref_gram = jax.jit(jgram.gram_accumulate, static_argnames=("block", "backend"))


def _ref(X, W, z, block, backend):
    G, b = _ref_gram(jnp.asarray(X), jnp.asarray(W),
                     None if z is None else jnp.asarray(z),
                     block=block, backend=backend)
    return np.asarray(G), None if b is None else np.asarray(b)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("integer,with_z", [(True, True), (False, True),
                                            (False, False)])
@pytest.mark.parametrize("R,P,block", [(4096, 8, None), (5000, 33, None),
                                       (5000, 33, 999)])
def test_gram_matches_the_reference(R, P, block, integer, with_z, backend):
    X, W, z = _inputs(R, P, integer)
    z = z if with_z else None
    G, b = _port(X, W, z, block)
    Gr, br = _ref(X, W, z, block, backend)
    assert G.shape == (P, P) and G.dtype == np.float32
    assert (b is None) == (not with_z)
    if integer:
        assert np.array_equal(G, Gr)
        if with_z:
            assert np.array_equal(b, br)
        return
    Gm, bm = _port(np.abs(X), W, None if z is None else np.abs(z), block)
    assert np.all(np.abs(G - Gr) <= MASS_TOL * Gm)
    if with_z:
        assert np.all(np.abs(b - br) <= MASS_TOL * bm)


def test_block_contrib_matches_the_reference():
    """The shared per-block math (RuleFit's streaming IRLS calls it in the
    reference), with and without z."""
    X, W, z = _inputs(3000, 5, integer=False, seed=3)
    dG, db = tgram.block_contrib(torch.from_numpy(X), torch.from_numpy(W),
                                 torch.from_numpy(z))
    rG, rb = jgram.block_contrib(jnp.asarray(X), jnp.asarray(W),
                                 jnp.asarray(z))
    np.testing.assert_allclose(dG.numpy(), np.asarray(rG), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(rb), rtol=1e-5,
                               atol=1e-3)
    assert tgram.block_contrib(torch.from_numpy(X), torch.from_numpy(W),
                               None)[1] is None


@pytest.mark.parametrize("R,P,with_z,want", [
    (11_001_856, 29, True, (32, 1, 1024, 10_752, 256)),
    (1_048_576, 690, True, (128, 21, 49, 21_440, 64)),
    (1000, 1, False, (32, 1, 4, 256, 256)),
    (100, 2000, True, (128, 136, 2, 64, 64)),
])
def test_kernel_plan_depends_on_rows_and_width_only(R, P, with_z, want):
    """The kernel's launch plan (tile edge, triangle tiles, row chunks, rows
    per chunk, rows per staged block) is a function of R and P alone, its
    chunks cover R, and each chunk is a whole number of staged blocks."""
    tile, tiles, n_chunks, chunk_rows, bk = tgram._gram_plan(R, P, with_z)
    assert (tile, len(tiles), n_chunks, chunk_rows, bk) == want
    assert n_chunks * chunk_rows >= R > (n_chunks - 1) * chunk_rows
    assert chunk_rows % bk == 0 and bk % 4 == 0


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("P", [1, 29, 31, 32, 130, 690])
def test_kernel_plan_covers_the_upper_triangle_once(P, with_z):
    """The triangle grid: the plan's tiles (ti <= tj) hold every entry of
    G's upper triangle, and every entry of b (column P of [X | z]), exactly
    once; the reduce pass mirrors the lower triangle from them. The chunk
    count moves with R only (P fixed), never with anything else."""
    Q = P + with_z
    tile, tiles, n_chunks, _rows, _bk = tgram._gram_plan(10_000, P, with_z)
    assert all(ti <= tj for ti, tj in tiles)
    owned = np.zeros((P, Q), np.int64)
    for ti, tj in tiles:
        owned[ti * tile:(ti + 1) * tile, tj * tile:(tj + 1) * tile] += 1
    i, j = np.indices((P, Q))
    assert (owned[j >= i] == 1).all()
    assert len(tiles) == len({*tiles})
    assert tgram._gram_plan(10_000, P, with_z)[2] == n_chunks
    assert tgram._gram_plan(10_000_000, P, with_z)[2] >= n_chunks


def _tf32(a):
    """float32 rounded to TF32's 10 mantissa bits, nearest with ties away
    from zero (PTX ``cvt.rna.tf32.f32``; the kernel's hi part)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _tf32_truncated(a):
    """float32 cut to TF32's 10 mantissa bits: what the tensor cores read of
    a float32 operand, the kernel's lo part, which it passes unrounded."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return (bits & ~0x1FFF).view(np.float32)


def test_3xtf32_split_keeps_float32_accuracy_where_tf32_does_not():
    """The kernel's numeric design rehearsed in numpy on the operands of
    ``chip_smoke.gram_tf32_probe`` (X, z in [1, 2) with a 2^-12 term a TF32
    operand drops; W in {2^-2, 2^-3, 2^-4}): with a = hi + lo split into two
    TF32 numbers (hi rounded to nearest, lo = a - hi truncated as the
    tensor cores read it), lo*hi + hi*lo + hi*hi lands within 1e-5 of the
    float64 Gram, while one TF32 product (hi*hi) misses by more than
    1e-4."""
    rng = np.random.default_rng(7)
    R, P = 4096, 29

    def on_grid(shape):
        return (1.0 + rng.integers(0, 1024, shape) * 2.0 ** -10
                + 2.0 ** -12).astype(np.float32)

    X, z = on_grid((R, P)), on_grid(R)
    W = (2.0 ** -rng.integers(2, 5, R)).astype(np.float32)
    A = X * W[:, None]                       # float32, as the kernel forms it
    B = np.concatenate([X, z[:, None]], 1)
    exact = A.astype(np.float64).T @ B.astype(np.float64)

    def split(a):
        hi = _tf32(a)
        return (hi.astype(np.float64),
                _tf32_truncated(a - hi).astype(np.float64))

    (ah, al), (bh, bl) = split(A), split(B)
    three = al.T @ bh + ah.T @ bl + ah.T @ bh
    one = ah.T @ bh
    assert np.abs(three - exact).max() / exact.min() <= 1e-5
    assert (np.abs(one - exact) / exact).min() > 1e-4


def test_cpu_tensor_takes_the_plain_version_and_other_devices_raise():
    X, W, z = (torch.from_numpy(a) for a in _inputs(64, 3, integer=True))
    before = tgram.GRAM_LAUNCHES
    G, b = tgram.gram_accumulate(X, W, z)
    assert tgram.GRAM_LAUNCHES == before
    Gp, bp = tgram._torch_gram(X, W, z, 64)
    assert torch.equal(G, Gp) and torch.equal(b, bp)
    with pytest.raises(NotImplementedError, match="no Gram path"):
        tgram.gram_accumulate(X.to("meta"), W.to("meta"), z.to("meta"))
