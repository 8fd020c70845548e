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
    (11_001_856, 29, True, (32, 1024, 10_744)),
    (1_048_576, 690, True, (128, 29, 36_158)),
    (1000, 1, False, (32, 4, 250)),
    (100, 2000, True, (128, 1, 100)),
])
def test_kernel_plan_depends_on_rows_and_width_only(R, P, with_z, want):
    """The kernel's launch plan (tile width, row chunks, rows per chunk)
    is a function of R and P alone, and its chunks cover R."""
    tile, n_chunks, chunk_rows = tgram._gram_plan(R, P, with_z)
    assert (tile, n_chunks, chunk_rows) == want
    assert n_chunks * chunk_rows >= R > (n_chunks - 1) * chunk_rows


def test_cpu_tensor_takes_the_plain_version_and_other_devices_raise():
    X, W, z = (torch.from_numpy(a) for a in _inputs(64, 3, integer=True))
    before = tgram.GRAM_LAUNCHES
    G, b = tgram.gram_accumulate(X, W, z)
    assert tgram.GRAM_LAUNCHES == before
    Gp, bp = tgram._torch_gram(X, W, z, 64)
    assert torch.equal(G, Gp) and torch.equal(b, bp)
    with pytest.raises(NotImplementedError, match="no Gram path"):
        tgram.gram_accumulate(X.to("meta"), W.to("meta"), z.to("meta"))
