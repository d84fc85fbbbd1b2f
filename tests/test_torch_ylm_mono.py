"""The port's homogeneous-monomial Y_lm math (``metadyn_tpu_torch/cv/
ylm_mono.py`` and the monomial protocol of ``PackedSteinhardtQl``) against
the JAX package's ``metadyn_tpu/cv/ylm_mono.py``, on the CPU.

- The static tables (exponent lists, the basis change C, the
  differentiation matrices, the build plan) are numpy float64 in both
  packages: equal exactly.
- ``build_monomials`` on tensors against the reference's on numpy f32
  arrays: the same products in the same order, equal exactly.
- The monomial protocol on random bond vectors: decoded monomial sums
  against the recurrence's value terms (rtol 2e-5 of the largest term:
  degree-6 monomials cancel in f32), ``mono_force_vecs`` against the
  reference's (rtol 1e-5), and the monomial bias force against the
  recurrence's closed form (atol 2e-5 of its scale).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.cv import ylm_mono as jym
from metadyn_tpu.ops.packed import PackedSpec as JSpec

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.cv import ylm_mono as tym


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("l", [2, 4, 6, 8])
def test_tables_equal_reference(l):
    assert tym.mono_powers(l) == jym.mono_powers(l)
    assert tym.n_mono(l) == jym.n_mono(l) == len(tym.mono_powers(l))
    np.testing.assert_array_equal(tym.ylm_mono_matrix(l),
                                  jym.ylm_mono_matrix(l))
    for a, b in zip(tym.diff_matrices(l), jym.diff_matrices(l)):
        np.testing.assert_array_equal(a, b)
    assert tym._split_plan(l) == jym._split_plan(l)


def _bonds(n=400, seed=0):
    """Random bond vectors, r in [0.9, 1.6]."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d *= (rng.uniform(0.9, 1.6, n) / np.linalg.norm(d, axis=0)).astype(
        np.float32)
    return d


@pytest.mark.parametrize("deg", [1, 2, 3, 5, 6])
def test_build_monomials_equal_reference(deg):
    d = _bonds()
    u = d / np.linalg.norm(d, axis=0)
    ref = jym.build_monomials(deg, *u)
    out = tym.build_monomials(deg, *torch.as_tensor(u))
    assert len(out) == tym.n_mono(deg)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def _cvs():
    jspec = JSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8)
    jcv = jpo.PackedSteinhardtQl(spec=jspec, r_cut=1.5, l=6, name="q6")
    return jcv, interop.steinhardt_from(jcv)


def test_mono_decode_matches_recurrence_terms():
    _, cv = _cvs()
    d = torch.as_tensor(_bonds(seed=1))
    r2 = (d * d).sum(0)
    w = torch.ones_like(r2)
    sums = cv.pair_mono_sums(*d, r2, w)
    assert sums.shape == (tym.n_mono(6) + 1,)
    re, im, nb = cv.mono_value_decode(sums[:-1], sums[-1])
    re_r, im_r, nb_r = cv.pair_value_terms(*d, r2, w)
    scale = float(torch.cat([re_r, im_r]).abs().max())
    np.testing.assert_allclose(re.numpy(), re_r.numpy(), rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(im.numpy(), im_r.numpy(), rtol=0,
                               atol=2e-5 * scale)
    assert float(nb) == float(nb_r) == float((r2 < 1.5 ** 2).sum())
    # and the reference's decode of the same sums
    jcv, _ = _cvs()
    jre, jim, _ = jcv.mono_value_decode(jnp.asarray(sums[:-1].numpy()),
                                        jnp.asarray(sums[-1].numpy()))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=1e-6,
                               atol=1e-6 * scale)


def test_mono_force_matches_recurrence_and_reference():
    jcv, cv = _cvs()
    rng = np.random.default_rng(4)
    gre = rng.normal(size=7).astype(np.float32)
    gim = rng.normal(size=7).astype(np.float32)
    gim[0] = 0.0
    aux = (torch.as_tensor(gre), torch.as_tensor(gim))
    b = cv.mono_force_vecs(aux)
    jb = jcv.mono_force_vecs((list(jnp.asarray(gre)), list(jnp.asarray(gim))))
    for x, y in zip(b, jb):
        assert x.shape == (tym.n_mono(5),)
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(y).max()))
    d = torch.as_tensor(_bonds(seed=2))
    r2 = (d * d).sum(0)
    g = torch.stack(cv.pair_mono_grad_terms(*d, r2, b))
    g_r = torch.stack(cv.pair_grad_terms(*d, r2, aux))
    scale = float(g_r.abs().max())
    assert scale > 1e-3
    np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=0,
                               atol=2e-5 * scale)
    outside = r2 >= 1.5 ** 2
    assert outside.any() and torch.all(g[:, outside] == 0.0)
