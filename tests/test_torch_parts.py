"""Kernel 4's ``parts`` subsets (the reference's timing modes) on the CPU:
the port's plain subsets (``fused_lj_order_force_cuda(parts=...)`` on a CPU
tensor) against the JAX package's ``fused_lj_order_force(parts=...)`` in
Pallas interpret mode, on tests/test_torch_fused.py's case (500 fcc
particles with noise, Q6 + coordination).

One interpret call, ``parts={lj, force}``, gives the reference's LJ force
and its bias force through the branch that a subset without ``vals`` takes
(packed_fused_pallas.py:188-199: ``pair_grad_terms`` apart from the value
terms), and its value lanes exactly zero.  Every proper subset of both
modes is held against it: ``f`` with ``lj``, ``g`` with ``force``.  The
value sums of a subset with ``vals`` are held, bit for bit, against the
port's full set on the same inputs, which tests/test_torch_fused.py holds
against the reference's full set in interpret mode (recurrence) and
tests/test_torch_spatial.py against its monomial mode; a second interpret
call here (~6-8 s on an 8-core CPU, most of it the trace and compile)
would check the same sums again.  The monomial mode computes the same
forces in another basis, so its subsets are held against the same call.

Tolerances (kernel 4's, tests/test_torch_fused.py): f atol 1e-3 of its
largest component; g rtol 2e-3, atol 2e-4 of its largest component.  What
a subset does not compute is exactly zero, in both packages.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import metadyn_tpu.ops.packed_fused_pallas as pfp
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.cv.packed_order import order_values_plain
from metadyn_tpu_torch.ops import packed_fused_cuda as tfc

from tests.test_torch_fused import _case

SUBSETS = [frozenset(c) for k in range(3)
           for c in itertools.combinations(sorted(tfc.ALL_PARTS), k)]


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        jst, jspec, jcvs = _case()
        st, spec = interop.packed_state_from(jst, "cpu"), \
            interop.packed_spec_from(jspec)
        cvs = [interop.steinhardt_from(jcvs[0]),
               interop.coordination_from(jcvs[1])]
        # the bias coefficients from the port's plain value sweep (held
        # against the reference's in tests/test_torch_order.py)
        jterms = [tuple(jnp.asarray(x.numpy()) for x in t)
                  for t in order_values_plain(st, spec, cvs)]
        dV = np.array([0.9, -1.3], np.float32)
        jauxs = [cv.grad_aux(t, jnp.float32(dV[i]))
                 for i, (cv, t) in enumerate(zip(jcvs, jterms))]
        auxs = [cv.aux_from_flat(torch.as_tensor(np.asarray(
                    [float(x) for x in jcv.aux_flat(ja)], np.float32)))
                for cv, jcv, ja in zip(cvs, jcvs, jauxs)]
        return jst, jspec, jcvs, jauxs, st, spec, cvs, auxs
    finally:
        torch.set_num_threads(n)


def _reference(case, parts, mono):
    """The reference's subset in interpret mode: (f, g, values, terms)."""
    jst, jspec, jcvs, jauxs = case[:4]
    orig = pl.pallas_call
    pfp.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        f, g, t = pfp.fused_lj_order_force(jst, jspec, jcvs, jauxs,
                                           parts=frozenset(parts), mono=mono)
    finally:
        pfp.pl.pallas_call = orig
    s = [float(cv.finalize_value(x)) for cv, x in zip(jcvs, t)]
    flat = np.concatenate([np.asarray(x).reshape(-1) for tt in t for x in tt])
    return np.asarray(f), np.asarray(g), s, flat


@pytest.fixture(scope="module")
def reference(case):
    """The reference's ``{lj, force}`` in interpret mode."""
    return _reference(case, {"lj", "force"}, False)


@pytest.mark.parametrize("mono", [False, True], ids=["recurrence", "mono"])
def test_parts_subsets_match_reference(case, reference, mono):
    """Each of the seven proper subsets against the reference's outputs at
    kernel 4's tolerances, and exact zeros where it computes nothing."""
    st, spec, cvs, auxs = case[4:]
    fr, gr = reference[:2]
    full = tfc.fused_lj_order_force_cuda(st, spec, cvs, auxs, mono=mono)[2]
    for parts in SUBSETS:
        before = dict(tfc.fused_lj_order_force_cuda.parts_launches)
        f, g, terms = tfc.fused_lj_order_force_cuda(st, spec, cvs, auxs,
                                                    parts=parts, mono=mono)
        # a CPU tensor runs the plain version: no launch is counted
        assert tfc.fused_lj_order_force_cuda.parts_launches == before
        if "lj" in parts:
            np.testing.assert_allclose(f.numpy(), fr, rtol=0,
                                       atol=1e-3 * np.abs(fr).max())
        else:
            assert torch.count_nonzero(f) == 0, parts
        if "force" in parts:
            assert np.abs(gr).max() > 1e-3
            np.testing.assert_allclose(g.numpy(), gr, rtol=2e-3,
                                       atol=2e-4 * np.abs(gr).max())
        else:
            assert torch.count_nonzero(g) == 0, parts
        if "vals" in parts:
            for a, b in zip(terms, full):
                for x, y in zip(a, b):
                    assert torch.equal(x, y), parts
            assert float(cvs[0].finalize_value(terms[0])) > 0.0
        else:
            assert all(torch.count_nonzero(x) == 0 for t in terms for x in t)


def test_reference_subsets_write_zeros(reference):
    """The reference's own subsets give exact zeros for what they leave out
    (its ``_kernel`` initialises every output, packed_fused_pallas.py:157)."""
    f, g, _, vals = reference
    assert not vals.any() and f.any() and g.any()


def test_parts_refused_outside_the_set(case):
    st, spec, cvs, auxs = case[4:]
    with pytest.raises(ValueError, match="subset"):
        tfc.fused_lj_order_force_cuda(st, spec, cvs, auxs,
                                      parts=frozenset({"energy"}))
    assert tfc.parts_key(frozenset(), True) == "{} mono"
    assert tfc.parts_key(frozenset({"vals", "lj"}), False) == "{lj, vals}"
