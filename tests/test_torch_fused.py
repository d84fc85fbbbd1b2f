"""The port's fused LJ + order-CV function against the JAX package's fused
kernel (``fused_lj_order_force``, recurrence mode), on the CPU.

On a CPU tensor ``fused_lj_order_force_cuda`` runs its plain version: the
plain pair force, the plain force sweep and the plain value sweep at the
same positions.  The reference kernel runs in Pallas interpret mode, as
its own test does (tests/test_fused.py).  Both get the same bias
coefficients, from the reference's XLA value sweep.

Inputs: 500 fcc particles (a = 1.62) with Gaussian noise 0.08, from a
seed, so the Q6 bias force does not vanish by symmetry.

Tolerances (the reference's own, tests/test_fused.py): f_lj atol 1e-3 of
its largest component (pair forces up to ~1e2 summed in other orders);
g rtol 2e-3, atol 2e-4 of its largest component; the CV values from the
fresh terms rtol 2e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import metadyn_tpu.ops.packed_fused_pallas as pfp
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.ops.packed import pack_host as jpack_host
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops import packed_fused_cuda as tfc
from metadyn_tpu_torch.ops.packed_order_cuda import (
    decode_value_lanes, lane_layout, pack_force_aux,
)

A_LAT = 1.62
NN = A_LAT / np.sqrt(2)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case():
    pos = fcc_lattice(5, A_LAT)
    n, L = pos.shape[0], 5 * A_LAT
    rng = np.random.default_rng(5)
    pos = (pos + rng.normal(0.0, 0.08, pos.shape)).astype(np.float32)
    jspec = JSpec.create(L, n, r_cut=2.5, skin=0.15, cap=40,
                         uniform_sigma=1.0, uniform_eps=1.0)
    jst, ovf = jpack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                          np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    jcvs = [jpo.PackedSteinhardtQl(spec=jspec, r_cut=NN * 1.2, l=6,
                                   name="q6"),
            jpo.PackedCoordination(spec=jspec, r0=NN * 1.35, name="co",
                                   r_cut=NN * 1.35 * 1.5)]
    return jst, jspec, jcvs


def test_fused_plain_matches_reference_kernel():
    jst, jspec, jcvs = _case()
    st, spec = interop.packed_state_from(jst, "cpu"), \
        interop.packed_spec_from(jspec)
    cvs = [interop.steinhardt_from(jcvs[0]),
           interop.coordination_from(jcvs[1])]

    # the bias coefficients, from the reference's XLA value sweep
    jv, _ = jpo.make_fused_order_force(jcvs, jspec, use_pallas=False)
    _, (jterms, _) = jv(jst)
    dV = np.array([0.9, -1.3], np.float32)
    jauxs = [cv.grad_aux(t, jnp.float32(dV[i]))
             for i, (cv, t) in enumerate(zip(jcvs, jterms))]
    auxs = [cv.aux_from_flat(torch.as_tensor(np.asarray(
                [float(x) for x in jcv.aux_flat(ja)], np.float32)))
            for cv, jcv, ja in zip(cvs, jcvs, jauxs)]

    orig = pl.pallas_call
    pfp.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        jf, jg, jt = pfp.fused_lj_order_force(jst, jspec, jcvs, jauxs,
                                              mono=False)
    finally:
        pfp.pl.pallas_call = orig
    jf, jg = np.asarray(jf), np.asarray(jg)

    before = tfc.fused_lj_order_force_cuda.launches
    f, g, terms = tfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    assert tfc.fused_lj_order_force_cuda.launches == before
    np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                               atol=1e-3 * np.abs(jf).max())
    assert np.abs(jg).max() > 1e-3
    np.testing.assert_allclose(g.numpy(), jg, rtol=2e-3,
                               atol=2e-4 * np.abs(jg).max())
    s = [float(cv.finalize_value(t)) for cv, t in zip(cvs, terms)]
    js = [float(cv.finalize_value(t)) for cv, t in zip(jcvs, jt)]
    np.testing.assert_allclose(s, js, rtol=2e-4)

    # the lane protocol: aux lanes in and value lanes out, in CV order
    aux_off, val_off, n_aux, n_vals = lane_layout(cvs)
    assert (aux_off, val_off, n_aux, n_vals) == ([0, 14], [0, 15], 15, 16)
    lanes = pack_force_aux(cvs, auxs)
    np.testing.assert_array_equal(
        lanes.numpy(), np.asarray(pfp.pack_force_aux(jcvs, jauxs, False))[0,
                                                                      :n_aux])
    vals = torch.cat([torch.cat([t.reshape(-1) for t in tt])
                      for tt in terms])
    back = decode_value_lanes(cvs, vals)
    for a, b in zip(back, terms):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_fused_wrapper_refuses_unported_modes():
    jst, jspec, jcvs = _case()
    st, spec = interop.packed_state_from(jst, "cpu"), \
        interop.packed_spec_from(jspec)
    cvs = [interop.steinhardt_from(jcvs[0])]
    auxs = [(torch.zeros(7), torch.zeros(7))]
    # the monomial mode and its cell_mask are ported (tests/
    # test_torch_spatial.py); a mask without it stays refused, as in the
    # reference, and so do the parts subsets, with or without it
    for kw in (dict(mono=True, parts=frozenset({"vals"})),
               dict(cell_mask=torch.ones(spec.n_cells)),
               dict(parts=frozenset({"lj"}))):
        with pytest.raises(NotImplementedError):
            tfc.fused_lj_order_force_cuda(st, spec, cvs, auxs, **kw)
    validity = interop.packed_spec_from(
        JSpec.create(5 * A_LAT, 500, r_cut=2.5, skin=0.15, cap=40))
    with pytest.raises(ValueError, match="sentinel"):
        tfc.fused_lj_order_force_cuda(st, validity, cvs, auxs)
