"""The port's packed order CVs (Steinhardt Q6, coordination) against the JAX
package's, on the CPU: the per-pair math on random bond vectors, and the
plain value and force sweeps against the reference's XLA roll sweep.

Inputs: a noisy fcc lattice (500 particles, a = 1.62, Gaussian noise 0.08),
made with numpy from a seed and packed by the reference.  On a perfect
lattice the Q6 bias force vanishes by symmetry and a relative comparison
means nothing.

Tolerances: per-pair terms are the same f32 formulas evaluated by two
frameworks (rtol 1e-5, atol 1e-6 on terms of order 1; the closed-form
gradient rtol 1e-4, atol 1e-5 of its scale).  The sweeps sum ~10^4 bond
terms in different orders: values rtol 2e-5; forces rtol 2e-3 and atol
2e-4 of the largest component (the reference's own kernel-vs-XLA
tolerances, tests/test_packed.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.ops.packed import pack_host as jpack_host
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.state import make_system
from metadyn_tpu_torch.cv import packed_order as tpo
from metadyn_tpu_torch.ops.packed_order_cuda import (
    order_force_cuda, order_values_cuda,
)

A_LAT = 1.62
NN = A_LAT / np.sqrt(2)
DV = np.array([0.9, -1.3], np.float32)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(sentinel: bool):
    """(jstate, jspec, jcvs, state, spec, cvs): 500 noisy fcc particles."""
    pos = fcc_lattice(5, A_LAT)
    n, L = pos.shape[0], 5 * A_LAT
    rng = np.random.default_rng(5)
    pos = (pos + rng.normal(0.0, 0.08, pos.shape)).astype(np.float32)
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    jspec = JSpec.create(L, n, r_cut=2.5, skin=0.15, cap=40, **kw)
    assert jspec.cells_per_dim == (3, 3, 3)
    jst, ovf = jpack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                          np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    jcvs = [jpo.PackedSteinhardtQl(spec=jspec, r_cut=NN * 1.2, l=6,
                                   name="q6"),
            jpo.PackedCoordination(spec=jspec, r0=NN * 1.35, name="co",
                                   r_cut=NN * 1.35 * 1.5)]
    cvs = [interop.steinhardt_from(jcvs[0]),
           interop.coordination_from(jcvs[1])]
    return (jst, jspec, jcvs, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec), cvs)


def _bonds(seed: int, n: int = 400):
    """Random bond vectors (some beyond each cut-off) and weights."""
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(n, 3)) * 0.9).astype(np.float32)
    d[0] = 0.0                                   # a self pair: r² = 0
    r2 = np.sum(d * d, axis=1)
    w = (rng.integers(0, 2, n) * 2.0).astype(np.float32)
    return d, r2, w


def _per_cv():
    """(jax CV, port CV) pairs: Q6, Q4, coordination with and without a
    cut-off."""
    jspec = JSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8)
    jcvs = [jpo.PackedSteinhardtQl(spec=jspec, r_cut=1.4, l=6),
            jpo.PackedSteinhardtQl(spec=jspec, r_cut=1.6, l=4),
            jpo.PackedCoordination(spec=jspec, r0=1.5, r_cut=2.2),
            jpo.PackedCoordination(spec=jspec, r0=1.5)]
    ports = [interop.steinhardt_from(jcvs[0]),
             interop.steinhardt_from(jcvs[1]),
             interop.coordination_from(jcvs[2]),
             interop.coordination_from(jcvs[3])]
    return list(zip(jcvs, ports))


def _close(a, b, rtol, atol_frac, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_frac * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("which", range(4), ids=["q6", "q4", "coord_rcut",
                                                 "coord"])
def test_pair_math_matches_reference(which):
    jcv, cv = _per_cv()[which]
    d, r2, w = _bonds(10 + which)
    jd = [jnp.asarray(d[:, k]) for k in range(3)]
    td = [torch.as_tensor(d[:, k]) for k in range(3)]
    jr2, tr2 = jnp.asarray(r2), torch.as_tensor(r2)

    # value terms (flat) and the structured terms
    jflat = jcv.pair_value_terms_flat(*jd, jr2, jnp.asarray(w))
    flat = cv.pair_value_terms_flat(*td, tr2, torch.as_tensor(w))
    assert len(flat) == len(jflat) == cv.n_value_terms
    _close([float(x) for x in flat], [float(x) for x in jflat], 1e-5, 1e-6,
           "pair_value_terms_flat")

    # the outer gradient and the finalized value from those terms
    jterms = jcv.terms_from_flat(jflat)
    terms = cv.terms_from_flat(flat)
    _close(float(cv.finalize_value(terms)), float(jcv.finalize_value(jterms)),
           1e-6, 0.0, "finalize_value")
    jaux = jcv.grad_aux(jterms, jnp.float32(DV[0]))
    aux = cv.grad_aux(terms, torch.tensor(DV[0]))
    _close(cv.aux_flat(aux).numpy(),
           [float(x) for x in jcv.aux_flat(jaux)], 1e-5, 1e-6, "grad_aux")
    assert cv.aux_flat(aux).numel() == cv.aux_size == jcv.aux_size

    # the closed-form bias-force gradient, from the same aux
    g = cv.pair_grad_terms(*td, tr2, aux)
    jg = jcv.pair_grad_terms(*jd, jr2, jaux)
    for k in range(3):
        _close(g[k].numpy(), np.asarray(jg[k]), 1e-4, 1e-5, f"grad {k}")

    if hasattr(jcv, "pair_value_and_grad"):
        # the interleaved recurrence: value terms and gradient in one pass
        jf2, *jg2 = jcv.pair_value_and_grad(*jd, jr2, jnp.asarray(w), jaux)
        f2, *g2 = cv.pair_value_and_grad(*td, tr2, torch.as_tensor(w), aux)
        _close([float(x) for x in f2], [float(x) for x in jf2], 1e-5, 1e-6,
               "pair_value_and_grad values")
        for k in range(3):
            _close(g2[k].numpy(), np.asarray(jg2[k]), 1e-4, 1e-5,
                   f"pair_value_and_grad grad {k}")


@pytest.mark.parametrize("sentinel", [False, True],
                         ids=["validity", "sentinel"])
def test_plain_sweeps_match_reference(sentinel):
    """make_fused_order_force on a CPU state (the plain sweeps) against the
    reference's XLA sweep, and each CV's own value and accum_bias_force."""
    jst, jspec, jcvs, st, spec, cvs = _case(sentinel)
    jv, jf = jpo.make_fused_order_force(jcvs, jspec, use_pallas=False)
    tv, tf = tpo.make_fused_order_force(cvs, spec)
    js, jctx = jv(jst)
    s, ctx = tv(st)
    _close(s.numpy(), np.asarray(js), 2e-5, 0.0, "s")
    for t, jt in zip(ctx[0], jctx[0]):
        for a, b in zip(t, jt):
            _close(np.asarray(a), np.asarray(b), 2e-5, 1e-6, "terms")
    jg = np.asarray(jf(jst, jctx, jnp.asarray(DV)))
    g = tf(st, ctx, torch.as_tensor(DV)).numpy()
    assert np.abs(jg).max() > 1e-3            # a real, non-symmetric force
    _close(g, jg, 2e-3, 2e-4, "fused force")
    vac = st.pid.numpy() >= spec.n_real
    assert vac.any() and np.all(g[:, vac] == 0.0)

    # the single-CV entry points: value (the stride-end cv_stack) and the
    # analytic bias force
    system = make_system(spec.n_real, "cpu")
    for i, (cv, jcv) in enumerate(zip(cvs, jcvs)):
        _close(float(cv.value(st, system)), float(jcv.value(jst, None)), 2e-5,
               0.0, f"{cv.name} value")
        g1 = cv.accum_bias_force(st, system, torch.tensor(DV[i]),
                                 torch.zeros_like(st.r)).numpy()
        jg1 = np.asarray(jcv.accum_bias_force(jst, None, jnp.float32(DV[i]),
                                              jnp.zeros_like(jst.r)))
        _close(g1, jg1, 2e-3, 2e-4, f"{cv.name} accum_bias_force")


def test_wrappers_on_cpu_are_the_plain_sweeps():
    """On a CPU tensor the kernel wrappers run the plain sweeps and launch
    nothing; the j-row blocking of the plain sweeps changes no sum."""
    _, _, _, st, spec, cvs = _case(True)
    before = (order_values_cuda.launches, order_force_cuda.launches)
    terms = order_values_cuda(st, spec, cvs)
    ref = tpo.order_values_plain(st, spec, cvs)
    auxs = [cv.grad_aux(t, torch.tensor(DV[i]))
            for i, (cv, t) in enumerate(zip(cvs, ref))]
    g = order_force_cuda(st, spec, cvs, auxs)
    assert (order_values_cuda.launches, order_force_cuda.launches) == before
    for t, r in zip(terms, ref):
        for a, b in zip(t, r):
            assert torch.equal(a, b)
    assert torch.equal(g, tpo.order_force_plain(st, spec, cvs, auxs))
    # the same sweeps in j blocks of 8 rows
    orig = tpo._j_block
    tpo._j_block = lambda spec: 8
    try:
        g8 = tpo.order_force_plain(st, spec, cvs, auxs)
        t8 = tpo.order_values_plain(st, spec, cvs)
    finally:
        tpo._j_block = orig
    _close(g8.numpy(), g.numpy(), 1e-5, 1e-6, "blocked force")
    _close(cvs[0].finalize_value(t8[0]), cvs[0].finalize_value(ref[0]), 1e-6,
           0.0, "blocked values")


def test_interop_carries_order_cv_parameters():
    """Port CV → arrays → reference CV → port CV keeps every parameter."""
    for _, cv in _per_cv():
        if isinstance(cv, tpo.PackedSteinhardtQl):
            a = interop.steinhardt_arrays(cv)
            jcv = jpo.PackedSteinhardtQl(spec=JSpec(**a["spec"]),
                                         r_cut=a["r_cut"], l=a["l"],
                                         name=a["name"])
            back = interop.steinhardt_from(jcv)
            keys = ("r_cut", "l", "name")
        else:
            a = interop.coordination_arrays(cv)
            jcv = jpo.PackedCoordination(spec=JSpec(**a["spec"]), r0=a["r0"],
                                         name=a["name"], r_cut=a["r_cut"])
            back = interop.coordination_from(jcv)
            keys = ("r0", "r_cut", "name")
        assert jcv.spec == JSpec(**interop.packed_spec_fields(cv.spec))
        for k in keys:
            assert getattr(back, k) == getattr(cv, k) == getattr(jcv, k), k
        assert back.spec == cv.spec


def test_order_cvs_refuse_what_the_reference_refuses():
    spec = interop.packed_spec_from(
        JSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8))
    with pytest.raises(ValueError, match="even l"):
        tpo.PackedSteinhardtQl(spec, r_cut=1.4, l=5)
    with pytest.raises(ValueError, match="stencil"):
        tpo.PackedSteinhardtQl(spec, r_cut=3.5, l=6)
    with pytest.raises(ValueError, match="stencil"):
        tpo.PackedCoordination(spec, r0=2.5)
    # the neighbour-table path is ported (tests/test_torch_neighbor_table.py);
    # it refuses, as the reference's sampler does, a CV without an explicit
    # r_cut and a table radius short of a CV's r_cut + skin
    from metadyn_tpu_torch.core.packed_engine import PackedEngine
    from metadyn_tpu_torch.sampler import make_bias_force_parts
    eng = PackedEngine(spec, "cpu", nbr_table=(2.0, 8))
    with pytest.raises(AssertionError, match="explicit r_cut"):
        make_bias_force_parts(eng, [tpo.PackedCoordination(spec, r0=1.0)],
                              None)
    with pytest.raises(AssertionError, match="exceeds the table radius"):
        make_bias_force_parts(
            eng, [tpo.PackedSteinhardtQl(spec, r_cut=1.8, l=6)], None)
    # the monomial protocol is ported (tests/test_torch_ylm_mono.py); the
    # card's monomial kernel takes Q_6 alone (its 63 + 1 aux lanes fill
    # the kernel's 64), and the fused kernel's mask needs the mode
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import cv_descriptor
    cv = tpo.PackedSteinhardtQl(spec, r_cut=1.4, l=4)
    with pytest.raises(NotImplementedError):
        cv_descriptor([cv], mono=True)
    lean = interop.packed_spec_from(
        JSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8,
                     uniform_sigma=1.0, uniform_eps=1.0))
    with pytest.raises(NotImplementedError):
        fused_lj_order_force_cuda(None, lean, [cv], [None],
                                  cell_mask=torch.ones(lean.n_cells))
