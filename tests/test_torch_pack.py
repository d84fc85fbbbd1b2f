"""The sort-based build and rebuild (``ops/packed.pack``, ``repack``), the
sentinel guard ``assert_no_vacant_drift``, and two public names
(``core/box.min_perpendicular_width``, ``cv/base.CollectiveVariable``)
against the JAX package's, on the CPU.

- ``pack`` against the reference's ``pack`` on the same inputs (every array
  of the state to the bit; an orthorhombic and a tilted box; velocities,
  images, types, per-particle ε and σ and a CV attribute), and against
  ``pack_host`` to the bit on the orthorhombic box (under tilt their wrap
  differs: elementwise against matrix products, as in the reference).
- ``repack`` against the reference's on the same displaced state: every
  array to the bit, and against ``repack_incremental``'s slots where the
  particles moved at most one cell.
- ``assert_no_vacant_drift`` raises on one drifted vacant slot and passes
  after an integrator step; a no-op outside the sentinel layout.
- ``min_perpendicular_width`` is ``perpendicular_widths`` and the
  reference's widths (rtol 1e-6) on an orthorhombic and a tilted box.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.box import min_perpendicular_width as j_widths
from metadyn_tpu.ops import packed as jp

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.box import (
    Box, min_perpendicular_width, perpendicular_widths,
)
from metadyn_tpu_torch.cv.base import CollectiveVariable
from metadyn_tpu_torch.cv.simple import AxisPosition
from metadyn_tpu_torch.integrate.packed import make_packed_nve_step
from metadyn_tpu_torch.ops import packed as tp

N = 400
L = 10.0
TILT = (0.2, -0.12, 0.1)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        pos=rng.uniform(-0.8 * L, 0.8 * L, (N, 3)).astype(np.float32),
        vel=rng.normal(0.0, 1.0, (N, 3)).astype(np.float32),
        image=rng.integers(-2, 3, (N, 3)).astype(np.int32),
        types=rng.integers(0, 3, N).astype(np.int32),
        eps=rng.uniform(0.5, 1.5, N).astype(np.float32),
        sigma=rng.uniform(0.8, 1.2, N).astype(np.float32),
        amp=rng.normal(0.0, 1.0, N).astype(np.float32))


def _boxes(tilted: bool):
    if tilted:
        return (JBox.triclinic(L, L, L, *TILT),
                Box.triclinic(L, L, L, "cpu", *TILT))
    return JBox.cubic(L), Box.cubic(L, "cpu")


def _specs(sentinel: bool):
    kw = dict(r_cut=2.5, skin=0.3, cap=36)
    if sentinel:
        kw.update(uniform_sigma=1.0, uniform_eps=1.0)
    jspec = jp.PackedSpec.create(L, N, **kw)
    return jspec, interop.packed_spec_from(jspec)


def _assert_states_equal(a, b):
    """Every array of two port states, to the bit (the zero energy by
    value: ``pack_host``'s is (1,), ``pack``'s and the reference's 0-d)."""
    for k in ("r", "v", "f", "image", "ref_r", "pid", "typ", "slot_of",
              "potential_energy", "virial"):
        x, y = getattr(a, k), getattr(b, k)
        if k == "potential_energy":
            x, y = x.reshape(-1), y.reshape(-1)
        assert x.dtype == y.dtype and torch.equal(x, y), k
    assert a.attrs.keys() == b.attrs.keys()
    for k in a.attrs:
        assert torch.equal(a.attrs[k], b.attrs[k]), k


def _jpack(jbox, jspec, d):
    st, ovf = jp.pack(d["pos"], jbox, jspec, jnp.asarray(d["types"]),
                      jnp.asarray(d["eps"]), jnp.asarray(d["sigma"]),
                      vel=d["vel"], image=d["image"],
                      extra_attrs={"amp": jnp.asarray(d["amp"])})
    assert not bool(ovf)
    return interop.packed_state_from(st, "cpu")


def _tpack(box, spec, d, fn=tp.pack):
    st, ovf = fn(d["pos"], box, spec, d["types"], d["eps"], d["sigma"],
                 "cpu", vel=d["vel"], image=d["image"],
                 extra_attrs={"amp": d["amp"]})
    assert not bool(ovf)
    return st


@pytest.mark.parametrize("tilted", [False, True], ids=["ortho", "tilted"])
@pytest.mark.parametrize("sentinel", [False, True],
                         ids=["per_slot", "sentinel"])
def test_pack_matches_reference_bit_for_bit(tilted, sentinel):
    d = _inputs()
    jbox, box = _boxes(tilted)
    jspec, spec = _specs(sentinel)
    st = _tpack(box, spec, d)
    _assert_states_equal(st, _jpack(jbox, jspec, d))
    if not tilted:
        _assert_states_equal(st, _tpack(box, spec, d, tp.pack_host))


def test_pack_takes_tensors_and_reports_overflow():
    d = _inputs(seed=4)
    _, box = _boxes(False)
    jspec, spec = _specs(True)
    st = _tpack(box, spec, {k: torch.as_tensor(v) for k, v in d.items()})
    _assert_states_equal(st, _tpack(box, spec, d, tp.pack_host))
    small = interop.packed_spec_from(jp.PackedSpec.create(
        L, N, r_cut=2.5, skin=0.3, cap=4, uniform_sigma=1.0,
        uniform_eps=1.0))
    _, ovf = tp.pack(d["pos"], box, small, d["types"], d["eps"],
                     d["sigma"], "cpu")
    assert isinstance(ovf, torch.Tensor) and bool(ovf)


@pytest.mark.parametrize("tilted", [False, True], ids=["ortho", "tilted"])
def test_repack_matches_reference_bit_for_bit(tilted):
    d = _inputs(seed=5)
    jbox, box = _boxes(tilted)
    jspec, spec = _specs(True)
    st0, _ = jp.pack(d["pos"], jbox, jspec, jnp.asarray(d["types"]),
                     jnp.asarray(d["eps"]), jnp.asarray(d["sigma"]),
                     vel=d["vel"], extra_attrs={"amp": jnp.asarray(d["amp"])})
    # every real slot moves up to 0.6 (a neighbour cell at most: cells are
    # ~2.7 wide) and some cross the box; forces ride along
    rng = np.random.default_rng(6)
    real = np.asarray(st0.pid) < N
    dr = rng.uniform(-0.6, 0.6, np.asarray(st0.r).shape).astype(np.float32)
    dr[:, ~real] = 0.0
    jst = st0.replace(r=st0.r + jnp.asarray(dr),
                      f=jnp.asarray(rng.normal(size=dr.shape), jnp.float32))
    st = interop.packed_state_from(jst, "cpu")
    jout, jovf = jp.repack(jst, jspec)
    out, ovf = tp.repack(st, spec)
    assert not bool(jovf) and not bool(ovf)
    _assert_states_equal(out, interop.packed_state_from(jout, "cpu"))
    # one cell at most: the incremental repack puts every particle in the
    # same cell (its rank may differ: it orders arrivals by offset)
    inc, bad = tp.repack_incremental(st, spec)
    assert not bool(bad)
    C = spec.n_cells
    assert torch.equal(inc.slot_of % C, out.slot_of % C)
    assert torch.equal(inc.r[:, inc.slot_of.long()],
                       out.r[:, out.slot_of.long()])


def test_assert_no_vacant_drift():
    d = _inputs(seed=7)
    _, box = _boxes(False)
    _, spec = _specs(True)
    st = _tpack(box, spec, d)
    tp.assert_no_vacant_drift(st, spec)
    step = make_packed_nve_step(
        lambda s: tp.packed_lj_force(s, spec, with_energy=False), dt=1e-4)
    st = step(st.replace(f=tp.packed_lj_force(st, spec,
                                              with_energy=False).f))
    tp.assert_no_vacant_drift(st, spec)
    vac = int(torch.nonzero(st.pid >= spec.n_real)[0])
    r = st.r.clone()
    r[1, vac] += 8.0      # an ulp of VACANT_X (1e7) in f32 is 1
    with pytest.raises(AssertionError, match="1 vacant-slot"):
        tp.assert_no_vacant_drift(st.replace(r=r), spec)
    # outside the sentinel layout vacant slots are not pinned
    _, per_slot = _specs(False)
    tp.assert_no_vacant_drift(st.replace(r=r), per_slot)


@pytest.mark.parametrize("tilted", [False, True], ids=["ortho", "tilted"])
def test_min_perpendicular_width(tilted):
    jbox = (JBox.triclinic(8.0, 9.0, 10.0, *TILT) if tilted
            else JBox.from_lengths(8.0, 9.0, 10.0))
    box = interop.box_from(jbox, "cpu")
    w = min_perpendicular_width(box)
    assert torch.equal(w, perpendicular_widths(box))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_widths(jbox)),
                               rtol=1e-6)
    if not tilted:
        np.testing.assert_array_equal(w.numpy(), [8.0, 9.0, 10.0])
    else:
        # the tilt narrows the x and y widths; the z faces stay Lz apart
        assert (w.numpy()[:2] < [8.0, 9.0]).all() and w[2] == 10.0


def test_collective_variable_protocol():
    assert isinstance(AxisPosition(0, 0, name="x"), CollectiveVariable)
    assert not isinstance(object(), CollectiveVariable)
