"""The double-well FES oracle (tests/test_sampler.py:28-88) on the port,
through scripts/fes_oracle.py: one particle in U(x) = 2(x² − 1)² + 5(y² +
z²) (``ForceField(external=)``, its force by autograd), CV = x
(``AxisPosition``), BAOAB Langevin at kT 0.6, well-tempered
metadynamics; after a transient the well-tempered estimate is averaged
over segments and held against U on |x| ≤ 1.2, up to a constant.

The fast protocol (200k steps, then 4 × 50k) must come within 0.5 kT, the
full one (400k, then 16 × 100k) within 0.1 kT, the north star's bound.
Both run eager torch steps, far past tier-1's budget, so both are
``slow``, as the reference's full oracle is.  Each
runs on the CPU and on a CUDA device (``cuda``; skipped without one):
    python -m pytest -m slow tests/test_torch_fes_oracle.py
and on the card (which has no flax for tests/conftest.py):
    python -m pytest --noconftest -m "slow and cuda" \
        tests/test_torch_fes_oracle.py
The error and the seconds of each run are printed.  A run that must
outlast one call on a card goes in legs through the script (``--state``,
``--leg-seconds``).
"""
import importlib.util
import pathlib

import pytest
import torch

# the oracle's sampler and protocol live in scripts/fes_oracle.py (which
# also runs them in legs on a card), loaded by path
_SPEC = importlib.util.spec_from_file_location(
    "fes_oracle", pathlib.Path(__file__).resolve().parent.parent
    / "scripts" / "fes_oracle.py")
oracle = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(oracle)
KT = oracle.KT

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if request.param == "cpu":
        old = torch.get_num_threads()
        torch.set_num_threads(2)
        yield "cpu"
        torch.set_num_threads(old)
    else:
        yield "cuda"


def _run(name, device):
    transient, n_seg, seg, bound_kT = oracle.PROTOCOLS[name]
    err, secs = oracle.run_protocol(device, transient, n_seg, seg)
    where = (torch.cuda.get_device_name(0) if device == "cuda"
             else "the CPU")
    print(f"\n{name} protocol ({transient} + {n_seg} x {seg}) on {where}: "
          f"max|F - U| = {err:.4f} ({err / KT:.4f} kT) in {secs:.1f} s")
    assert err < bound_kT * KT, err


@pytest.mark.slow
def test_double_well_fes_oracle_fast(device):
    """Short protocol: within 0.5 kT."""
    _run("fast", device)


@pytest.mark.slow
def test_double_well_fes_oracle(device):
    """Full protocol: within 0.1 kT, the north star's bound."""
    _run("full", device)


def test_protocol_in_legs_repeats_the_straight_run(tmp_path):
    """A short protocol in legs (a checkpoint of the particle-order carry
    after every segment) gives the straight run's error bit for bit."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        straight, _ = oracle.run_protocol("cpu", 200, 2, 100)
        state = str(tmp_path / "legs.npz")
        legs = 0
        while True:
            out = oracle.run_protocol("cpu", 200, 2, 100, state_path=state,
                                      leg_seconds=0.0)
            legs += 1
            if out is not None:
                break
    finally:
        torch.set_num_threads(old)
    assert legs == 4 and out[0] == straight
