"""``utils/profiling``'s ``StepTimer``, ``trace`` and ``phase`` on the port's
sampler, the mirror of the JAX package's tests/test_io.py:288-305: the
one-particle double well of ``scripts/fes_oracle.py`` (stride 25) runs 100
steps (the reference's 250) under ``trace``, which writes a trace file; the
timer's lap and report count the steps and rates, with the reference's
report keys and arithmetic."""
import importlib.util
import json
import os
import pathlib

import pytest
import torch

from metadyn_tpu_torch.utils.profiling import StepTimer, phase, trace

_SPEC = importlib.util.spec_from_file_location(
    "fes_oracle", pathlib.Path(__file__).resolve().parent.parent
    / "scripts" / "fes_oracle.py")
oracle = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(oracle)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_profiling_helpers(tmp_path):
    s = oracle.double_well_sampler("cpu", stride=25)
    timer = StepTimer(n_particles=1)
    with trace(str(tmp_path / "tb")):
        with phase("md"):
            s.run(100)
    rate = timer.lap(100)
    rep = timer.report()
    assert rep["steps"] == 100 and rate > 0
    assert rep["particle_steps_per_sec"] > 0
    assert rep.keys() == {"steps", "seconds", "steps_per_sec",
                          "particle_steps_per_sec"}
    assert rep["steps_per_sec"] == round(100 / timer.laps[0][1], 1)
    files = list(os.scandir(tmp_path / "tb"))
    assert len(files) == 1
    with open(files[0].path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "md" for e in events)
    with phase("noop"):
        pass
