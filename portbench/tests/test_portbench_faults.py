"""The comparison fails a broken program: a run with the chip look skipped
(on the CPU, at a small size, every cell's own limits) and the engine's
timed path broken underneath reads ``correct`` false, once for each fault
the cell can have.  One card, so no exchange between cards to leave out."""

import json
import time

import numpy as np
import pytest
from conftest import CPU_SIZE, REPO, SEED

from portbench import harness
from portbench.program import ResidentEngine

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# Cells whose stream carries state from batch to batch (XPSNR, motion).
STATEFUL = [c for c in CELLS if {"xpsnr", "vmaf"} & set(harness.load_cell(c)[1]["metrics"])]


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, t_start=time.perf_counter(), device="cpu", size=CPU_SIZE)


@pytest.mark.parametrize("cell", STATEFUL)
def test_state_left_unchanged(cell, monkeypatch):
    """The step hands back the state it was given, once the stream has one."""
    original = ResidentEngine._step

    def step(self, dev, spec, ref_frames, spec_dis, dis_frames, prev_ref, prev_blur):
        out, state = original(self, dev, spec, ref_frames, spec_dis, dis_frames, prev_ref, prev_blur)
        return out, (state if prev_ref is None and prev_blur is None else (prev_ref, prev_blur))

    monkeypatch.setattr(ResidentEngine, "_step", step)
    r = _run(cell)
    assert r["correct"] is False
    assert r["checks"]["xpsnr"]["value"] > 0 and r["checks"]["motion"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    """The second half of each batch's scores replaced by the mean of the first."""
    original = ResidentEngine._scores

    def scores(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        half = len(out) // 2
        for s in out[half:]:
            for k, v in s.to_dict().items():
                setattr(s, k, float(np.mean([getattr(t, k) for t in out[:half]])))
        return out

    monkeypatch.setattr(ResidentEngine, "_scores", scores)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    """Every device result of the step moved by 0.1% (integers by one)."""
    original = ResidentEngine._step

    def alter(t):
        if isinstance(t, dict):
            return {k: alter(v) for k, v in t.items()}
        return t * 1.001 if t.is_floating_point() else t + 1

    def step(self, *args, **kwargs):
        out, state = original(self, *args, **kwargs)
        return alter(out), state

    monkeypatch.setattr(ResidentEngine, "_step", step)
    assert _run(cell)["correct"] is False


def test_a_sound_run_passes():
    assert _run(CELLS[0])["correct"] is True
