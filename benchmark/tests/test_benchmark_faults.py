"""A run on the CPU with the timed path broken underneath comes out as not
correct, each through the number that the fault breaks: the tiny cells
(added from new files, conftest.py), with the harness's look for a card
skipped, sound (a well-formed result) and with each fault of
``harness/faults.py`` a cell can have: a step that returns its state
unchanged, half of the chunk left out, an answer altered where it is
produced, and half of the batch left out at the tracker (its poses
extrapolated). (One card per cell: no exchange between cards to leave
out.)"""

from __future__ import annotations

import json

import pytest

from harness import faults

CHUNKED = "tiny_eao.chunked_tiny"
LIVE = "tiny_eao.live_tiny"
SEED = 3000000019


def test_sound_chunked_run_is_well_formed(run_tiny):
    # no assertion on `correct`: the program's motion departs from the truth
    # on this seed as on most (PERF.md, Open questions); the front end is exact
    res, lines = run_tiny(CHUNKED, SEED, 6.0, trace=True)
    json.dumps(res)
    assert res["attempted"] == 24 and res["failed"] == 0
    assert res["work"]["frames"] == 24 and res["work"]["keyframes"] > 0
    assert res["checks"]["frontend_kp_diff"]["value"] == 0.0
    assert res["checks"]["frontend_desc_diff"]["value"] == 0.0
    assert res["metrics"]["passes_ms_per_frame.tiny"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_sound_live_run_is_well_formed(run_tiny):
    res, lines = run_tiny(LIVE, SEED, 4.0)
    assert res["work"]["frames"] == 12 and res["failed"] == 0
    assert res["checks"]["frontend_kp_diff"]["value"] == 0.0
    assert set(res["metrics"]) == {"fps", "setup_s"}   # frame_ms_p95 names its cells


@pytest.mark.parametrize("cell, fault, caught_by", [
    (CHUNKED, "stateless", "trajectory_err_share"),
    (CHUNKED, "coast", "motion_dir_err_deg"),
    (CHUNKED, "half_chunk", "frontend_kp_diff"),
    (CHUNKED, "altered", "frontend_kp_diff"),
    (LIVE, "stateless", "trajectory_err_share"),
    (LIVE, "coast", "motion_dir_err_deg"),
    (LIVE, "altered", "frontend_kp_diff"),
])
def test_faults_are_not_correct(run_tiny, monkeypatch, cell, fault, caught_by):
    res, lines = run_tiny(cell, SEED, 6.0,
                          patch=lambda d: faults.FAULTS[fault](d, monkeypatch.setattr))
    assert res["correct"] is False, lines
    json.dumps(res)                                   # the result line prints
    c = res["checks"][caught_by]
    assert c["value"] is None or c["value"] > c["limit"], lines
