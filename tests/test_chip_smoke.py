"""chip_smoke.py on the CPU: it refuses to report a result, and its phases
run end to end at tiny sizes (the full sizes run on the card)."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "not 'gpu'" in out.stderr


def test_device_phase_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="'cpu'"):
        chip_smoke.phase_device()


def test_anchor_phase_cbf_qp_subset():
    rows = chip_smoke.phase_anchors(mpc_tags=(), limit=3)
    assert set(rows) == {"c1", "c4c", "c4d", "c5"}
    assert all(v < 1e-3 for v in rows.values())


def test_flagship_phase_tiny_batch():
    out = chip_smoke.phase_flagship(batch=16, n_ref=16)
    assert out["dev"][0] < 5e-2


def test_kernel_phase_qp_interpret():
    rows = chip_smoke.phase_kernels(cases=(("cbf_qp_du", 16),), rounds=1,
                                    interpret=True)
    assert rows[("cbf_qp_du", 16)]["dev"] < 1e-3


def test_fleet_phase_tiny():
    out = chip_smoke.phase_fleet(total=16, chunks=30)
    assert out["min_clearance"] > 0.0 and out["backup_steps"] > 0


def test_wrapper_phase_short_loops():
    """A checked case and the reported-only known failure both run; a
    short loop reaches no waypoint, so only the "safe" requirement holds."""
    from safe_control_tpu.core.spec import (
        DOUBLE_INTEGRATOR_2D, DYNAMIC_UNICYCLE_2D,
    )

    rows = chip_smoke.phase_wrapper(
        cases=((DOUBLE_INTEGRATOR_2D, "cbf_qp", None, "safe", 0.5),
               (DYNAMIC_UNICYCLE_2D, "mpc_cbf", 10, "known", 0.5)))
    assert rows[(DOUBLE_INTEGRATOR_2D, "cbf_qp", None)]["steps"] == 10
    assert rows[(DYNAMIC_UNICYCLE_2D, "mpc_cbf", 10)]["clearance"] > 0.25
    with pytest.raises(chip_smoke.SmokeFailure, match="not all reached"):
        chip_smoke.phase_wrapper(
            cases=((DOUBLE_INTEGRATOR_2D, "cbf_qp", None, "all", 0.2),))


def test_wrapper_cases_bound_their_loops():
    """Every case of phase (e) stops within its simulated time, and the
    DU cbf_qp loop, held to safety only, runs long enough to show its stop
    (by step 200 on the reference geometry)."""
    for model, algo, horizon, require, tf in chip_smoke.WRAPPER_CASES:
        assert require in ("all", "safe", "known") and 0 < tf <= 100.0
        if require == "safe":
            assert tf / chip_smoke.DT >= 200


def test_sharded_fleet_phase_shields_fire():
    """Four virtual CPU devices: the sharded fleet matches one device over
    enough chunks that the shields take backup steps."""
    dx = chip_smoke.phase_sharded_fleet(4, total=64, chunks=20)
    assert dx <= 1e-3


def test_sharded_flagship_phase_tiny():
    assert chip_smoke.phase_sharded_flagship(4, per_device=4) <= 5e-3


@pytest.mark.parametrize("argv, ran", [
    ([], ["phase_anchors", "phase_flagship", "phase_kernels",
          "phase_wrapper", "phase_fleet"]),
    (["--four"], ["phase_sharded_flagship", "phase_sharded_fleet",
                  "phase_sharded_sweep"]),
])
def test_main_runs_phases_then_prints_verdict(argv, ran, monkeypatch, capsys):
    """main runs its phases in order, times each, and prints the verdict
    as its last line (phases stubbed: the real ones run on the card)."""
    called = []
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: dict(
        platform="gpu", kind="stub", count=4))
    for name in ran:
        stub = lambda name=name: called.append(name)
        stub.__name__ = name
        monkeypatch.setattr(chip_smoke, name, stub)
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert called == ran
    assert [ln.split(":")[0] for ln in lines[:-1]] == ran
    assert json.loads(lines[-1]) == {"ok": True, "device": dict(
        platform="gpu", kind="stub", count=4)}


def test_check_raises_instead_of_printing():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")
