"""Each cell's protocol against its plain reference at a tiny size on the
CPU: the program passes; the control (the reference in TF32 in the
program's place) fails; and the run fails with the timed path broken
underneath, once for each fault an MD cell can have."""

import pytest
import torch

import bench_tiny


def _gaps(res):
    return {k: c["value"] for k, c in res["checks"].items()}


@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_program_passes_its_checks(cell):
    res = bench_tiny.run_tiny(cell)
    assert res["correct"] is True, _gaps(res)
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_control_fails_its_checks(cell):
    res = bench_tiny.run_tiny(cell, control=True)
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed, _gaps(res)


def _unchanged_step(monkeypatch):
    from mollytpu_torch.sim import integrators
    monkeypatch.setattr(integrators.VelocityVerlet, "step",
                        lambda self, sys, nb, aux, step_n, **kw: (sys, aux))


def _recompute_with(monkeypatch, change):
    from mollytpu_torch.sim import integrators
    original = integrators._recompute

    def broken(sys, neighbors, step_n, needs_virial):
        out = original(sys, neighbors, step_n, needs_virial)
        return {**out, "forces": change(out["forces"])}
    monkeypatch.setattr(integrators, "_recompute", broken)


def _half_left_out(monkeypatch):
    def change(f):
        keep = (torch.arange(f.shape[0], device=f.device) % 2 == 0)
        return torch.where(keep[:, None], f, torch.zeros_like(f))
    _recompute_with(monkeypatch, change)


def _one_force_altered(monkeypatch):
    def change(f):
        bump = torch.zeros_like(f)
        bump[0, 0] = 0.05 * float(torch.sqrt((f * f).sum(1).mean()))
        return f + bump
    _recompute_with(monkeypatch, change)


FAULTS = {"unchanged_step": _unchanged_step,
          "half_left_out": _half_left_out,
          "one_force_altered": _one_force_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """Either the checks fail, or the run stops before it prints a result
    (a stale list from atoms the broken forces send flying)."""
    FAULTS[fault](monkeypatch)
    try:
        res = bench_tiny.run_tiny(cell)
    except RuntimeError:
        return
    assert res["correct"] is False, _gaps(res)
