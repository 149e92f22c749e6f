"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (device "cpu") and the rest of
a run is driven at a tiny size. Each fault a cell can have: a step that
returns its state unchanged, half of the batch (the transmitters) left
out with the rest standing in for it, and an answer altered where it is
produced. Every cell runs on one card, so no exchange between cards can
be left out."""

import time

import numpy as np
import pytest
import torch

import harness
import program
from waveforminversionust_tpu_torch.data import synthesize
from waveforminversionust_tpu_torch.fwi import optimizers


def run(root, cell):
    return harness.run(root, cell, 2**31 + 99, 1.0, False, "cpu",
                       time.perf_counter())


def half_batch(solve):
    """The first half of the right-hand sides solved, copied over the
    second half: the batch's mean taken over the half that ran."""
    def broken(*args, **kw):
        out = solve(*args, **kw)
        u = out[0] if isinstance(out, tuple) else out
        h = u.shape[0] // 2
        u = torch.cat([u[:h], u[:u.shape[0] - h]])
        return (u,) + tuple(out[1:]) if isinstance(out, tuple) else u
    return broken


def frozen_step(make_step):
    """The CG state (slowness, gradient, direction) handed back unchanged.
    The factor the step built goes on, as the solver's cache, so that a
    frozen-factor run reaches its stale iterations and its comparison."""
    def broken(*args, **kw):
        step = make_step(*args, **kw)

        def s(carry, it, local):
            new, metrics = step(carry, it, local)
            return carry._replace(factor=new.factor), metrics
        return s
    return broken


def altered_frame(invert):
    """One pixel of the second live frame, and of the result, off by
    1 m/s."""
    def broken(ds, **kw):
        cb = kw.get("live_callback")

        def alter(v):
            v = v.copy()
            v[v.shape[0] // 2, v.shape[1] // 2] += 1.0
            return v

        if cb is not None:
            def wrapped(stage, f, it, vel, m):
                cb(stage, f, it, alter(vel) if it == 2 else vel, m)
            kw["live_callback"] = wrapped
        res = invert(ds, **kw)
        return res._replace(velocity=alter(res.velocity))
    return broken


def altered_row(synth):
    """One transmitter's recorded row 0.1% off."""
    def broken(*args, **kw):
        ds = synth(*args, **kw)
        rec = ds.rec_data.copy()
        rec[3] *= np.float32(1.001)
        return ds._replace(rec_data=rec)
    return broken


@pytest.mark.parametrize("cell", ["tiny.live", "tiny.frozen"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_inversion_faults_are_not_correct(tiny_tree, monkeypatch, fault, cell):
    if fault == "unchanged":
        monkeypatch.setattr(optimizers, "make_cg_step",
                            frozen_step(optimizers.make_cg_step))
    elif fault == "half_batch":
        monkeypatch.setattr(optimizers, "helmholtz_operator_solve",
                            half_batch(optimizers.helmholtz_operator_solve))
    else:
        monkeypatch.setattr(program, "invert_dataset",
                            altered_frame(program.invert_dataset))
    result, lines = run(tiny_tree, cell)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_synthesis_faults_are_not_correct(tiny_tree, monkeypatch, fault):
    if fault == "unchanged":
        monkeypatch.setattr(synthesize, "solve_helmholtz",
                            lambda vel, src, *a, **k: (src, None))
    elif fault == "half_batch":
        monkeypatch.setattr(synthesize, "solve_helmholtz",
                            half_batch(synthesize.solve_helmholtz))
    else:
        monkeypatch.setattr(program, "synthesize_ring_dataset",
                            altered_row(program.synthesize_ring_dataset))
    result, lines = run(tiny_tree, "tinysim.shots")
    assert result["correct"] is False, lines
