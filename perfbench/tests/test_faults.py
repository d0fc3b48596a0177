"""A run with the timed path broken underneath comes out not correct: once
for each fault that the cells can have, the cache's writeback and inserts
among them. (One chip: no exchange between chips to leave out.) The harness's look for a card is skipped; the rest of
a run is driven on the CPU at test size."""

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

import cdlrm_tpu_torch.train.step as step_mod
import cdlrm_tpu_torch.train.trainer as trainer_mod
from cdlrm_tpu_torch.cache.master import VirtualMasterTables
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer


def run(kind, entry, **kw):
    return harness.run_cell(tiny.cell(kind, entry, **kw), 2**31 + 23, 1.0, False,
                            torch.device("cpu"))


# uniform ids into a cache of 2,500 sets: the second window's refill evicts
EVICTING = {"ids": "uniform", "cache_size": 2500}


def unchanged(factory):
    """A step that returns its state unchanged (the loss still computed)."""
    def make(*a, **k):
        fn = factory(*a, **k)

        def step(params, table, *args, **kw):
            saved = table.clone()
            out = fn(params, table, *args, **kw)
            table.copy_(saved)
            return (params, table) + tuple(out[2:])

        return step

    return make


@pytest.mark.parametrize("kind", ["cached", "fulltable"])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, kind):
    name = "make_cached_train_step" if kind == "cached" else "make_fulltable_train_step"
    monkeypatch.setattr(step_mod, name, unchanged(getattr(step_mod, name)))
    out = run(kind, "train")
    assert out["correct"] is False
    assert out["check"]["grad_gap"]["value"] > 0.5


@pytest.mark.parametrize("kind", ["cached", "fulltable"])
def test_half_of_the_batch_left_out(monkeypatch, kind):
    real = step_mod.compute_loss

    def half(z, t, *a, **k):
        n = z.shape[0] // 2
        return real(z[:n], t[:n], *a, **k)

    monkeypatch.setattr(step_mod, "compute_loss", half)
    out = run(kind, "train")
    assert out["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    factory = step_mod.make_cached_eval_step

    def make(*a, **k):
        fn = factory(*a, **k)

        def step(params, cache, *args):
            cache, p = fn(params, cache, *args)
            p = p.clone()
            p[7] += 1e-3
            return cache, p

        return step

    monkeypatch.setattr(step_mod, "make_cached_eval_step", make)
    out = run("cached", "score")
    assert out["correct"] is False


def test_a_loss_altered_where_it_is_produced(monkeypatch):
    factory = step_mod.make_cached_train_step

    def make(*a, **k):
        fn = factory(*a, **k)

        def step(*args, **kw):
            out = fn(*args, **kw)
            return tuple(out[:2]) + (out[2] * 1.01,) + tuple(out[3:])

        return step

    monkeypatch.setattr(step_mod, "make_cached_train_step", make)
    out = run("cached", "train")
    assert out["correct"] is False


def test_a_dropped_writeback(monkeypatch):
    monkeypatch.setattr(VirtualMasterTables, "writeback", lambda self, t, idxs, rows, avg=False: 0)
    out = run("cached", "train", **EVICTING)
    assert out["correct"] is False
    assert out["check"]["writeback_off"]["value"] > 0


def test_the_wrong_rows_written_back(monkeypatch):
    real = CachedDlrmTrainer._deferred_host

    def shifted(self, rows):
        return real(self, torch.roll(rows, 1, dims=0))

    monkeypatch.setattr(CachedDlrmTrainer, "_deferred_host", shifted)
    out = run("cached", "train", **EVICTING)
    assert out["correct"] is False
    assert out["check"]["writeback_off"]["value"] > 0


def test_an_inserted_row_altered(monkeypatch):
    real = trainer_mod.build_insert_plan
    seen = []

    def altered(spec, rows, dim):
        plan = real(spec, rows, dim)
        seen.append(1)
        if len(seen) == 2 and plan.insert_rows.shape[0]:  # the second window's
            plan.insert_rows[-1] += 1e-3
        return plan

    monkeypatch.setattr(trainer_mod, "build_insert_plan", altered)
    out = run("cached", "train", **EVICTING)
    assert out["correct"] is False
    assert out["check"]["insert_off"]["value"] > 0


def test_the_unbroken_runs_are_correct():
    for kind, entry in (("cached", "train"), ("fulltable", "train"), ("cached", "score")):
        out = run(kind, entry)
        assert out["correct"] is True, out["check"]
    out = run("cached", "train", **EVICTING)
    assert out["correct"] is True, out["check"]
    assert out["info"]["writeback_checked"]["evicted"] > 0
