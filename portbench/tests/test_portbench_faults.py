"""A run with the timed path broken underneath must come out not
correct: each fault a cell can have, planted in the program, with the
rest of the run driven as on the card (its look for a card skipped, the
program on its CPU route at a tiny size).  On one card there is no
exchange between cards to leave out."""
import pytest
import torch

from benchlib import harness

import _small

TRAIN = [w for w in _small.workloads() if w.startswith("fl-sync")]
SERVE = [w for w in _small.workloads(with_open=True)
         if w.startswith("serve")]


def _unchanged(monkeypatch):
    """A round that hands back the model it was given."""
    from repro_torch.core import fedavg
    orig = fedavg.RoundEngine._sync_step

    def step(self, params, state, *a, **kw):
        _, state2, loss = orig(self, params, state, *a, **kw)
        return params, state2, loss
    monkeypatch.setattr(fedavg.RoundEngine, "_sync_step", step)


def _half_batch(monkeypatch):
    """Every local step on the first half of its minibatch, its mean
    taken over that half."""
    from repro_torch.core import client
    orig = client.sgd_step

    def step(params, batch, *a, **kw):
        half = batch["x"].shape[1] // 2
        return orig(params, {k: v[:, :half] for k, v in batch.items()},
                    *a, **kw)
    monkeypatch.setattr(client, "sgd_step", step)


def _altered_answer(monkeypatch):
    """One forecast of every flush moved by 1 % of its consumer's range."""
    from repro_torch.serving import engine
    orig = engine.forecast_kwh

    def fwd(params, x, lo, hi, cfg):
        out = orig(params, x, lo, hi, cfg).clone()
        out[0, 0] += 0.01 * (hi - lo)[0, 0]
        return out
    monkeypatch.setattr(engine, "forecast_kwh", fwd)


def _half_flush(monkeypatch):
    """Only the first half of a flush's rows computed, the rest zero."""
    from repro_torch.serving import engine
    orig = engine.forecast_kwh

    def fwd(params, x, lo, hi, cfg):
        n = x.shape[0] // 2
        out = torch.zeros((x.shape[0], cfg.horizon), dtype=x.dtype)
        out[:n] = orig(params, x[:n], lo[:n], hi[:n], cfg)
        return out
    monkeypatch.setattr(engine, "forecast_kwh", fwd)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", TRAIN)
def test_training_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _small.run(_small.ctx(workload))
    assert not harness.judge(out.checks), out.checks


@pytest.mark.parametrize("fault", [_altered_answer, _half_flush],
                         ids=["answer_altered", "half_flush"])
@pytest.mark.parametrize("workload", SERVE)
def test_serving_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _small.run(_small.ctx(workload))
    assert not harness.judge(out.checks), out.checks


def test_unanswered_request_is_not_correct(monkeypatch):
    """A flush that drops the last request of its chunk."""
    from benchlib import serving
    orig = serving.Book.served

    def served(self, slot, stats, t, consumer_of):
        out = orig(self, slot, stats, t, consumer_of)
        if self.idx and len(self.idx[-1]) > 1:
            self.idx[-1], self.pred[-1] = self.idx[-1][:-1], self.pred[-1][:-1]
        return out
    monkeypatch.setattr(serving.Book, "served", served)
    out = _small.run(_small.ctx("serve-open.lstm-h64.p80"))
    assert not harness.judge(out.checks) and out.failed > 0
