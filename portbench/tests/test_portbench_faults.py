"""A whole run, its look for a card skipped (on the CPU, at a size the CPU
holds), with the timed path broken underneath: ``correct`` comes out
false for each fault a one-answer cell can have, and true unbroken.
(One chip, no exchange between chips: that fault has no place here.)"""
import dataclasses

import numpy as np
import pytest

from portbench.run import run_cell
from portbench.tests.smoke import smoke_cell
from repro_torch.serving.real_executor import RealModelExecutor

ORIG_PREFILL = RealModelExecutor.prefill_request


def _state_unchanged(monkeypatch):
    """The call leaves the slot's K/V as they were."""
    def splice(self, kv, slot, index):
        self.cache["index"] = max(self.cache["index"], int(index))
        self._host_len = max(self._host_len, int(index))
    monkeypatch.setattr(RealModelExecutor, "_splice", splice)


def _half_left_out(monkeypatch):
    """Half of the prompt left out of the prefill."""
    def prefill(self, req, prompt):
        half = len(prompt) // 2
        ORIG_PREFILL(self, dataclasses.replace(req, prompt_len=half),
                     np.asarray(prompt)[half:])
    monkeypatch.setattr(RealModelExecutor, "prefill_request", prefill)


def _answer_altered(monkeypatch):
    """The answer token altered where it is produced."""
    def prefill(self, req, prompt):
        ORIG_PREFILL(self, req, prompt)
        slot = self.slot_req.index(req.rid)
        self.slot_tokens[slot] = (self.slot_tokens[slot] + 1) \
            % self.cfg.vocab_size
    monkeypatch.setattr(RealModelExecutor, "prefill_request", prefill)


def _other_adapter(monkeypatch):
    """The request served on another adapter than its own."""
    def prefill(self, req, prompt):
        n = self._n_adapters()
        ORIG_PREFILL(self, dataclasses.replace(
            req, adapter_id=(req.adapter_id + 1) % n), prompt)
    monkeypatch.setattr(RealModelExecutor, "prefill_request", prefill)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "other_adapter": _other_adapter}


def _run(kind, seed=2**31 + 3):
    return run_cell(smoke_cell(kind), seed, 0.4, False, "cpu", t_start=0.0)


@pytest.mark.parametrize("kind", ["dense", "moe", "poisson"])
def test_sound_run_is_correct(kind):
    res = _run(kind)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 7 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(kind, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(kind)
    assert not res["correct"], (fault, res["checks"])
