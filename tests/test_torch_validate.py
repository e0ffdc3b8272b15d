"""Opt-in debug validation of the port (SCRAPPIE_TORCH_VALIDATE=1,
scrappie_torch/utils/validate.py): the counterparts of
tests/test_validate.py's six tests. Finiteness and bounds checks attach to
layer outputs when enabled, cost nothing when disabled, and the engine
skips a poisoned read instead of failing the batch. On the CPU a check is
immediate; a CUDA tensor's check is read by raise_pending, which
chip_smoke.py's phase validate exercises on the card."""

import numpy as np
import pytest
import torch

from scrappie_torch.utils import validate as tv
from scrappie_torch.utils.validate import (ValidationError, checked, enabled,
                                           set_enabled)

torch.set_num_threads(1)


@pytest.fixture
def validation_on():
    set_enabled(True)
    yield
    set_enabled(None)
    tv._pending.clear()


def test_disabled_is_identity():
    set_enabled(False)
    try:
        x = np.array([np.nan, 1.0])
        assert checked(x, "x") is x  # no check, no copy
        t = torch.tensor([np.nan])
        assert checked(t, "t") is t
    finally:
        set_enabled(None)


def test_env_var_controls(monkeypatch):
    set_enabled(None)
    monkeypatch.setenv("SCRAPPIE_TORCH_VALIDATE", "1")
    assert enabled()
    monkeypatch.setenv("SCRAPPIE_TORCH_VALIDATE", "0")
    assert not enabled()
    monkeypatch.delenv("SCRAPPIE_TORCH_VALIDATE")
    assert not enabled()


@pytest.mark.parametrize("wrap", [np.asarray, torch.tensor])
def test_host_checks(validation_on, wrap):
    x = wrap(np.ones(4))
    assert checked(x, "ok", lo=0.0, hi=2.0) is x
    with pytest.raises(ValidationError, match="non-finite"):
        checked(wrap(np.array([1.0, np.inf])), "bad")
    with pytest.raises(ValidationError, match="min"):
        checked(wrap(np.array([-3.0, 0.0])), "bad", lo=-1.0)
    with pytest.raises(ValidationError, match="max"):
        checked(wrap(np.array([0.0, 3.0])), "bad", hi=1.0)
    with pytest.raises(ValidationError, match="empty"):
        checked(wrap(np.zeros(0)), "bad")


def test_pending_checks_raise_together(validation_on):
    """What raise_pending reports for the checks a CUDA tensor records
    (their three numbers; here made on the CPU): every failure in one
    ValidationError, the record cleared."""
    tv.raise_pending()  # clean so far
    tv._pending.extend([
        ("tanh", -1.0, 1.0, (3,), torch.tensor([0.0, -0.5, 0.5])),
        ("conv", None, None, (2, 2), torch.tensor([1.0, 0.0, 0.0])),
        ("softmax", 0.0, 1.0, (4,), torch.tensor([0.0, 0.0, 1.5])),
    ])
    with pytest.raises(ValidationError, match="conv: 1/4 non-finite.*softmax: max"):
        tv.raise_pending()
    tv.raise_pending()  # cleared


def test_forward_validates(validation_on):
    from scrappie_torch.models import registry
    from scrappie_torch.models.convert import params_from_numpy
    from scrappie_torch.models.forward import rgrgr_posterior

    params = params_from_numpy(registry.load_params("rgrgr_r94"), "cpu")
    sig = np.random.default_rng(0).standard_normal((2, 500, 1)).astype(np.float32)
    with torch.inference_mode():
        lp = rgrgr_posterior(params, torch.from_numpy(sig), stride=5)
        assert torch.isfinite(lp).all()
        tv.raise_pending()
        bad = sig.copy()
        bad[0, 100, 0] = np.nan
        # a CPU tensor's check is immediate, at the first layer it reaches
        with pytest.raises(ValidationError, match="rgrgr.conv: .*non-finite"):
            rgrgr_posterior(params, torch.from_numpy(bad), stride=5)


def test_engine_skips_poisoned_read(validation_on):
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.train.simulate import SquiggleSimulator
    from scrappie_torch.types import RawSignal

    sim = SquiggleSimulator(seed=3, device="cpu")
    good, _, _ = sim.simulate_read(200)
    poisoned, _, _ = sim.simulate_read(200)
    poisoned = poisoned.copy()
    poisoned[50:60] = np.nan
    engine = BasecallEngine("rgrgr_r94", chunk_len=1500, overlap=300,
                            batch_size=2, device="cpu")
    results = engine.basecall_signals(
        [RawSignal(good, uuid="good"), RawSignal(poisoned, uuid="bad")],
        trim_start=0, trim_end=0, varseg_thresh=0.0)
    assert results[0].sequence  # good read basecalled
    assert results[1].sequence is None  # poisoned read skipped, not fatal
