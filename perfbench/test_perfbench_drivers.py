"""CPU rehearsals of each driver at a tiny size (the harness's look for a
chip skipped, the rest of a run driven as on the card), and the faults
that `correct` has to catch: a training step that leaves its state
unchanged, a step over half of its batch, a served answer altered where
it is produced, and served durations a fifth too long. The card's own
test of the controls is `test_perfbench_card.py`.

    python -m pytest perfbench -q
"""

import copy
import json
import os

import pytest
import torch

from perfbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2_147_483_659  # past 32 signed bits, as the driver's are


def _tiny(tmp_path, name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        conf = json.load(f)
    conf["model"].update(hidden_channels=32, filter_channels=64,
                         inter_channels=32, upsample_initial_channel=32,
                         n_layers=2)
    if conf["model"].get("gin_channels"):
        conf["model"]["gin_channels"] = 16
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


TRAIN = {"driver": "train", "batch": 2, "cycle_steps": 2, "audio_rms": 0.1,
         "buckets": [0, 1]}
SERVE = {"driver": "serve_open", "rate_per_s": 10.0, "max_batch": 8,
         "max_wait_ms": 4.0, "workers": 16, "sample": 8, "warm_s": 1.0,
         "texts": 24}


def _run(tmp_path, cell, config, workload, seconds=1.0, trace=False):
    """The cell's own workload (limits, weight overrides) at the tiny
    traffic `workload`."""
    with open(os.path.join(HERE, "workloads", f"{cell}.json")) as f:
        own = json.load(f)
    ctx = run.context(cell, SEED, seconds, trace, torch.device("cpu"),
                      config_path=_tiny(tmp_path, config),
                      workload=dict(own, **workload))
    return run.execute(ctx)


@pytest.mark.parametrize("cell,config", [("ljs_mb.train_b64", "ljs_mb"),
                                         ("uudb_ms.train_b32", "uudb_ms")])
def test_training_rehearsal_is_correct(tmp_path, cell, config):
    out = _run(tmp_path, cell, config, TRAIN)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_training_rehearsal_reports_its_layers(tmp_path):
    out = _run(tmp_path, "ljs_mb.train_b64", "ljs_mb", TRAIN, trace=True)
    assert out["correct"], out["checks"]
    assert "train_mfu" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _frozen_step(real):
    """A step that computes its losses and leaves the weights as they
    were."""
    def step(state, batch, draws=None):
        kept = [p.detach().clone() for p in state.net_g.parameters()] + [
            p.detach().clone() for p in state.net_d.parameters()]
        out = real(state, batch, draws)
        with torch.no_grad():
            for p, k in zip(list(state.net_g.parameters())
                            + list(state.net_d.parameters()), kept):
                p.copy_(k)
        return out
    return step


def _half_batch_step(real):
    """A step over the first half of its rows, its means over those."""
    def step(state, batch, draws=None):
        half = batch["x"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        draws = type(draws)(*(None if v is None else v[:half]
                              for v in draws))
        return real(state, batch, draws)
    return step


def _fault_past_the_first_signature(real):
    """A step that is right at the first signature it meets and over half
    of its batch at every later one."""
    first = []

    def step(state, batch, draws=None):
        first[:] = first or [batch["wav"].shape]
        if batch["wav"].shape == first[0]:
            return real(state, batch, draws)
        return _half_batch_step(real)(state, batch, draws)
    return step


@pytest.mark.parametrize("fault", [_frozen_step, _half_batch_step,
                                   _fault_past_the_first_signature])
def test_a_broken_training_step_is_not_correct(tmp_path, monkeypatch,
                                               fault):
    from mb_istft_vits_torch.train import step

    monkeypatch.setattr(step, "train_step", fault(step.train_step))
    out = _run(tmp_path, "ljs_mb.train_b64", "ljs_mb", TRAIN)
    assert not out["correct"], out["checks"]


def test_serving_rehearsal_is_correct(tmp_path):
    out = _run(tmp_path, "ljs_mb.serve_open", "ljs_mb", SERVE, seconds=2.0)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 20
    assert set(out["metrics"]) == {"serve_p95_ms", "serve_p50_ms",
                                   "setup_s"}


def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    """Every answer's first hop of samples negated where the module makes
    it."""
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    single, batched = SynthesisModule.synthesize, \
        SynthesisModule.synthesize_batch

    def alter(audio):
        audio = copy.copy(audio)
        audio[:256] = -audio[:256]
        return audio

    def synthesize(self, *a, **k):
        audio, t = single(self, *a, **k)
        return alter(audio), t

    def synthesize_batch(self, *a, **k):
        audios, t = batched(self, *a, **k)
        return [alter(x) for x in audios], t

    monkeypatch.setattr(SynthesisModule, "synthesize", synthesize)
    monkeypatch.setattr(SynthesisModule, "synthesize_batch",
                        synthesize_batch)
    out = _run(tmp_path, "ljs_mb.serve_open", "ljs_mb", SERVE, seconds=2.0)
    assert not out["correct"], out["checks"]


def test_a_wrong_duration_predictor_is_not_correct(tmp_path, monkeypatch):
    """The port's duration predictor's log-durations shifted by log(1.2):
    every token a fifth longer."""
    from mb_istft_vits_torch.models import duration

    real = duration.DurationPredictor.forward

    def forward(self, x, x_mask, *a, **k):
        return real(self, x, x_mask, *a, **k) + 0.1823 * x_mask

    monkeypatch.setattr(duration.DurationPredictor, "forward", forward)
    out = _run(tmp_path, "ljs_mb.serve_open", "ljs_mb", SERVE, seconds=2.0)
    assert not out["correct"], out["checks"]
    assert out["checks"]["frames_off"]["value"] > 0.5, out["checks"]
