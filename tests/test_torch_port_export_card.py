"""The exported serving artifact on a card: one artifact traced on the
CPU and served on the card, one traced on the card, each held to the
live module on the card at a seed and at the same frame bucket (the
card-traced one bit for bit; the CPU-traced one within one int16 step, as
the programs met the card's kernels only after the move); and the
artifact's graph replays bit for bit to its eager calls. Flagship
config at the tiny width of torch_port_data.py, random weights from a
seed. Needs a CUDA device and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_export_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.infer.export import export_serving, load_serving
from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from torch_port_data import write_tiny_config

TEXTS = ["həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn fˈɑːks."]
INT16_STEP = 1.0 / 32767.0


def _module(path, device):
    m = SynthesisModule(path, seed=0, device=device)
    m.TEXT_BUCKETS = (32, 64)
    m.FRAME_BUCKETS = (64, 128, 256)
    return m


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(live module on the card, {traced on: artifact served on the
    card})."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tmp_path_factory.mktemp("export_card")
    path = write_tiny_config(str(root))
    served = {}
    for dev in ("cpu", "cuda"):
        art = str(root / dev)
        export_serving(_module(path, dev), art)
        served[dev] = load_serving(art)  # onto the card by default
    return _module(path, "cuda"), served


def _live_at(live, served, text, **kw):
    live.FRAME_BUCKETS = tuple(
        served._buckets_for(len(served.text_to_ids(text)))[1])
    live._frames_per_token, live._ratio_observed = 3.0, False
    return live.synthesize(text, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("traced_on", ["cpu", "cuda"])
def test_artifact_on_the_card_equals_the_live_module(artifacts, traced_on):
    live, served = artifacts
    art = served[traced_on]
    assert art.device.type == "cuda"
    for text in TEXTS:
        want, tw = _live_at(live, art, text, seed=7)
        got, tg = art.synthesize(text, seed=7)
        assert tg["frame_bucket"] == tw["frame_bucket"]
        assert got.shape == want.shape and len(got) > 0
        err = float(np.abs(got - want).max())
        if traced_on == "cuda":
            assert err == 0.0
        else:
            assert err <= INT16_STEP + 1e-9
        again, _ = art.synthesize(text, seed=7)
        np.testing.assert_array_equal(again, got)


@pytest.mark.cuda
def test_artifact_replays_bit_equal_to_its_eager_calls(artifacts):
    """The artifact's requests run its probe and infer programs as CUDA
    graphs ("probe", TB) and ("infer", TB, FB), captured once; each is bit
    for bit the same request with the programs called directly and the
    knobs on the CPU, as the artifact served before its graph cache."""
    from mb_istft_vits_torch.infer.export import _scalar

    _, served = artifacts
    art = served["cuda"]
    for i, text in enumerate(TEXTS):
        got, tg = art.synthesize(text, seed=i)
        art._run = lambda key, program, *a: program(art.params, *a)
        art._knob = _scalar
        try:
            eager, te = art.synthesize(text, seed=i)
        finally:
            del art._run, art._knob
        assert tg["frame_bucket"] == te["frame_bucket"]
        np.testing.assert_array_equal(got, eager)
    names = {k[0] for k in art.graphs.keys()}
    assert names == {"probe", "infer"}
    captures = art.graphs.captures
    replays = art.graphs.replays
    art.synthesize(TEXTS[0], seed=0)
    assert art.graphs.captures == captures
    assert art.graphs.replays == replays + 2
