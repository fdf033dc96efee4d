"""The flagship half of the port's `dryrun_multichip` on the CPU
(`parallel/dryrun.py`, the counterpart of `__graft_entry__.py:161-216`).

Four gloo CPU ranks take the tiny step, then the flagship
`ljs_mb_istft_vits` in bf16 on JAX's synthetic batch at t_spec 400 and
t_x 192, on both layouts JAX's code builds for four devices (data=2 x
model=2, then data=4), each layout's step body once (the CPU captures
nothing). The batch is cut from the config's 64 to 4, one row a replica
of the 1-D layout: four flagship ranks at 16 rows each are too much for
a test on the CPU. With MBIV_DRYRUN_FLAGSHIP=0 the half is skipped, as in
JAX. The layouts and the batch are held to JAX's code.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.models import Synthesizer
from mb_istft_vits_torch.parallel import dryrun

CUT_BATCH = 4  # the config's 64, cut (module docstring)


@pytest.fixture(scope="module")
def flagship():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MBIV_DRYRUN_FLAGSHIP", raising=False)
        return dryrun.dryrun_multichip(4, device="cpu", flagship_shape={
            "batch": CUT_BATCH})


def test_the_flagship_half_prints_jaxs_line_for_each_layout(flagship):
    """The tiny line, then one line a layout in JAX's words ("ran" where
    a card says "captured" and JAX "compiled")."""
    cfg = Config.from_json(dryrun.FLAGSHIP_CONFIG)
    g_params = sum(p.numel() for p in Synthesizer(cfg.model).parameters())
    tiny, *lines = flagship["lines"]
    assert tiny.startswith("dryrun_multichip(4): ok (data=2 x model=2, "
                           "gloo, step route graphs)")
    assert len(lines) == 2
    for line, kind in zip(lines, ("data=2 x model=2", "data=4")):
        assert re.fullmatch(
            rf"dryrun_multichip\(4\): flagship ljs_mb_istft_vits "
            rf"b{CUT_BATCH} bf16 t_spec=400 ran on {re.escape(kind)} "
            rf"\({g_params / 1e6:.1f}M G params; the step body once, "
            rf"nothing captured\)", line), line


def test_the_flagship_half_runs_both_layouts_on_the_cpu(flagship):
    """Each layout's ranks agree (checked by the dryrun) and hold their
    rows of the cut batch at JAX's frames and tokens; nothing is
    captured."""
    layouts = flagship["flagship"]
    assert [f["kind"] for f in layouts] == ["data=2 x model=2", "data=4"]
    assert [f["rows_per_rank"] for f in layouts] == [2, 1]
    for f in layouts:
        assert (f["batch"], f["t_spec"], f["t_x"]) == (CUT_BATCH, 400, 192)
        assert not f["captured"] and f["graphs_a_step"] is None
        assert f["pool_bytes"] == [None] * 4
    for rank in flagship["ranks"]:
        for f in rank["flagship"]:
            assert all(np.isfinite(v) for v in f["metrics"].values())


def test_mbiv_dryrun_flagship_0_skips_the_half(monkeypatch, capsys):
    monkeypatch.setenv("MBIV_DRYRUN_FLAGSHIP", "0")
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["flagship"] == [] and len(out["lines"]) == 1
    assert all(r["flagship"] is None for r in out["ranks"])
    assert "flagship" not in capsys.readouterr().out


@pytest.mark.parametrize("n,want", [
    (1, [(1, 1)]), (2, [(2, 1)]), (3, [(3, 1)]), (4, [(2, 2), (4, 1)]),
    (5, [(5, 1)]), (6, [(3, 2), (6, 1)]), (8, [(4, 2), (8, 1)])])
def test_layouts_are_jaxs(n, want):
    """JAX's: for even n >= 4 the 2-D n/2 x 2 mesh then the 1-D data=n
    one, else the 1-D one alone."""
    assert dryrun.layouts(n) == want


def test_the_flagship_batch_is_jaxs():
    """JAX's numpy draws (seed 0: the ids, then the PCM) and lengths."""
    cfg = Config.from_json(dryrun.FLAGSHIP_CONFIG)
    d, b, t_x, t_spec = cfg.data, 3, 192, 400
    rng = np.random.RandomState(0)
    t_wav = t_spec * d.hop_length + (d.filter_length - d.hop_length)
    x = rng.randint(1, cfg.model.n_vocab, size=(b, t_x)).astype(np.int32)
    wav = rng.randint(-16000, 16000, (b, t_wav, 1)).astype(np.int16)
    got = dryrun.flagship_batch(cfg, b, t_spec, t_x)
    assert torch.equal(got["x"], torch.from_numpy(x))
    assert torch.equal(got["wav"], torch.from_numpy(wav))
    assert got["x_lengths"].tolist() == [t_x] * b
    assert got["spec_lengths"].tolist() == [t_spec] * b
    assert got["wav_lengths"].tolist() == [t_spec * d.hop_length] * b
