"""The PyTorch port's Japanese frontend, configs and multi-speaker dataset
on the CPU, held against the JAX package (not against the absent
reference checkout): the symbol list element by element, the ids of every
row of the two Japanese training filelists, the mora tables on seeded
katakana, the pyopenjtalk cleaners' error, all eleven configs, and the
`path|sid|text` dataset and its collate. All exact."""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import pytest
from scipy.io import wavfile

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.config import DataConfig as JDataConfig
from mb_istft_vits_tpu.data.dataset import BucketedBatcher as JBatcher
from mb_istft_vits_tpu.data.dataset import TextAudioDataset as JDataset
from mb_istft_vits_tpu.text import jp as jjp

from mb_istft_vits_torch.config import Config, DataConfig
from mb_istft_vits_torch.data import BucketedBatcher, TextAudioDataset
from mb_istft_vits_torch.text import get_symbols, jp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILELISTS = ("uudb_audio_sid_text_train_filelist.txt",
             "csj_uudb_train_fine.txt")
CONFIGS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(REPO, "configs", "*.json")))


def _rows(name):
    with open(os.path.join(REPO, "filelists", name), encoding="utf-8") as f:
        return [line.rstrip("\n").split("|") for line in f if line.strip()]


def _katakana(seed, n=40):
    """Seeded katakana strings of moras from the JAX tables, with long
    vowels, spaces, sokuon and unknown characters among them."""
    rng = np.random.RandomState(seed)
    moras = sorted(jjp.TABLE) + sorted(jjp.TABLE2) + ["ー", " ", "ッ", "x"]
    return ["".join(rng.choice(moras, size=rng.randint(1, 25)))
            for _ in range(n)]


def test_jp_symbols_equal_jax():
    assert jp.symbols == jjp.symbols
    assert get_symbols("text_JP") == get_symbols("jp") == jjp.symbols
    assert jp.SPACE_ID == jjp.SPACE_ID
    assert len(jp.symbols) == 59  # n_vocab of every Japanese config


@pytest.mark.parametrize("filelist", FILELISTS)
def test_cleaned_text_to_sequence_matches_jax(filelist):
    rows = _rows(filelist)
    assert len(rows) == 2067 and all(len(r) == 3 for r in rows)
    for _, _, text in rows:
        ids = jp.cleaned_text_to_sequence(text)
        assert ids == jjp.cleaned_text_to_sequence(text), text
        assert jp.sequence_to_text(ids) == jjp.sequence_to_text(ids)


@pytest.mark.parametrize("fn", ["mora2phoneme", "mora2phoneme_compat",
                                "mora2ipa", "japanese_cleaners",
                                "text_to_sequence"])
def test_mora_tables_match_jax(fn):
    def call(mod, text):
        if fn == "mora2phoneme_compat":
            return mod.mora2phoneme(text, reference_compat=True)
        if fn == "text_to_sequence":
            return mod.text_to_sequence(text, ["japanese_cleaners"])
        return getattr(mod, fn)(text)

    for i, text in enumerate(_katakana(seed=len(fn))):
        assert call(jp, text) == call(jjp, text), (i, text)
    assert jp.Phonemizer("ipa")("キャット") == jjp.Phonemizer("ipa")("キャット")


@pytest.mark.parametrize("cleaner", ["openjtalk_cleaner",
                                     "japanese_cleaners_revised"])
def test_pyopenjtalk_cleaners_behave_as_jax(cleaner):
    """Without pyopenjtalk both packages raise the same error; with it
    they give the same phonemes."""
    def outcome(mod):
        try:
            return getattr(mod, cleaner)("こんにちは、世界。")
        except RuntimeError as e:
            return ("RuntimeError", str(e))

    assert outcome(jp) == outcome(jjp)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_parses_to_jax_fields(name):
    path = os.path.join(REPO, "configs", name)
    ours, ref = Config.from_json(path), JConfig.from_json(path)
    for part in ("model", "data", "train"):
        assert dataclasses.asdict(getattr(ours, part)) == \
            dataclasses.asdict(getattr(ref, part)), part
    assert ours.model.decoder_kind == ref.model.decoder_kind


def test_all_eleven_configs_are_covered():
    assert len(CONFIGS) == 11


def test_multispeaker_dataset_collates_sid_like_jax(tmp_path):
    """`path|sid|text` rows of the UUDB filelist (Japanese phonemes), with
    seeded int16 wavs: the same rows, lengths, batches and collated
    tensors as the JAX loader, sid [B] int32 among them."""
    rng = np.random.RandomState(3)
    rows = []
    for i, (_, sid, text) in enumerate(_rows(FILELISTS[0])[::150][:10]):
        path = str(tmp_path / f"{i}.wav")
        n = int(rng.randint(20, 500)) * 256 + int(rng.randint(0, 256))
        wavfile.write(path, 16000, (2000 * rng.randn(n)).astype(np.int16))
        rows.append(f"{path}|{sid}|{text}")
    # a row without a speaker column is skipped by both
    rows.append(str(tmp_path / "0.wav") + "|k o N n i t i w a")
    filelist = tmp_path / "list.txt"
    filelist.write_text("\n".join(rows) + "\n", encoding="utf-8")
    kw = dict(n_speakers=12, text_module="text_JP", sampling_rate=16000,
              text_cleaners=("japanese_cleaners",), max_text_len=800)
    ds = TextAudioDataset(str(filelist), DataConfig(**kw), seed=3,
                          device_spec=True)
    jds = JDataset(str(filelist), JDataConfig(**kw), seed=3,
                   device_spec=True)
    assert ds.rows == jds.rows and ds.lengths == jds.lengths
    assert len(ds) == 10 and len({r[1] for r in ds.rows}) > 3
    assert ds[0]["sid"] == jds[0]["sid"] == int(ds.rows[0][1])
    ours, ref = BucketedBatcher(ds, 2), JBatcher(jds, 2)
    assert len(ours) == len(ref) > 1
    sids = set()
    for epoch in (0, 1):
        assert ours.epoch_batches(epoch) == ref.epoch_batches(epoch)
        for got, want in zip(ours.iter_epoch(epoch), ref.iter_epoch(epoch)):
            assert sorted(got) == sorted(want) and "sid" in got
            for k in got:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            sids.update(got["sid"].tolist())
    assert len(sids) > 3
