"""The port's training data path against the JAX package's on the CPU:
the native wav reader and host spectrogram (and their plain versions),
the `.spec.npy` cache, `TextAudioDataset` and `BucketedBatcher` (the
host-spec collate, rank-strided epoch plans for 1, 2 and 4 replicas, the
global plan), `DeviceResidentFeeder` (batches equal to the host
batcher's, JAX's `corpus_bytes`), the prefetch of host-spec batches, and
the trainer CLI's --host-spec and --device-resident runs.

Tolerances: ids, lengths, plans and resident batches exact; host
spectrograms within 1e-5 of JAX's (f32 FFTs in another order), host-spec
batches within 1e-6.
"""

from __future__ import annotations

import inspect
import os
import re

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mb_istft_vits_tpu.config import DataConfig as JDataConfig
from mb_istft_vits_tpu.data import dataset as jdata
from mb_istft_vits_tpu.data.resident import DeviceResidentFeeder as JFeeder

from mb_istft_vits_torch.config import DataConfig
from mb_istft_vits_torch.data import (
    BucketedBatcher,
    DeviceResidentFeeder,
    TextAudioDataset,
    dataset,
    device_prefetch,
    native_audio,
    prefetch_epoch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILELIST = os.path.join(REPO, "filelists",
                        "ljs_audio_text_test_filelist.txt.cleaned")
BATCH = 2


def _texts(n):
    with open(FILELIST, encoding="utf-8") as f:
        return [line.rstrip("\n").split("|")[-1] for line in f][:n]


def _pcm(rng, samples):
    t = np.arange(samples) / 22050
    tone = np.sin(2 * np.pi * rng.uniform(90, 250) * t)
    return (3000 * tone + 800 * rng.randn(samples)).astype(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """14 seeded int16 wavs of 20-650 frames (several buckets) under a
    single-speaker and a 4-speaker filelist."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(21)
    single, multi = [], []
    for i, text in enumerate(_texts(14)):
        path = str(root / f"{i}.wav")
        wavfile.write(path, 22050, _pcm(rng, int(rng.randint(20, 650)) * 256
                                        + int(rng.randint(0, 256))))
        single.append(f"{path}|{text}")
        multi.append(f"{path}|{i % 4}|{text}")
    lists = {}
    for name, rows in (("single", single), ("multi", multi)):
        lists[name] = str(root / f"{name}.txt")
        with open(lists[name], "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
    return root, lists


def _clear_caches(root):
    for name in os.listdir(root):
        if name.endswith(".spec.npy"):
            os.remove(os.path.join(root, name))


# -- wavs and host spectrograms ------------------------------------------------


def test_native_load_wav_is_bit_exact_to_jax(tmp_path):
    rng = np.random.RandomState(3)
    paths = {"pcm16": (_pcm(rng, 5000), 22050),
             "float32": (rng.uniform(-1, 1, 3001).astype(np.float32), 16000),
             # stereo: the native reader declines, scipy reads it
             "stereo": (_pcm(rng, 4000).reshape(-1, 2), 22050)}
    assert native_audio.available()
    for name, (data, sr) in paths.items():
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, sr, data)
        before = dict(dataset.loader_paths)
        ours, ours_sr = dataset.load_wav(path)
        ref, ref_sr = jdata.load_wav(path)
        assert ours.dtype == ref.dtype == np.float32 and ours_sr == ref_sr
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, data.astype(np.float32))
        took = "wav_scipy" if name == "stereo" else "wav_native"
        assert dataset.loader_paths[took] == before.get(took, 0) + 1, name


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024),
                                           (512, 128, 400)])
def test_host_spectrogram_matches_jax(route, n_fft, hop, win):
    y = np.random.RandomState(4).uniform(-0.5, 0.5, 9000).astype(np.float32)
    fn = (native_audio.spectrogram if route == "native"
          else dataset.spectrogram_numpy)
    ours = fn(y, n_fft, hop, win)
    ref = jdata._spectrogram_host(y, n_fft, hop, win)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_spec_cache_is_written_read_back_and_leaves_no_temp_file(corpus):
    root, lists = corpus
    _clear_caches(root)
    cfg = DataConfig()
    ds = TextAudioDataset(lists["single"], cfg, 1234, None, False)
    item = ds[0]
    wav_path = ds.rows[0][0]
    cache = os.path.splitext(wav_path)[0] + ".spec.npy"
    assert os.path.exists(cache)
    assert not [n for n in os.listdir(root) if ".tmp." in n]
    np.testing.assert_array_equal(np.load(cache), item["spec"])
    assert item["spec"].shape == (len(item["wav"]) // 256, 513)
    # a second read takes the cache: no new spectrogram
    n_spec = dataset.loader_paths["spec_native"]
    np.testing.assert_array_equal(ds[0]["spec"], item["spec"])
    assert dataset.loader_paths["spec_native"] == n_spec
    # device-spec items carry no spec and write no cache
    _clear_caches(root)
    pcm = TextAudioDataset(lists["single"], cfg, device_spec=True)[0]
    assert "spec" not in pcm and not os.path.exists(cache)


@pytest.mark.parametrize("name", ["TextAudioDataset", "BucketedBatcher",
                                  "DeviceResidentFeeder"])
def test_data_classes_take_jax_positional_order(name):
    import mb_istft_vits_torch.data as port_data

    ours = getattr(port_data, name)
    ref = JFeeder if name == "DeviceResidentFeeder" else getattr(jdata, name)
    got = list(inspect.signature(ours).parameters)
    want = list(inspect.signature(ref).parameters)
    if name == "DeviceResidentFeeder":  # + the port's keyword-only device
        assert got == want + ["device"]
        assert inspect.signature(ours).parameters["device"].kind \
            is inspect.Parameter.KEYWORD_ONLY
    else:
        assert got == want
    ours_p = inspect.signature(ours).parameters
    for k, p in inspect.signature(ref).parameters.items():
        if p.default is inspect.Parameter.empty:
            continue
        mine, theirs = ours_p[k].default, p.default
        if isinstance(theirs, (tuple, list)):  # the bucket edges
            mine, theirs = tuple(mine), tuple(theirs)
        assert mine == theirs, k


# -- batches and plans ----------------------------------------------------------


@pytest.mark.parametrize("speakers", ["single", "multi"])
def test_host_spec_batches_match_jax(corpus, speakers):
    root, lists = corpus
    _clear_caches(root)
    n_spk = 4 if speakers == "multi" else 0
    ds = TextAudioDataset(lists[speakers], DataConfig(n_speakers=n_spk), 3)
    jds = jdata.TextAudioDataset(lists[speakers],
                                 JDataConfig(n_speakers=n_spk), 3)
    assert not ds.device_spec and not jds.device_spec
    assert ds.rows == jds.rows and ds.lengths == jds.lengths
    ours, ref = BucketedBatcher(ds, BATCH), jdata.BucketedBatcher(jds, BATCH)
    assert len(ours) == len(ref) > 2 and ours.boundaries == ref.boundaries
    # each package computes its own spectrograms and caches
    got_all = list(ours.iter_epoch(1))
    _clear_caches(root)
    want_all = list(ref.iter_epoch(1))
    for got, want in zip(got_all, want_all):
        assert sorted(got) == sorted(want)
        assert "spec" in got and got["wav"].dtype == np.float32
        assert got["wav"].shape[1] == got["spec"].shape[1] * 256
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            if got[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("num_replicas", [1, 2, 4])
def test_epoch_plans_match_jax_for_every_rank(corpus, num_replicas):
    _, lists = corpus
    ds = TextAudioDataset(lists["single"], DataConfig(), device_spec=True)
    jds = jdata.TextAudioDataset(lists["single"], JDataConfig(),
                                 device_spec=True)
    for shuffle in (True, False):
        for rank in range(num_replicas):
            ours = BucketedBatcher(ds, BATCH, num_replicas=num_replicas,
                                   rank=rank, shuffle=shuffle)
            ref = jdata.BucketedBatcher(jds, BATCH, num_replicas=num_replicas,
                                        rank=rank, shuffle=shuffle)
            assert len(ours) == len(ref)
            for epoch in (0, 3):
                plan = ours.epoch_batches(epoch)
                assert plan == ref.epoch_batches(epoch)
                assert len(plan) == len(ours)
                assert ours.epoch_batches_global(epoch) \
                    == ref.epoch_batches_global(epoch)
        # the global batch j is the ranks' j-th batches in rank order
        views = [BucketedBatcher(ds, BATCH, num_replicas=num_replicas,
                                 rank=r, shuffle=shuffle)
                 for r in range(num_replicas)]
        glob = views[0].epoch_batches_global(5)
        for j, (bi, idx) in enumerate(glob):
            assert idx == [i for v in views for i in v.epoch_batches(5)[j][1]]


def test_prefetch_carries_host_spectrograms(corpus):
    _, lists = corpus
    batcher = BucketedBatcher(TextAudioDataset(lists["single"], DataConfig()),
                              BATCH)
    want = list(batcher.iter_epoch(2))
    got = list(device_prefetch(prefetch_epoch(batcher, 2, 3),
                               device=torch.device("cpu")))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and "spec" in g
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


# -- the corpus held on the device -----------------------------------------------


@pytest.mark.parametrize("speakers", ["single", "multi"])
def test_resident_batches_equal_host_batches(corpus, speakers):
    _, lists = corpus
    n_spk = 4 if speakers == "multi" else 0
    ds = TextAudioDataset(lists[speakers], DataConfig(n_speakers=n_spk),
                          device_spec=True)
    batcher = BucketedBatcher(ds, BATCH)
    feeder = DeviceResidentFeeder(batcher, None, None, device="cpu")
    jds = jdata.TextAudioDataset(lists[speakers],
                                 JDataConfig(n_speakers=n_spk),
                                 device_spec=True)
    want_bytes = JFeeder.corpus_bytes(jdata.BucketedBatcher(jds, BATCH))
    assert DeviceResidentFeeder.corpus_bytes(batcher) == want_bytes
    assert feeder.nbytes == want_bytes
    for epoch in (0, 1):
        host = list(batcher.iter_epoch(epoch))
        resident = list(feeder.iter_epoch(epoch))
        assert len(resident) == len(host) == len(batcher)
        for g, w in zip(resident, host):
            assert sorted(g) == sorted(w)
            for k in w:
                assert torch.equal(g[k], torch.from_numpy(w[k])), k


def test_resident_feeder_refuses_host_spec_and_a_larger_mesh(corpus):
    _, lists = corpus
    host_spec = BucketedBatcher(TextAudioDataset(lists["single"],
                                                 DataConfig()), BATCH)
    with pytest.raises(ValueError, match="device-spec"):
        DeviceResidentFeeder(host_spec, device="cpu")
    pcm = BucketedBatcher(TextAudioDataset(lists["single"], DataConfig(),
                                           device_spec=True), BATCH)
    # one process feeds its own card: a mesh is one device per rank, and
    # this batcher has one rank
    with pytest.raises(ValueError, match="each rank"):
        DeviceResidentFeeder(pcm, ["cpu", "cpu"], device="cpu")
    DeviceResidentFeeder(pcm, [torch.device("cpu")], device="cpu")


# -- the trainer CLI's feeds --------------------------------------------------------


def test_cli_feeds(tmp_path, monkeypatch):
    """One step of each feed in this process: the default writes no
    .spec.npy (the validation set is PCM too), --host-spec writes one
    per row, --device-resident logs the pool's upload and size, and with
    both it warns and feeds from the host (JAX's lines)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_data import drop_checkpoints, write_tiny_dataset

    from mb_istft_vits_torch.train.__main__ import main

    cfg = write_tiny_dataset(str(tmp_path), eval_interval=1)
    monkeypatch.chdir(tmp_path)
    logs = {}
    for name, flags in (("pcm", []), ("resident", ["--device-resident"]),
                        ("host", ["--host-spec"]),
                        ("both", ["--host-spec", "--device-resident"])):
        assert main(["-c", cfg, "-m", name, "--max-steps", "1", "--device",
                     "cpu", *flags]) == 0
        with open(tmp_path / "logs" / name / "train.log") as f:
            logs[name] = f.read()
        caches = [n for n in os.listdir(tmp_path) if n.endswith(".spec.npy")]
        if name in ("pcm", "resident"):
            assert caches == [], name
        else:
            assert len(caches) == 6, name
    assert re.search(r"device-resident corpus: uploading ~[\d.]+ GB of "
                     r"bucket-padded pools", logs["resident"])
    assert re.search(r"device-resident corpus: 1 pools, [\d.]+ GB on cpu "
                     r"\(6 utterances\)", logs["resident"])
    assert "--device-resident requires device-spec feeding — falling back " \
           "to host feeding" in logs["both"]
    assert "device-resident corpus" not in logs["both"]
    for log in logs.values():
        assert re.search(r"step 1: \{", log)
    drop_checkpoints(tmp_path)
