"""CPU tests of the benchmark's yardstick: the FLOP count, the corpus's
buckets and cycle, the latency percentile, the interval union, and that
nothing the benchmark runs loads JAX, the JAX package, or (in the plain
reference) the measured program.

    python -m pytest perfbench -q
"""

import ast
import json
import math
import os
import subprocess
import sys

import pytest

import torch

from perfbench.yardstick import corpus, flops, stats, trace, weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_flop_count_matches_the_recorded_count_at_jaxs_batch():
    """At JAX's synthetic batch (64 rows of 192 ids and 400 frames) the
    count plus the real half's input gradient through the discriminator
    in the generator step (which the port computes and the step does not
    need) equals `flops_analysis`'s recorded 10,015.9 GFLOP (PERF.md:
    FlopCounterMode over the port's step), to the 0.05 GFLOP the record
    was rounded to. Both count 2 operations a multiply-add of the
    same convolutions and products."""
    cfg = _config("ljs_mb")
    step = flops.step_flops(cfg, [(192, 400)] * 64)
    real_half = 64 * flops.discriminator()[0]
    assert abs(step + real_half - 10_015.9e9) <= 0.05e9


def test_flop_count_follows_each_rows_lengths():
    cfg = _config("ljs_mb")
    short, long = (flops.step_flops(cfg, [r]) for r in ((50, 100),
                                                         (100, 200)))
    both = flops.step_flops(cfg, [(50, 100), (100, 200)])
    assert both == pytest.approx(short + long)
    assert long > short


def test_ljspeech_rows_fall_into_the_trainers_buckets():
    rows = corpus.load_rows("ljs_train", "text", False, 1, 190)
    buckets = corpus.bucket_rows(rows, 256)
    kept = sum(len(v) for v in buckets.values())
    shares = [round(100 * s, 1) for _, s in corpus.shares(buckets, kept)]
    assert shares == [8.4, 10.0, 13.4, 16.9, 17.7, 17.5, 12.3, 3.9]
    order = corpus.cycle(buckets, 20)
    counts = [order.count(b) for b in range(8)]
    assert counts == [2, 2, 3, 3, 4, 4, 2, 1]
    assert corpus.steps_per_epoch(buckets, 64) == 199


def test_uudb_rows_are_mostly_short():
    rows = corpus.load_rows("uudb_train", "text_JP", True, 3, 190)
    buckets = corpus.bucket_rows(rows, 256)
    kept = sum(len(v) for v in buckets.values())
    assert len(buckets[0]) / kept > 0.9
    assert corpus.cycle(buckets, 20) == [0] * 10 + [1] + [0] * 9


def test_frozen_lengths_are_the_renderers():
    """The tables hold the port's renderer's length rule of each line."""
    from mb_istft_vits_torch.utils.corpus import (_plan, _plan_jp,
                                                  rendered_samples)

    with open(os.path.join(ROOT, "filelists",
                           "ljs_audio_text_train_filelist.txt.cleaned"),
              encoding="utf-8") as f:
        src = [line.rstrip("\n").split("|") for _, line in zip(range(40), f)]
    with open(os.path.join(HERE, "corpus", "ljs_train.txt"),
              encoding="utf-8") as f:
        table = [line.rstrip("\n").split("|", 1)
                 for _, line in zip(range(40), f)]
    for (path, text), (n, t) in zip(src, table):
        assert t == text
        assert int(n) == rendered_samples(text, os.path.basename(path),
                                          _plan, sr=22050)
    with open(os.path.join(ROOT, "filelists",
                           "uudb_audio_sid_text_train_filelist.txt"),
              encoding="utf-8") as f:
        path, sid, text = f.readline().rstrip("\n").split("|")
    with open(os.path.join(HERE, "corpus", "uudb_train.txt"),
              encoding="utf-8") as f:
        n = int(f.readline().split("|")[0])
    assert n == rendered_samples(text, f"{sid}_{os.path.basename(path)}",
                                 _plan_jp, sr=16000)


def test_text_ids_are_the_frontends():
    from mb_istft_vits_torch.text import frontend_ids

    for module, text in (("text", "ðə sˈiːkɹət sˈɜːvɪs, ænd"),
                         ("text_JP", "[ e Q t o ] sp s i: t o")):
        ids = corpus.text_ids(text, corpus.symbols(module),
                              module == "text_JP")
        assert list(ids) == frontend_ids(text, module, [], True, True)


def test_weight_overrides_set_their_leaves_and_refuse_other_names():
    leaves = [("dp.proj.weight", (1, 4, 1)), ("dp.proj.bias", (1,)),
              ("dec.conv_post.bias", (6,))]
    cpu = torch.device("cpu")
    p = weights.make(leaves, 7, cpu, 4, {"dp.proj.bias": 0.5,
                                         "dec.conv_post.bias": [[0, 2, 1.0]]})
    assert p["dp.proj.bias"].tolist() == [0.5]
    assert p["dec.conv_post.bias"][:2].tolist() == [1.0, 1.0]
    assert torch.equal(p["dp.proj.weight"],
                       weights.make(leaves, 7, cpu, 4)["dp.proj.weight"])
    with pytest.raises(KeyError):
        weights.make(leaves, 7, cpu, 4, {"dp.proj.bais": 0.5})


def test_percentile_counts_a_missing_request_above_every_latency():
    answered = [float(v) for v in range(1, 20)]
    assert stats.percentile(answered + [20.0], 95) == 19.0
    assert stats.percentile(answered + [None], 95) == 19.0
    assert math.isinf(stats.percentile(answered + [None, None], 95))
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_interval_union_counts_overlaps_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.merge(spans) == [(0, 15), (20, 30)]
    assert trace.covered(spans, 0, 100) == 25
    assert trace.covered(spans, 12, 22) == 5
    data = trace.TraceData(0, 40, [(s, e, "k") for s, e in spans], [])
    assert data.busy_s() == pytest.approx(25e-9)


FORBIDDEN = {"jax", "jaxlib", "flax", "mb_istft_vits_tpu"}


def _sources(*dirs):
    for d in dirs:
        for name in sorted(os.listdir(os.path.join(HERE, d))):
            if name.endswith(".py"):
                yield os.path.join(HERE, d, name)


def _imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in _sources(".", "drivers", "metrics", "reference",
                         "yardstick"):
        assert not set(_imported(path)) & FORBIDDEN, path


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for path in _sources("reference", "yardstick"):
        assert "mb_istft_vits_torch" not in set(_imported(path)), path


def test_a_run_loads_no_jax_module():
    """Everything a run imports, the port's drivers' modules included,
    by top-level name in a fresh interpreter."""
    code = (
        "import sys, importlib, os\n"
        "sys.argv = ['run.py']\n"
        "import perfbench.run as r\n"
        "for d in ('train', 'serve_open'):\n"
        "    importlib.import_module('perfbench.drivers.' + d)\n"
        "import mb_istft_vits_torch.train.step, "
        "mb_istft_vits_torch.infer.synthesis, "
        "mb_istft_vits_torch.serve.microbatch\n"
        "for n in os.listdir(os.path.join(r.HERE, 'metrics')):\n"
        "    if n.endswith('.py'):\n"
        "        r.reader(n[:-3])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert not loaded & FORBIDDEN
