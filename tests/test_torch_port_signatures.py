"""JAX's positional calls on the port.

`test_positional_parameters_match_jax` walks every module that both
packages have and, for each public function and class the JAX module
defines, requires the port's same-named counterpart to take JAX's
positional parameters in JAX's order (constructors and same-named
methods too; a flax module's `__call__` is the port's `forward`). Port-only
extras are keyword-only. What the port carries under another name, or
not at all, is in `RENAMED`, and the signatures that differ on purpose
are in `SIGNATURE_RULINGS`; each entry gives its reason (ROADMAP.md,
"Known differences" and Queue 1's rulings). Three rules hold for every
module: dropout follows `torch.nn.Module.train()` / `eval()`, so JAX's
`train` argument is dropped where the port has none; a torch module takes
its input width first (`in_channels` or `channels`), which flax infers
from the input; and a constructor that forwards `*args` is read from the
class that defines the parameters.

`test_exports_match_jax` diffs the two packages' `__init__` exports
against the same allow-list, and `test_jax_positional_call` makes each
repaired JAX positional call on both packages and compares the results
(f32 max-abs <= 1e-4; alignments, ids and shard rows exact).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_port_common import assert_close, cl, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "mb_istft_vits_tpu", "mb_istft_vits_torch"

# JAX public definitions the port has under another name or not at all
RENAMED = {
    "dsp.resample.resample_poly_jax":
        "a traced-JAX spelling of `resample_poly`, which the port has on "
        "torch (PR 8)",
    "dsp.stft.istft_riq":
        "the framed-DFT iSTFT's matmul form for XLA; the port's `istft` is "
        "`torch.istft`",
    "dsp.stft.overlap_add":
        "the framed-DFT iSTFT's overlap-add for XLA; `torch.istft` does it",
    "nn.layers.Conv2dP":
        "the discriminator's 2-D conv; the port's is `nn.layers.Conv2d`",
    "nn.layers.normal_init":
        "a flax initializer; torch initialises in place (`nn.init.normal_`)",
    "ops.mas.maximum_path_numpy":
        "JAX's numpy test oracle; the port's twin is `maximum_path_plain`",
    "parallel.mesh.batch_sharding":
        "a jax `NamedSharding`; `shard_batch` places the rows itself",
    "parallel.mesh.replicated_sharding":
        "a jax `NamedSharding`; DDP keeps the weights replicated",
    "parallel.tp.opt_state_shardings":
        "FSDP2's AdamW moments are DTensors of their parameter's placement",
    "train.checkpoint.save_checkpoint":
        "Orbax; the port writes reference `.pth` pairs: `checkpoint.save`",
    "train.checkpoint.wait_for_pending_checkpoint":
        "Orbax's asynchronous save; `checkpoint.save` is synchronous",
    "train.checkpoint.prune_checkpoints": "`checkpoint.prune`",
    "train.checkpoint.record_best_checkpoint": "`checkpoint.record_best`",
    "train.checkpoint.best_checkpoint_step": "`checkpoint.best_step`",
    "train.checkpoint.latest_checkpoint_step": "`checkpoint.latest_step`",
    "train.checkpoint.load_checkpoint":
        "an Orbax restore; `checkpoint.resume`",
    "train.checkpoint.load_generator_params":
        "`weights.load_generator_pth` (a `.pth` is the port's own format)",
    "train.checkpoint.import_torch_generator":
        "the port loads a `.pth` as it is (`weights.load_generator_pth`)",
    "train.checkpoint.export_torch_generator":
        "the port's state dict is the `.pth`; `weights.state_dict_from_jax` "
        "maps a JAX tree",
    "train.checkpoint.import_torch_discriminator":
        "its inverse is `weights.discriminator_state_dict_from_jax`",
    "train.step.LeafAdamState": "optax state; `torch.optim.AdamW` keeps its own",
    "train.step.flat_adamw": "an optax transform; `make_optimizer`",
    "train.step.leaf_adamw": "an optax transform; `make_optimizer`",
    "train.step.make_optimizers": "`make_optimizer`, once a net",
    "train.step.make_train_step":
        "two jitted programs; the port's eager step is `train_step`",
    "train.step.retime_opt_state": "`checkpoint.snap_to_epoch`",
}

# definitions both packages have whose positional parameters differ
SIGNATURE_RULINGS = {
    "nn.layers.Conv1d":
        "torch.nn.Conv1d's order (in, out, kernel, stride, padding, ...)",
    "nn.layers.ConvTranspose1d": "torch.nn.ConvTranspose1d's order",
    "train.step.TrainState":
        "holds the modules and torch optimizers, not parameter pytrees",
    "train.step.create_train_state":
        "(cfg, device, seed): torch builds the weights from the config "
        "alone, so JAX's example batch has no role; the key is an int seed",
    "parallel.tp.param_shardings":
        "(net, mesh, axis_name): the module that holds the parameters "
        "stands in the param tree's slot; returns {name: dim}",
}

INPUT_WIDTH = ("in_channels", "channels")


def _shared_modules():
    """Dotted module names (relative to the package; "" is the top) that
    both packages have, from their files."""
    def names(pkg):
        out = set()
        root = os.path.join(REPO, pkg)
        for dirpath, _, files in os.walk(root):
            rel = os.path.relpath(dirpath, root).replace(os.sep, ".")
            rel = "" if rel == "." else rel
            for f in files:
                if f.endswith(".py") and f != "__main__.py":
                    stem = f[:-3]
                    out.add(rel if stem == "__init__"
                            else f"{rel}.{stem}".lstrip("."))
        return out
    return sorted(names(JAX_PKG) & names(PORT_PKG))


MODULES = _shared_modules()


def _import(pkg, rel):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def _positional(fn):
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return None
    return [p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _ctor(cls):
    """Constructor parameters: a flax module's fields, else the first
    `__init__` in the MRO that names its parameters."""
    if issubclass(cls, fnn.Module):
        return [f.name for f in dataclasses.fields(cls)
                if f.name not in ("parent", "name")]
    names = _positional(cls)
    if names is not None:
        return names
    for klass in cls.__mro__:
        if "__init__" in vars(klass):
            names = _positional(vars(klass)["__init__"])
            if names is not None:
                return names[1:]
    return None


def _drop_self(names, fn):
    return names[1:] if names and not isinstance(fn, staticmethod) \
        and names[0] in ("self", "cls") else names


def _defs(mod):
    return {k: v for k, v in vars(mod).items() if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def _differs(jax_names, port_names, torch_module):
    if jax_names is None or port_names is None:
        return False
    if "train" in jax_names and "train" not in port_names:
        jax_names = [p for p in jax_names if p != "train"]
    if torch_module and port_names[:1] and port_names[0] in INPUT_WIDTH:
        return port_names[1:] != jax_names and port_names != jax_names
    return port_names != jax_names


def _compare(rel, name, ja, po):
    """The mismatches of one definition: [(what, jax, port)]."""
    out = []
    key = f"{rel}.{name}"
    if inspect.isfunction(ja):
        if _differs(_positional(ja), _positional(po), False):
            out.append((key, _positional(ja), _positional(po)))
        return out
    flax_mod = issubclass(ja, fnn.Module)
    torch_mod = issubclass(po, torch.nn.Module)
    if _differs(_ctor(ja), _ctor(po), torch_mod):
        out.append((key, _ctor(ja), _ctor(po)))
    for meth, fa in vars(ja).items():
        if meth.startswith("_") and meth != "__call__" or meth == "setup":
            continue
        fa_fn = fa.__func__ if isinstance(fa, (staticmethod, classmethod)) \
            else fa
        if not inspect.isfunction(fa_fn):
            continue
        pmeth = "forward" if flax_mod and meth == "__call__" else meth
        fp = inspect.getattr_static(po, pmeth, None)
        if fp is None:
            continue
        fp_fn = fp.__func__ if isinstance(fp, (staticmethod, classmethod)) \
            else fp
        if not inspect.isfunction(fp_fn):
            continue
        a = _drop_self(_positional(fa_fn), fa)
        b = _drop_self(_positional(fp_fn), fp)
        if _differs(a, b, False):
            out.append((f"{key}.{meth}", a, b))
    return out


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r or "<top>")
def test_positional_parameters_match_jax(rel):
    ja_mod, po_mod = _import(JAX_PKG, rel), _import(PORT_PKG, rel)
    missing, mismatched = [], []
    for name, ja in sorted(_defs(ja_mod).items()):
        key = f"{rel}.{name}"
        po = getattr(po_mod, name, None)
        if po is None:
            if key not in RENAMED:
                missing.append(key)
            continue
        if key in SIGNATURE_RULINGS:
            continue
        mismatched += _compare(rel, name, ja, po)
    assert not missing, f"no counterpart and no ruling: {missing}"
    assert not mismatched, "positional parameters differ (what, jax, " \
        f"port): {mismatched}"


@pytest.mark.parametrize("key", sorted(RENAMED) + sorted(SIGNATURE_RULINGS))
def test_every_ruling_names_a_real_difference(key):
    """An allow-list entry that no longer applies must go."""
    rel, name = key.rsplit(".", 1)
    ja = getattr(_import(JAX_PKG, rel), name)
    po = getattr(_import(PORT_PKG, rel), name, None)
    if key in RENAMED:
        assert po is None, f"{key} exists in the port: drop its ruling"
    else:
        assert po is not None and _compare(rel, name, ja, po), \
            f"{key} matches JAX now: drop its ruling"


SUBPACKAGES = sorted({m for m in MODULES
                      if os.path.isdir(os.path.join(REPO, JAX_PKG,
                                                    *m.split(".")))})


@pytest.mark.parametrize("rel", SUBPACKAGES, ids=lambda r: r or "<top>")
def test_exports_match_jax(rel):
    """Every name a JAX `__init__` exports (submodules aside) is exported
    by the port's, or has a ruling under its defining module."""
    def exported(mod):
        return {k for k, v in vars(mod).items() if not k.startswith("_")
                and not isinstance(v, types.ModuleType)}

    ja, po = _import(JAX_PKG, rel), _import(PORT_PKG, rel)
    ruled = {k.rsplit(".", 1)[1] for k in RENAMED}
    missing = sorted(exported(ja) - exported(po) - ruled)
    assert not missing, f"{rel or '<top>'} lacks {missing}"


# -- each repaired JAX positional call, on both packages ------------------------


def _wav(seed, b=2, n_samples=700):
    return np.random.RandomState(seed).randn(b, n_samples).astype(
        np.float32) * 0.3


def _stft_modules():
    # the modules, not the functions that `dsp/__init__` exports as `stft`
    return _import(JAX_PKG, "dsp.stft"), _import(PORT_PKG, "dsp.stft")


def _stft(pad_mode):
    jax_stft, port_stft = _stft_modules()

    y = _wav(1)
    ref = jax_stft.stft(jnp.asarray(y), 64, 16, 48, True, pad_mode)
    ours = port_stft.stft(t(y), 64, 16, 48, True, pad_mode)
    for o, r in zip(ours, ref):
        assert_close(n(o), np.asarray(r), what=pad_mode)


def _stft_magnitude():
    jax_stft, port_stft = _stft_modules()

    y = _wav(2)
    for args in ((True, "constant", 1e-7), (True, "reflect"), (False,)):
        ref = jax_stft.stft_magnitude(jnp.asarray(y), 64, 16, 64, *args)
        ours = port_stft.stft_magnitude(t(y), 64, 16, 64, *args)
        assert_close(n(ours), np.asarray(ref), what=str(args))


def _stft_refuses_other_pad_modes():
    port_stft = _stft_modules()[1]
    with pytest.raises(ValueError, match="symmetric"):
        port_stft.stft(t(_wav(3)), 64, 16, 64, True, "symmetric")


def _make_lr_schedule():
    from mb_istft_vits_tpu.config import Config as JConfig
    from mb_istft_vits_tpu.train.step import make_lr_schedule as jax_lr

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.train.step import make_lr_schedule

    path = os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")
    jcfg, cfg = JConfig.from_json(path, n_vocab=10), Config.from_json(
        path, n_vocab=10)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, steps_per_epoch=3, lr_decay=0.5))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_epoch=3, lr_decay=0.5))
    ours, ref = make_lr_schedule(cfg), jax_lr(jcfg)
    for step in range(10):
        assert abs(ours(step) - float(ref(jnp.asarray(step)))) <= \
            1e-6 * ours(0)


def _mas_problem():
    rng = np.random.RandomState(4)
    b, t_y, t_x = 3, 12, 5
    neg_cent = rng.randn(b, t_y, t_x).astype(np.float32)
    mask = np.zeros((b, t_y, t_x), np.float32)
    for i, (ty, tx) in enumerate([(12, 5), (9, 3), (5, 5)]):
        mask[i, :ty, :tx] = 1.0
    return neg_cent, mask


def _maximum_path():
    from mb_istft_vits_tpu.ops import mas as jax_mas

    from mb_istft_vits_torch.ops import mas

    neg_cent, mask = _mas_problem()
    ref = np.asarray(jax_mas.maximum_path(jnp.asarray(neg_cent),
                                          jnp.asarray(mask), False))
    for slot in ("auto", False):
        ours = mas.maximum_path(t(neg_cent), t(mask), slot)
        assert np.array_equal(n(ours), ref), slot


def _maximum_path_true_needs_the_card():
    from mb_istft_vits_torch.ops import mas

    neg_cent, mask = _mas_problem()
    mas.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        mas.maximum_path(t(neg_cent), t(mask), True)
    assert not any(mas.launch_counts.values())


def _create_mesh_and_shard_batch():
    from mb_istft_vits_tpu.parallel import mesh as jax_mesh

    from mb_istft_vits_torch.parallel import mesh

    batch = {"x": np.arange(24, dtype=np.float32).reshape(4, 6),
             "n": np.arange(4, dtype=np.int32)}
    jm = jax_mesh.create_mesh(2, "data")
    ours = mesh.shard_batch({k: t(v) for k, v in batch.items()},
                            mesh.create_mesh(2, "data", device_type="cpu"),
                            "data")
    assert len(ours) == jm.size == 2
    ref = jax_mesh.shard_batch(batch, jm, "data")
    for k in batch:
        shards = sorted(ref[k].addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        for part, shard in zip(ours, shards):
            assert np.array_equal(n(part[k]), np.asarray(shard.data)), k


def _create_mesh_names_its_axis(tmp_path):
    """In a process group the axis name is the DeviceMesh's dimension."""
    from mb_istft_vits_torch.parallel import mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        dm = mesh.create_mesh(1, "batch", device_type="cpu")
        assert dm.mesh_dim_names == ("batch",)
        assert mesh.mesh_size(dm) == 1
    finally:
        dist.destroy_process_group()


def _param_spec():
    from mb_istft_vits_tpu.parallel import tp as jax_tp

    from mb_istft_vits_torch.parallel import tp

    for shape in [(3, 4, 6), (5, 7), (4, 3), (8,), (2, 5, 3)]:
        spec = tuple(jax_tp.param_spec(shape, 2, "model"))
        want = next((d for d, s in enumerate(spec) if s == "model"), None)
        assert tp.param_spec(shape, 2, "model") == want, shape


def _device_prefetch():
    from mb_istft_vits_tpu.data import prefetch as jax_prefetch

    from mb_istft_vits_torch.data import prefetch

    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]

    def put(b):
        return {k: v * 2 + 1 for k, v in b.items()}

    ours = list(prefetch.device_prefetch(iter(batches), put, 2))
    ref = list(jax_prefetch.device_prefetch(iter(batches), put, 2))
    assert len(ours) == len(ref) == 5
    for o, r in zip(ours, ref):
        assert np.array_equal(o["x"], r["x"])


def _rand_slice_segments():
    from mb_istft_vits_tpu.ops import segments as jax_seg

    from mb_istft_vits_torch.ops import segments

    x = np.random.RandomState(5).randn(3, 30, 4).astype(np.float32)
    lengths = np.array([30, 20, 8], np.int32)
    seg_j, ids_j = jax_seg.rand_slice_segments(
        jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(lengths), 8)
    for rng in (7, torch.Generator().manual_seed(7)):
        seg, ids = segments.rand_slice_segments(cl(x), rng, t(lengths), 8)
        assert seg.shape == (3, 4, 8)
        assert np.all(n(ids) >= 0) and np.all(n(ids) <= lengths - 8)
    again = segments.rand_slice_segments(cl(x), 7, t(lengths), 8)[1]
    assert torch.equal(again, ids)  # a seed repeats its draw
    seg, _ = segments.rand_slice_segments(cl(x), None, t(lengths), 8,
                                          ids_str=t(np.asarray(ids_j)))
    assert_close(n(seg).transpose(0, 2, 1), np.asarray(seg_j), atol=0)


def _noise_rng_slots():
    """The posterior encoder's and the SDP's JAX key slot takes a
    torch.Generator: a positional generator draws what the keyword draw
    from the same seed gives."""
    from mb_istft_vits_torch.models.duration import \
        StochasticDurationPredictor
    from mb_istft_vits_torch.models.encoders import PosteriorEncoder

    torch.manual_seed(0)
    enc = PosteriorEncoder(9, 4, 8, 5, 1, 2).eval()
    y, yl = torch.randn(2, 9, 11), torch.tensor([11, 7])
    z1 = enc(y, yl, None, torch.Generator().manual_seed(3))[0]
    eps = torch.randn((2, 4, 11), generator=torch.Generator().manual_seed(3))
    assert torch.equal(z1, enc(y, yl, None, eps=eps)[0])

    sdp = StochasticDurationPredictor(8, 8, 3, 0.0).eval()
    h, mask = torch.randn(2, 8, 6), torch.ones(2, 1, 6)
    w = torch.rand(2, 1, 6) * 3
    noise = torch.randn((2, 6, 2), generator=torch.Generator().manual_seed(5)
                        ).transpose(1, 2)
    with torch.no_grad():
        a = sdp.nll(h, mask, w, None, torch.Generator().manual_seed(5))
        b = sdp.nll(h, mask, w, None, noise=noise)
        c = sdp(h, mask, None, None, True, 1.0,
                torch.Generator().manual_seed(5))
        d = sdp(h, mask, None, None, True, 1.0, noise=noise)
    assert torch.equal(a, b) and torch.equal(c, d)


REPAIRS = {
    "stft_reflect": lambda _: _stft("reflect"),
    "stft_constant": lambda _: _stft("constant"),
    "stft_edge": lambda _: _stft("edge"),
    "stft_wrap": lambda _: _stft("wrap"),
    "stft_other_pad_mode_raises": lambda _: _stft_refuses_other_pad_modes(),
    "stft_magnitude": lambda _: _stft_magnitude(),
    "make_lr_schedule": lambda _: _make_lr_schedule(),
    "maximum_path": lambda _: _maximum_path(),
    "maximum_path_true_needs_the_card":
        lambda _: _maximum_path_true_needs_the_card(),
    "create_mesh_shard_batch": lambda _: _create_mesh_and_shard_batch(),
    "create_mesh_axis_name": _create_mesh_names_its_axis,
    "param_spec": lambda _: _param_spec(),
    "device_prefetch": lambda _: _device_prefetch(),
    "rand_slice_segments": lambda _: _rand_slice_segments(),
    "noise_rng": lambda _: _noise_rng_slots(),
}


@pytest.mark.parametrize("case", sorted(REPAIRS))
def test_jax_positional_call(case, tmp_path):
    REPAIRS[case](tmp_path)
