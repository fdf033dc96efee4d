"""Shared set-up of the parity tests between the PyTorch port
(`mb_istft_vits_torch`) and the JAX package, both on the CPU.

Weights: the port's seeded random init (zero-initialised tensors, the flow
couplings' post convs, get numpy noise so the flows are not the identity),
written as a reference-format `.pth` and read by the JAX package's own
importer. The port then loads that JAX tree through `state_dict_from_jax`,
so every parity test also runs the weight bridge. Inputs and noise are
made with numpy and handed to both packages.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from mb_istft_vits_torch.config import ModelConfig as TorchModelConfig
from mb_istft_vits_torch.models import Synthesizer as TorchSynthesizer
from mb_istft_vits_torch.weights import state_dict_from_jax
from mb_istft_vits_tpu.config import ModelConfig as JaxModelConfig
from mb_istft_vits_tpu.train.checkpoint import import_torch_generator

# the tiny model of tests/test_model.py, with three dilations per resblock
# (the JAX package's .pth importer and exporter assume three)
TINY = dict(
    n_vocab=40, spec_channels=513, segment_size=8, inter_channels=16,
    hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.1, resblock="1", resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(4, 4),
    upsample_initial_channel=32, upsample_kernel_sizes=(16, 16),
    gen_istft_n_fft=16, gen_istft_hop_size=4, mb_istft_vits=True,
)

# f32 on the CPU: both packages run the same arithmetic in another order
ATOL = 1e-4
WAV_REL_L2 = 1e-3


def configs(**kw):
    d = dict(TINY, **kw)
    return TorchModelConfig(**d), JaxModelConfig(**d)


def make_weights(tmp_dir, cfg_t, cfg_j, seed=0):
    """-> (JAX param tree, port Synthesizer in eval mode holding it)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = TorchSynthesizer(cfg_t).state_dict()
    rng = np.random.RandomState(seed)
    for v in sd.values():
        if not v.any():
            v.copy_(torch.from_numpy(
                0.1 * rng.randn(*v.shape).astype(np.float32)))
    path = str(tmp_dir / "G_0.pth")
    torch.save({"model": sd, "iteration": 0, "learning_rate": 2e-4,
                "optimizer": None}, path)
    params = import_torch_generator(path, cfg_j)
    model = TorchSynthesizer(cfg_t)
    model.load_state_dict(state_dict_from_jax(params, cfg_t))
    return params, model.eval()


def japply(module, params, *args, method=None, rngs=None, **kwargs):
    """Apply a flax module under jit (one compile instead of op-by-op)."""

    def fn(p, *a):
        return module.apply({"params": p}, *a, method=method, rngs=rngs,
                            **kwargs)

    return jax.tree.map(np.asarray, jax.jit(fn)(params, *args))


def t(a):
    """numpy (or a JAX result) -> torch, as a copy."""
    return torch.from_numpy(np.array(a))


def cl(a):
    """numpy [B, T, C] -> torch [B, C, T]."""
    return t(a).transpose(1, 2).contiguous()


def n(x):
    """torch -> numpy."""
    return x.detach().cpu().numpy()


def assert_close(ours, ref, atol=ATOL, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.max(np.abs(ours - ref))) if ours.size else 0.0
    assert err <= atol, f"{what}: max abs err {err} > {atol}"


def rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-12))


def asdict(cfg):
    return dataclasses.asdict(cfg)
