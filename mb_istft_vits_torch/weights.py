"""Weight bridge: JAX parameter trees and reference `G_*.pth` files to the
port's state dicts.

The port's modules carry the reference `SynthesizerTrn` and
`MultiPeriodDiscriminator` state-dict names, so a reference checkpoint
loads as it is. `module_state_dict_from_jax` carries the params of one
`nn` module (the attention modules, `ConvReluNorm`) across, for the
modules the shipped models do not hold. `state_dict_from_jax` is the
port's own copy of the JAX package's `export_torch_generator` mapping
(`train/checkpoint.py:438-593`) for every decoder head, multi-speaker
models and the stochastic duration predictor;
`discriminator_state_dict_from_jax` is the inverse of its
`import_torch_discriminator` (`:603-637`).

The stochastic duration predictor's `ElementwiseAffine` parameters
(`dp.flows.0.m`, `dp.post_flows.0.logs`, ...) are [2, 1] in the reference
and in the port; the JAX exporter writes them as (2,), so
`load_generator_pth` reshapes those.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from mb_istft_vits_torch.config import ModelConfig

# reference buffers the port rebuilds in its constructors
_REBUILT_BUFFERS = ("stft.window", "updown_filter", "analysis_filter",
                    "synthesis_filter")
# the stochastic duration predictor's ElementwiseAffine parameters
_AFFINE = re.compile(r"dp\.(post_)?flows\.0\.(m|logs)")


def state_dict_from_jax(params: Mapping, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX `Synthesizer` params (nested dicts of arrays) -> state dict.

    Layouts: a JAX conv kernel is [k, in, out]; torch Conv1d is
    [out, in, k] and ConvTranspose1d [in, out, k]. Weight norm's g is a
    vector in JAX and [n, 1, 1] in torch."""
    sd: Dict[str, torch.Tensor] = {}

    def node(path):
        n = params
        for p in path:
            n = n[p]
        return n

    def put(key, arr):
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(
            arr, dtype=np.float32)))

    def plain_conv(src, dst):
        n = node(src)
        put(dst + ".weight", np.asarray(n["kernel"]).transpose(2, 1, 0))
        if "bias" in n:
            put(dst + ".bias", n["bias"])

    def wn_conv(src, dst, transpose=False):
        n = node(src)
        v = np.asarray(n["v"])
        put(dst + ".weight_v",
            v.transpose(1, 2, 0) if transpose else v.transpose(2, 1, 0))
        put(dst + ".weight_g", np.asarray(n["g"]).reshape(-1, 1, 1))
        if "bias" in n:
            put(dst + ".bias", n["bias"])

    def layernorm(src, dst):
        put(dst + ".gamma", node(src)["gamma"])
        put(dst + ".beta", node(src)["beta"])

    gin = cfg.gin_channels

    def wn_block(src, dst, n_layers):
        if gin:
            wn_conv(src + ("cond_layer",), f"{dst}.cond_layer")
        for i in range(n_layers):
            wn_conv(src + (f"in_layers_{i}",), f"{dst}.in_layers.{i}")
            wn_conv(src + (f"res_skip_layers_{i}",),
                    f"{dst}.res_skip_layers.{i}")

    put("enc_p.emb.weight", node(("enc_p", "emb"))["embedding"])
    for i in range(cfg.n_layers):
        base = ("enc_p", "encoder", f"attn_layers_{i}")
        dst = f"enc_p.encoder.attn_layers.{i}"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            plain_conv(base + (name,), f"{dst}.{name}")
        put(f"{dst}.emb_rel_k", node(base)["emb_rel_k"])
        put(f"{dst}.emb_rel_v", node(base)["emb_rel_v"])
        for j in (1, 2):
            layernorm(("enc_p", "encoder", f"norm_layers_{j}_{i}"),
                      f"enc_p.encoder.norm_layers_{j}.{i}")
        for name in ("conv_1", "conv_2"):
            plain_conv(("enc_p", "encoder", f"ffn_layers_{i}", name),
                       f"enc_p.encoder.ffn_layers.{i}.{name}")
    plain_conv(("enc_p", "proj"), "enc_p.proj")

    plain_conv(("enc_q", "pre"), "enc_q.pre")
    plain_conv(("enc_q", "proj"), "enc_q.proj")
    wn_block(("enc_q", "enc"), "enc_q.enc", 16)

    for i in range(4):
        base = ("flow", f"coupling_{i}")
        dst = f"flow.flows.{2 * i}"  # odd indices are Flip (no params)
        plain_conv(base + ("pre",), f"{dst}.pre")
        plain_conv(base + ("post",), f"{dst}.post")
        wn_block(base + ("enc",), f"{dst}.enc", 4)

    def dds_conv(src, dst):
        for i in range(3):
            plain_conv(src + (f"convs_sep_{i}",), f"{dst}.convs_sep.{i}")
            plain_conv(src + (f"convs_1x1_{i}",), f"{dst}.convs_1x1.{i}")
            layernorm(src + (f"norms_1_{i}",), f"{dst}.norms_1.{i}")
            layernorm(src + (f"norms_2_{i}",), f"{dst}.norms_2.{i}")

    if cfg.use_sdp:
        # the inverse of the JAX importer (train/checkpoint.py:357-376)
        for chain in ("flows", "post_flows"):
            affine = node(("dp", f"{chain}_0"))
            put(f"dp.{chain}.0.m", np.asarray(affine["m"]).reshape(-1, 1))
            put(f"dp.{chain}.0.logs",
                np.asarray(affine["logs"]).reshape(-1, 1))
            for i in range(4):
                src, dst = ("dp", f"{chain}_cf_{i}"), f"dp.{chain}.{1 + 2 * i}"
                plain_conv(src + ("pre",), f"{dst}.pre")
                dds_conv(src + ("convs",), f"{dst}.convs")
                plain_conv(src + ("proj",), f"{dst}.proj")
        for name in ("pre", "proj", "post_pre", "post_proj"):
            plain_conv(("dp", name), f"dp.{name}")
        dds_conv(("dp", "convs"), "dp.convs")
        dds_conv(("dp", "post_convs"), "dp.post_convs")
    else:
        for name in ("conv_1", "conv_2", "proj"):
            plain_conv(("dp", name), f"dp.{name}")
        layernorm(("dp", "norm_1"), "dp.norm_1")
        layernorm(("dp", "norm_2"), "dp.norm_2")
    if gin:
        plain_conv(("dp", "cond"), "dp.cond")

    trunk = ("dec", "trunk")
    wn_conv(trunk + ("conv_pre",), "dec.conv_pre")
    for i in range(len(cfg.upsample_rates)):
        wn_conv(trunk + (f"ups_{i}",), f"dec.ups.{i}", transpose=True)
    convs = (("convs1", "convs2") if cfg.resblock == "1" else ("convs",))
    n_res = len(cfg.resblock_kernel_sizes) * len(cfg.upsample_rates)
    for i in range(n_res):
        base = trunk + (f"resblocks_{i}",)
        n_dil = len(cfg.resblock_dilation_sizes[i % len(
            cfg.resblock_kernel_sizes)])
        for name in convs:
            for j in range(n_dil):
                wn_conv(base + (f"{name}_{j}",), f"dec.resblocks.{i}.{name}.{j}")
        if "cond" in node(base):
            plain_conv(base + ("cond",), f"dec.resblocks.{i}.cond")
    kind = cfg.decoder_kind
    if kind == "istft":
        wn_conv(("dec", "conv_post"), "dec.conv_post")
    else:
        wn_conv(("dec", "subband_conv_post"), "dec.subband_conv_post")
    if kind == "ms_istft":
        wn_conv(("dec", "multistream_conv_post"), "dec.multistream_conv_post")
    if cfg.n_speakers > 1:
        put("emb_g.weight", node(("emb_g",))["embedding"])
    return sd


def discriminator_state_dict_from_jax(params: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    """JAX `MultiPeriodDiscriminator` params -> the port's state dict.

    Layouts: a JAX Conv1d kernel is [k, in, out] and a Conv2dP kernel
    [kh, kw, in, out]; torch's are [out, in, k] and [out, in, kh, kw].
    Weight norm's g is a vector in JAX and [out, 1, ...] in torch."""
    sd: Dict[str, torch.Tensor] = {}

    def wn_conv(node, dst):
        v = np.asarray(node["v"], dtype=np.float32)
        perm = (2, 1, 0) if v.ndim == 3 else (3, 2, 0, 1)
        sd[dst + ".weight_v"] = torch.from_numpy(
            np.ascontiguousarray(v.transpose(perm)))
        sd[dst + ".weight_g"] = torch.from_numpy(np.asarray(
            node["g"], dtype=np.float32).reshape((-1,) + (1,) * (v.ndim - 1)))
        sd[dst + ".bias"] = torch.from_numpy(np.asarray(node["bias"],
                                                        dtype=np.float32))

    for i, name in enumerate(["disc_s"] + [f"disc_p{p}" for p in
                                           (2, 3, 5, 7, 11)]):
        tree = params[name]
        n_convs = sum(1 for k in tree if k.startswith("convs_"))
        for j in range(n_convs):
            wn_conv(tree[f"convs_{j}"], f"discriminators.{i}.convs.{j}")
        wn_conv(tree["conv_post"], f"discriminators.{i}.conv_post")
    return sd


def module_state_dict_from_jax(params: Mapping, module: torch.nn.Module
                               ) -> Dict[str, torch.Tensor]:
    """The JAX params of one `nn` module (its `init(...)["params"]`) ->
    the state dict of the port's `module` of the same configuration: the
    attention modules in every option (`MultiHeadAttention`, `FFN`,
    `TransformerEncoder`, `TransformerDecoder`) and `ConvReluNorm`.

    A flax submodule `name_i` is the port's `name[i]` (a ModuleList) unless
    the port has a child `name_i` itself. Conv kernels [k, in, out] become
    [out, in, k], a weight norm's g [n] becomes [n, 1, 1], LayerNorm's
    gamma and beta and the relative-position tables copy as they are.
    Raises unless every parameter of `module` is given once, at its
    shape."""
    from mb_istft_vits_torch.nn.layers import Conv1d

    sd: Dict[str, torch.Tensor] = {}

    def leaf(mod, key, value):
        arr = np.asarray(value, dtype=np.float32)
        if isinstance(mod, Conv1d) and key in ("kernel", "v"):
            return ("weight" if key == "kernel" else "weight_v",
                    arr.transpose(2, 1, 0))
        if isinstance(mod, Conv1d) and key == "g":
            return "weight_g", arr.reshape(-1, 1, 1)
        return key, arr

    def walk(tree, mod, prefix):
        for key, sub in tree.items():
            if not isinstance(sub, Mapping):
                name, arr = leaf(mod, key, sub)
                sd[prefix + name] = torch.from_numpy(arr.copy())
                continue
            listed = re.fullmatch(r"(.+)_(\d+)", key)
            if not hasattr(mod, key) and listed:
                child = getattr(mod, listed[1])[int(listed[2])]
                walk(sub, child, f"{prefix}{listed[1]}.{listed[2]}.")
            else:
                walk(sub, getattr(mod, key), f"{prefix}{key}.")

    walk(params, module, "")
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        differ = [k for k in got.keys() & want.keys() if got[k] != want[k]]
        raise KeyError(f"JAX params do not fill {type(module).__name__}: "
                       f"missing {sorted(set(want) - set(got))}, extra "
                       f"{sorted(set(got) - set(want))}, shapes differ at "
                       f"{differ}")
    return sd


def load_generator_pth(path: str) -> Dict[str, torch.Tensor]:
    """State dict of a reference-format `G_*.pth` ({"model": state_dict,
    "iteration", "learning_rate", "optimizer"}), without the buffers the
    port rebuilds itself (iSTFT window, PQMF filters); the stochastic
    duration predictor's affine parameters as [2, 1] whichever of the
    reference's [2, 1] and the JAX exporter's (2,) the file holds."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.endswith(_REBUILT_BUFFERS):
            continue
        out[k] = v.reshape(-1, 1) if _AFFINE.fullmatch(k) else v
    return out
