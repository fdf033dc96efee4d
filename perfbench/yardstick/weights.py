"""Seeded weights, made on the device in a few large draws and handed to
both the program and the reference.

Every leaf is drawn from one normal draw of a `torch.Generator` on the
device, scaled as torch's default initialisation scales it (the standard
deviation of kaiming-uniform with a = sqrt(5), 1 / sqrt(3 fan_in), for
conv weights and biases; hidden ** -0.5 for the text embedding, d_k **
-0.5 for the relative-position tables, 1 for the speaker embedding);
LayerNorm gains are 1 and shifts 0; a weight-normed conv's gain g is
||v||, so that its weight is v. Named leaves may be set to constants (a
cell's `weight_overrides`): the duration predictor's output bias sets
the frames a token of a random model speaks, and the decoder head's bias
sets its output level, so that random weights give utterances of the
corpus's lengths and unclipped audio. A name that is no leaf is an
error."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def _scale(name: str, shape, shapes: Mapping[str, tuple],
           hidden: int) -> float:
    if name.endswith("emb_rel_k") or name.endswith("emb_rel_v"):
        return shape[-1] ** -0.5
    if name.endswith("enc_p.emb.weight"):
        return hidden ** -0.5
    if name.endswith("emb_g.weight"):
        return 1.0
    if name.endswith(".bias"):
        base = name[:-len(".bias")]
        w = shapes.get(base + ".weight_v", shapes.get(base + ".weight"))
        if w is None:
            return 0.02
        if ".ups." in name:  # a transposed conv's fan-in is its outputs
            return 1.0 / math.sqrt(3 * w[1] * w[2])
        return 1.0 / math.sqrt(3 * _fan_in(w))
    if ".ups." in name:
        return 1.0 / math.sqrt(3 * shape[1] * shape[2])
    return 1.0 / math.sqrt(3 * _fan_in(shape))


def make(leaves: Iterable[Tuple[str, tuple]], seed: int,
         device: torch.device, hidden: int,
         overrides: Optional[Mapping[str, object]] = None
         ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for (name, shape) leaves."""
    leaves = list(leaves)
    shapes = {n: tuple(s) for n, s in leaves}
    drawn = [(n, s) for n, s in leaves
             if not n.endswith((".gamma", ".beta", ".weight_g"))]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    k = 0
    for n, s in drawn:
        size = math.prod(s)
        out[n] = flat[k:k + size].view(s).mul_(_scale(n, s, shapes, hidden))
        k += size
    for n, s in leaves:
        if n.endswith(".gamma"):
            out[n] = torch.ones(s, device=device)
        elif n.endswith(".beta"):
            out[n] = torch.zeros(s, device=device)
        elif n.endswith(".weight_g"):
            v = out[n[:-len("_g")] + "_v"]
            out[n] = v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                  keepdim=True).sqrt()
    for n, value in (overrides or {}).items():
        if n not in out:
            raise KeyError(f"weight override {n!r} names no leaf")
        out[n] = _override(out[n], value)
    return {n: out[n] for n, _ in leaves}


def _override(t: torch.Tensor, value) -> torch.Tensor:
    """A constant, or [[start, stop, constant], ...] slices of dim 0."""
    t = t.clone()
    if isinstance(value, (int, float)):
        return t.fill_(float(value))
    for start, stop, v in value:
        t[start:stop] = float(v)
    return t
