"""Exported serving artifacts: `torch.export` programs (counterpart of
`mb_istft_vits_tpu/infer/export.py`).

`export_serving` snapshots the serving computation itself, the duration
probe per text bucket and the infer program per (text, frame) bucket
pair, as `torch.export` programs, beside the generator's weights and a
manifest. `ExportedServing` then serves text to waveform from the
artifact alone: the programs run, the model code does not, so later edits
to the model code cannot change what a deployed artifact computes.

Artifact layout (one directory)::

    manifest.json            buckets, frontend, dtype, torch/format versions
    params.pt                generator weights under the reference
                             state-dict names (torch.save; bf16 stays bf16)
    probe_t{TB}.pt2          duration probe per text bucket
    infer_t{TB}_f{FB}.pt2    infer program per (text, frame) bucket pair

The weights are stored once. Every program takes them as its first input,
a state dict, and the model it traced is not one of its submodules, so no
`.pt2` keeps a copy of them; nor does it keep its example inputs.

The programs are the live module's bodies (`infer.programs.probe` and
`infer` at the default options: (int16 PCM, y_lengths), no resampling).

The noise is an input: a `torch.Generator` cannot enter an exported
program (the JAX package passes an rng key into its programs). The probe
takes `w_eps` [1, TB, 2] (a model with the stochastic duration predictor;
None otherwise), the infer program the prior's `eps` [1, FB,
inter_channels] and `w_eps`. `ExportedServing` draws them as the live
`SynthesisModule` does, `w_eps` first and then `eps` in the compute dtype,
so a request at `seed=s` is the live `synthesize(text, seed=s)` at the
same frame bucket, bit for bit; without a seed they come from the
artifact's own stream, in call order.

`noise_scale`, `length_scale` and `noise_scale_w` are inputs too, so one
program serves every value: 0-dim float32 tensors, traced on the CPU
whatever the device. An operand on the CPU that holds one value enters an
op as a Python float does, so the program's arithmetic is the live
module's in bfloat16 too; served on a card they are 0-dim CUDA tensors,
as the live module's graphs take them, which the model's arithmetic
(`nn.layers.scale`) takes to the same bits.

On a card `ExportedServing` replays its programs as CUDA graphs, one per
program and input signature (`infer.graphs.GraphCache`, as the live
module does): the probe as ("probe", TB) and the infer program as
("infer", TB, FB), each with the weights bound, the knobs 0-dim float32
tensors on the card (kept per value) and the noise drawn outside the
graph. On the CPU the programs run directly, their keys kept.

Devices: the manifest records the device the programs were traced on.
`ExportedServing` loads onto CUDA unless the caller asks for the CPU and
moves a program traced on another device
(`torch.export.passes.move_to_device_pass`, which also moves the devices
written into its ops: the `arange`s and the iSTFT window).

CLI: `python -m mb_istft_vits_torch.export_serving`.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from mb_istft_vits_torch.device import disable_tf32, resolve_device
from mb_istft_vits_torch.infer import programs
from mb_istft_vits_torch.infer.graphs import GraphCache, KnobCache
from mb_istft_vits_torch.infer.synthesis import SynthesisModule, _next_bucket
from mb_istft_vits_torch.text import frontend_ids

_FORMAT = 1
PLATFORMS = ("cpu", "cuda")  # a program traced on one runs on either


class _Method(nn.Module):
    """One `Synthesizer` method as a module's forward; the model is its
    submodule `model`, so `functional_call` can hand it other weights."""

    def __init__(self, model: nn.Module, method):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args):
        return self.method(self.model, *args)


class _Program(nn.Module):
    """What is exported: (weights, inputs) -> `method` run on those
    weights. It holds `method` without registering it as a submodule, so
    the program owns no tensor of the model."""

    def __init__(self, method: _Method):
        super().__init__()
        object.__setattr__(self, "method", method)

    def forward(self, params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(
            self.method, {f"model.{k}": v for k, v in params.items()}, args)


def _scalar(v: float) -> torch.Tensor:
    """A knob as a program input: a 0-dim float32 tensor on the CPU."""
    return torch.tensor(float(v), dtype=torch.float32)


def export_serving(
    module,
    out_dir: str,
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> dict:
    """Write a serving artifact for `module` (a SynthesisModule), traced
    on its device in its compute dtype.

    pairs: (text_bucket, frame_bucket) program shapes to export; the
    default mirrors `warmup()`, each text bucket with its expected
    output-frame bucket. platforms: where the artifact is meant to run,
    recorded in the manifest; each of PLATFORMS loads any artifact (a
    program is moved at load), so the default is the module's device
    type."""
    if pairs is None:
        pairs = [
            (tb, _next_bucket(int(tb * module._frames_per_token),
                              module.FRAME_BUCKETS))
            for tb in module.TEXT_BUCKETS
        ]
    unknown = sorted(set(platforms or ()) - set(PLATFORMS))
    if unknown:
        raise ValueError(f"platforms {unknown} not among {list(PLATFORMS)}")
    os.makedirs(out_dir, exist_ok=True)
    model, dev = module.model, module.device
    cfg = module.cfg
    # a plain dict: the programs' input spec is the type params.pt loads as
    params = dict(model.state_dict())
    sid = (torch.zeros((1,), dtype=torch.int64, device=dev)
           if cfg.n_speakers > 0 else None)

    def save(fn, args, name):
        ep = torch.export.export(_Program(_Method(model, fn).eval()),
                                 (params, *args), strict=False)
        ep.example_inputs = None  # they would hold a copy of the weights
        torch.export.save(ep, os.path.join(out_dir, name))

    exported = []
    probes = set()
    with torch.no_grad():
        for tb, fb in pairs:
            x = torch.ones((1, tb), dtype=torch.int64, device=dev)
            xl = torch.full((1,), tb, dtype=torch.int64, device=dev)
            w_eps = (torch.zeros((1, tb, 2), device=dev) if cfg.use_sdp
                     else None)
            if tb not in probes:
                save(programs.probe,
                     (x, xl, sid, _scalar(1.0), _scalar(0.8), w_eps),
                     f"probe_t{tb}.pt2")
                probes.add(tb)
            eps = torch.zeros((1, fb, cfg.inter_channels),
                              dtype=module.compute_dtype, device=dev)
            save(functools.partial(programs.infer, max_frames=fb),
                 (x, xl, sid, _scalar(0.667), _scalar(1.0), _scalar(0.8),
                  eps, w_eps), f"infer_t{tb}_f{fb}.pt2")
            exported.append([int(tb), int(fb)])
    torch.save({k: v.cpu() for k, v in params.items()},
               os.path.join(out_dir, "params.pt"))

    d = module.data_cfg
    manifest = {
        "format": _FORMAT,
        "torch_version": torch.__version__,
        "platforms": list(platforms) if platforms else [dev.type],
        "device": str(dev),  # where the programs were traced
        "pairs": exported,
        "sampling_rate": d.sampling_rate,
        "hop_length": d.hop_length,
        "n_speakers": cfg.n_speakers,
        "inter_channels": cfg.inter_channels,
        "use_sdp": cfg.use_sdp,
        "compute_dtype": str(module.compute_dtype).replace("torch.", ""),
        "frontend": {
            "text_module": d.text_module,
            "text_cleaners": list(d.text_cleaners),
            # the cleaners the live module runs on raw text: the config's
            # own, Japanese included (katakana in)
            "serving_cleaners": list(d.text_cleaners),
            "add_blank": d.add_blank,
            "cleaned_text": d.cleaned_text,
        },
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return manifest


class ExportedServing:
    """Serve from an `export_serving` artifact: text -> waveform with the
    exported programs and weights only (model code never runs), on
    `device` (CUDA unless "cpu" is asked for; no fallback). Every program
    is loaded once, here; on a card each runs as a CUDA graph per input
    signature (`graphs`, captured at its first request)."""

    def __init__(self, artifact_dir: str, seed: int = 0, *,
                 device: Optional[Union[str, torch.device]] = None):
        from torch.export.passes import move_to_device_pass

        dev = SynthesisModule._indexed(resolve_device(device))
        if dev.type == "cuda":
            # as SynthesisModule: full float32 and cuDNN's deterministic
            # algorithms, so a seeded request repeats bit for bit
            disable_tf32()
            torch.backends.cudnn.deterministic = True
        self.device = dev
        with open(os.path.join(artifact_dir, "manifest.json")) as fh:
            self.manifest = json.load(fh)
        if self.manifest["format"] != _FORMAT:
            raise ValueError(
                f"artifact format {self.manifest['format']} != {_FORMAT}")
        self.params = torch.load(os.path.join(artifact_dir, "params.pt"),
                                 map_location=dev, weights_only=True)
        self.sampling_rate = self.manifest["sampling_rate"]
        self.hop_length = self.manifest["hop_length"]
        self.compute_dtype = getattr(torch, self.manifest["compute_dtype"])
        traced_on = torch.device(self.manifest["device"])

        def load(name: str):
            ep = torch.export.load(os.path.join(artifact_dir, name))
            if traced_on != dev:
                ep = move_to_device_pass(ep, dev)
            program = ep.module()
            # synthesize builds every input to the traced shapes; the
            # module's own check of each input on every call (a Python loop
            # over the weights, ~10 ms a call on a CPU at the test width)
            # is left out
            program.validate_inputs = False
            return program

        self._probe: Dict[int, nn.Module] = {}
        self._infer: Dict[Tuple[int, int], nn.Module] = {}
        for tb, fb in self.manifest["pairs"]:
            if tb not in self._probe:
                self._probe[tb] = load(f"probe_t{tb}.pt2")
            self._infer[(tb, fb)] = load(f"infer_t{tb}_f{fb}.pt2")
        # unseeded requests draw from this stream, in call order
        self._generator = torch.Generator(dev).manual_seed(seed)
        self.graphs = GraphCache()
        self._knobs = KnobCache()

    def _knob(self, v: float) -> torch.Tensor:
        """A knob as a program input: a 0-dim float32 tensor on the
        serving device, kept per value."""
        return self._knobs(v, self.device)

    def _run(self, key: tuple, program: nn.Module, *args):
        """program(params, *args): its graph at `key` and these inputs'
        signature on a card, a direct call on the CPU."""
        return self.graphs.run(key, functools.partial(program, self.params),
                               args, self.device)

    # -- frontend (the live SynthesisModule's host-side path) -------------
    def text_to_ids(self, text: str,
                    cleaned: Optional[bool] = None) -> np.ndarray:
        fe = self.manifest["frontend"]
        cleaned = fe["cleaned_text"] if cleaned is None else cleaned
        return np.asarray(
            frontend_ids(text, fe["text_module"], fe["serving_cleaners"],
                         fe["add_blank"], cleaned),
            np.int32,
        )

    def _buckets_for(self, n_ids: int) -> Tuple[int, List[int]]:
        tbs = sorted({tb for tb, _ in self._infer})
        fit = [tb for tb in tbs if tb >= n_ids]
        if not fit:
            raise ValueError(
                f"text of {n_ids} tokens exceeds every exported text "
                f"bucket {tbs}")
        tb = fit[0]
        fbs = sorted(fb for t, fb in self._infer if t == tb)
        return tb, fbs

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def synthesize(self, text: str, sid: Optional[int] = None,
                   noise_scale: float = 0.667, length_scale: float = 1.0,
                   noise_scale_w: float = 0.8, seed: Optional[int] = None,
                   cleaned: Optional[bool] = None):
        """-> (float32 audio on the int16 grid [y_len * hop], timings:
        total, audio_seconds, rtf, frame_bucket). Raises ValueError when
        the text or its predicted frames exceed every exported bucket."""
        t0 = time.perf_counter()
        ids = self.text_to_ids(text, cleaned)
        tb, fbs = self._buckets_for(len(ids))
        x = np.zeros((1, tb), np.int64)
        x[0, : len(ids)] = ids
        x = self._to_device(x)
        xl = self._to_device(np.asarray([len(ids)], np.int64))
        sid_t = (self._to_device(np.asarray([0 if sid is None else int(sid)],
                                            np.int64))
                 if self.manifest["n_speakers"] > 0 else None)
        gen = (self._generator if seed is None
               else torch.Generator(self.device).manual_seed(int(seed)))
        w_eps = (torch.randn((1, tb, 2), generator=gen, device=self.device)
                 if self.manifest["use_sdp"] else None)
        ns, ls, nsw = map(self._knob,
                          (noise_scale, length_scale, noise_scale_w))
        with torch.no_grad():
            frames = int(self._run(("probe", tb), self._probe[tb], x, xl,
                                   sid_t, ls, nsw, w_eps)[0])
            fb = next((b for b in fbs if b >= frames), None)
            if fb is None:
                # the live module grows its bucket and decodes again; an
                # artifact has a fixed set of programs, and truncating
                # would differ from live serving: refuse instead
                raise ValueError(
                    f"predicted {frames} frames exceeds every exported "
                    f"frame bucket {fbs} for text bucket {tb}; re-export "
                    f"with larger --pairs or lower length_scale")
            # the live model's draw: [1, C, FB] in the compute dtype
            eps = torch.randn((1, self.manifest["inter_channels"], fb),
                              generator=gen, dtype=self.compute_dtype,
                              device=self.device).transpose(1, 2).contiguous()
            pcm16, y_lengths = self._run(
                ("infer", tb, fb), self._infer[(tb, fb)], x, xl, sid_t, ns,
                ls, nsw, eps, w_eps)
            pcm16, y_lengths = pcm16[0].cpu().numpy(), y_lengths.cpu()
        y_len = min(int(y_lengths[0]), fb)
        audio = pcm16.astype(np.float32)[: y_len * self.hop_length] / 32767.0
        elapsed = time.perf_counter() - t0
        return audio, {
            "total": elapsed,
            "audio_seconds": len(audio) / self.sampling_rate,
            "rtf": elapsed / max(len(audio) / self.sampling_rate, 1e-9),
            "frame_bucket": fb,
        }


def load_serving(artifact_dir: str, *,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> ExportedServing:
    return ExportedServing(artifact_dir, device=device)
