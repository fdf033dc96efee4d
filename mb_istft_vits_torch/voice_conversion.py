"""Voice conversion: re-speak a wav in another speaker's voice through the
latent flow (the port's `run_voice_conversion.py`; reference
models.py:790-798).

    python -m mb_istft_vits_torch.voice_conversion \
        -c configs/uudb_ms_istft_vits_ms.json -i in.wav \
        --sid-src 0 --sid-tgt 5 -o converted.wav [-k G.pth] [--device cpu]

The wav must be at the config's sampling rate. Its linear spectrogram is
made on the model's device; the posterior noise is drawn from --seed
(which also makes the random weights when no -k is given: a smoke run).
Runs on CUDA unless --device cpu. Needs a multi-speaker config.
"""

from __future__ import annotations

import argparse

import numpy as np


def convert(module, audio: np.ndarray, sid_src: int, sid_tgt: int,
            seed: int = 0) -> np.ndarray:
    """float32 audio [T] in [-1, 1] at the model's rate, spoken by
    `sid_src` -> the same speech as `sid_tgt`, float32 [T // hop * hop]."""
    import torch

    from mb_istft_vits_torch.dsp.stft import spectrogram

    d, dev = module.data_cfg, module.device
    with torch.no_grad():
        wav = torch.from_numpy(np.asarray(audio, np.float32)[None]).to(dev)
        spec = spectrogram(wav, d.filter_length, d.hop_length,
                           d.win_length).transpose(1, 2)  # [1, F, bins]
        lengths = torch.tensor([spec.shape[1]], device=dev)
        o_hat, _, _, _ = module.model.voice_conversion(
            spec, lengths, torch.tensor([sid_src], device=dev),
            torch.tensor([sid_tgt], device=dev),
            generator=torch.Generator(dev).manual_seed(seed))
    return o_hat[0, :, 0].float().cpu().numpy()


def main(argv=None) -> int:
    from mb_istft_vits_torch.data.dataset import load_wav
    from mb_istft_vits_torch.infer.synthesis import (
        get_synthesis_module_instance,
    )
    from mb_istft_vits_torch.utils.audio import write_wav

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", default=None,
                    help="reference-format G_*.pth")
    ap.add_argument("-i", "--input-wav", required=True)
    ap.add_argument("--sid-src", type=int, required=True)
    ap.add_argument("--sid-tgt", type=int, required=True)
    ap.add_argument("-o", "--output", default="converted.wav")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    module = get_synthesis_module_instance(args.config, args.checkpoint,
                                           seed=args.seed, device=args.device)
    d = module.data_cfg
    audio, sr = load_wav(args.input_wav)
    if sr != d.sampling_rate:
        raise SystemExit(f"{args.input_wav}: {sr} Hz, the config wants "
                         f"{d.sampling_rate} Hz")
    out = convert(module, audio / d.max_wav_value, args.sid_src,
                  args.sid_tgt, args.seed)
    write_wav(args.output, out, module.sampling_rate)
    print(f"wrote {args.output} ({len(out) / sr:.2f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
