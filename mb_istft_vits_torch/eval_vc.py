"""Objective voice-conversion scores of a multi-speaker checkpoint on the
synthetic UUDB corpus (the JAX package's `scripts/eval_vc.py`, same
arguments and lines; reference models.py:790-798).

    python -m mb_istft_vits_torch.eval_vc -c CORPUS/config.json -k G_N.pth \
        [--val-list FILELIST] [--pairs 7:0 7:11 ...] [--out-dir DIR]
        [--device cuda|cpu]

The corpus of `python -m mb_istft_vits_torch.make_corpus OUT --dataset
uudb` gives each speaker a known voice (base F0 and formant scale) and a
deterministic renderer (`utils.corpus`), so a conversion has a ground
truth: the source utterance re-rendered in the target's voice under the
source's duration seed. For each src:tgt pair (default: a spread over the
validation speakers) the converted waveform's median F0 is printed beside
the target's base F0, and its F0 RMSE (cents) and LSD against that
ground truth beside the same against the source wav; a pair "tracks the
target" when both are closer to the target. Each pair draws the
posterior noise from a generator seeded 0 (JAX: PRNGKey(0)). Runs on
CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def convert(module, wav_src: np.ndarray, src: int, tgt: int) -> np.ndarray:
    """Voice conversion of a normalized wav, speaker src -> tgt, the
    spectrogram padded to a 128-frame bucket as in the JAX script; the
    output cut to the input's length."""
    from mb_istft_vits_torch.dsp.stft import spectrogram

    d, dev = module.data_cfg, module.device
    with torch.no_grad():
        spec = spectrogram(torch.from_numpy(wav_src[None]).to(dev),
                           d.filter_length, d.hop_length,
                           d.win_length).transpose(1, 2)
        n_frames = spec.shape[1]
        spec = torch.nn.functional.pad(
            spec, (0, 0, 0, -(-n_frames // 128) * 128 - n_frames))
        o_hat, _, _, _ = module.model.voice_conversion(
            spec.to(module.compute_dtype),
            torch.tensor([n_frames], device=dev),
            torch.tensor([src], device=dev), torch.tensor([tgt], device=dev),
            generator=torch.Generator(dev).manual_seed(0))
    conv = o_hat[0, :n_frames * d.hop_length, 0].float().cpu().numpy()
    return conv[:len(wav_src)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", required=True,
                    help="a reference-format generator G_*.pth")
    ap.add_argument("--val-list", default=None,
                    help="filelist to draw source utterances from "
                         "(default: the config's validation_files)")
    ap.add_argument("--pairs", nargs="+", default=None,
                    help="src:tgt sid pairs (default: a spread)")
    ap.add_argument("--out-dir", default=None,
                    help="also write converted wavs here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from mb_istft_vits_torch.data.dataset import load_wav
    from mb_istft_vits_torch.infer.synthesis import (
        get_synthesis_module_instance,
    )
    from mb_istft_vits_torch.utils.audio import write_wav
    from mb_istft_vits_torch.utils.corpus import (
        _plan_jp,
        _speaker_profile,
        render,
    )
    from mb_istft_vits_torch.utils.metrics import (
        f0_metrics,
        log_spectral_distance,
        yin_f0,
    )

    module = get_synthesis_module_instance(args.config, args.checkpoint,
                                           device=args.device)
    d = module.data_cfg
    by_sid = {}
    with open(args.val_list or d.validation_files, encoding="utf-8") as f:
        for line in f:
            p, sid, txt = line.rstrip("\n").split("|", 2)
            by_sid.setdefault(int(sid), (p, txt))
    if args.pairs:
        pairs = [tuple(map(int, s.split(":"))) for s in args.pairs]
    else:
        sids = sorted(by_sid)
        pairs = [(sids[i], sids[(i + len(sids) // 2) % len(sids)])
                 for i in range(min(6, len(sids)))]
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    def med_f0(w):
        f0, v = yin_f0(w, d.sampling_rate, frame_length=1024,
                       hop_length=d.hop_length)
        return float(np.median(f0[v])) if v.any() else 0.0

    print(f"{'pair':>7} | {'tgtF0':>6} {'convF0':>6} {'srcF0':>6} | "
          f"{'f0c_tgt':>8} {'f0c_src':>8} | {'lsd_tgt':>7} {'lsd_src':>7} "
          f"| verdict")
    n_pass = 0
    for src, tgt in pairs:
        if src not in by_sid:
            print(f"{src}->{tgt}: no val utterance for src, skipped")
            continue
        path, txt = by_sid[src]
        audio, sr = load_wav(path)
        if sr != d.sampling_rate:
            raise SystemExit(f"{path}: {sr} Hz, the config wants "
                             f"{d.sampling_rate} Hz")
        wav_src = audio.astype(np.float32) / d.max_wav_value
        conv = convert(module, wav_src, src, tgt)
        # the ground truth: the same text under the source wav's duration
        # seed, which make_corpus takes from "{sid}_{basename}" of the
        # filelist's basename (".wav" included)
        utt_id = os.path.basename(path).split("_", 1)[1]
        f0_t, fs_t = _speaker_profile(tgt)
        gt_tgt = render(txt, utt_id, base_f0=f0_t, formant_scale=fs_t,
                        planner=_plan_jp,
                        sr=d.sampling_rate).astype(np.float32)
        n = min(len(conv), len(gt_tgt), len(wav_src))
        conv, gt_tgt, wav_src = conv[:n], gt_tgt[:n], wav_src[:n]
        m_tgt = f0_metrics(conv, gt_tgt, d.sampling_rate, frame_length=1024)
        m_src = f0_metrics(conv, wav_src, d.sampling_rate, frame_length=1024)
        lsd_tgt = log_spectral_distance(conv, gt_tgt, d.sampling_rate)
        lsd_src = log_spectral_distance(conv, wav_src, d.sampling_rate)
        ok = (m_tgt["f0_rmse_cents"] < m_src["f0_rmse_cents"]
              and lsd_tgt < lsd_src)
        n_pass += ok
        print(f"{src:>3}->{tgt:<3} | {f0_t:6.1f} {med_f0(conv):6.1f} "
              f"{med_f0(wav_src):6.1f} | {m_tgt['f0_rmse_cents']:8.1f} "
              f"{m_src['f0_rmse_cents']:8.1f} | {lsd_tgt:7.2f} "
              f"{lsd_src:7.2f} | "
              f"{'TRACKS TARGET' if ok else 'closer to src'}")
        if args.out_dir:
            write_wav(os.path.join(args.out_dir, f"vc_{src}_to_{tgt}.wav"),
                      conv, d.sampling_rate)
    print(f"{n_pass}/{len(pairs)} conversions track the target speaker "
          f"(F0 cents + LSD both closer to target than source)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
