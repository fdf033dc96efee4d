"""Offline copy-synthesis evaluation of a checkpoint over a filelist (the
JAX package's `scripts/eval_checkpoint.py`, same arguments and JSON).

    python -m mb_istft_vits_torch.eval_checkpoint -c CONFIG -k G_N.pth \
        [-f FILELIST] [-n 16] [--bands] [--tts] [--save-audio DIR]
        [--out JSON] [--device cuda|cpu]

The trainer's eval scores one validation utterance; this scores N of a
filelist (default: the config's validation_files) from a reference-format
generator `.pth`, so a milestone checkpoint gets a readout with a spread:
per utterance the copy-synthesis MCD, LSD, F0 RMSE and voicing decision
error, summarized as mean, std and max, with the worst utterance named.
Copy synthesis (`Synthesizer.reconstruct`) posterior-encodes the ground
truth's spectrogram and decodes it, so the output is time-aligned with
the ground truth. --bands adds the LSD of each frequency quartile; --tts
also synthesizes each utterance from its text and scores it by
DTW-aligned MCD and the duration ratio. Utterance i draws its noise from
generators seeded i (copy synthesis) and 1000 + i (TTS), where JAX uses
PRNGKey(i) and PRNGKey(1000 + i). Runs on CUDA unless --device cpu.

Not carried over: Orbax checkpoint directories (the port reads `.pth`;
the JAX package exports one, ROADMAP).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _stats(rows, key) -> Optional[Dict[str, float]]:
    v = [r[key] for r in rows if key in r]
    return {"mean": round(float(np.mean(v)), 3),
            "std": round(float(np.std(v)), 3),
            "max": round(float(np.max(v)), 3)} if v else None


def band_lsd(gt: np.ndarray, recon: np.ndarray, d) -> Dict[str, float]:
    """LSD per quartile of the frequency bins (0-25 / .. / 75-100 % of
    Nyquist) over the frames within 60 dB of the loudest bin."""
    from mb_istft_vits_torch.dsp.stft import stft_magnitude

    mags = []
    for w in (gt, recon[:len(gt)]):
        with torch.no_grad():
            m = stft_magnitude(torch.from_numpy(np.ascontiguousarray(
                w[None], np.float32)), d.filter_length, d.hop_length,
                d.win_length)[0].numpy()
        mags.append(np.maximum(m.astype(np.float64) ** 2, 1e-20))
    floor = max(m2.max() for m2 in mags) * 1e-6  # top 60 dB
    keep = mags[0].max(axis=0) > floor
    mags = [np.maximum(m2[:, keep], floor) for m2 in mags]
    nb = mags[0].shape[0]
    out = {}
    for q in range(4):
        sl = slice(q * nb // 4, (q + 1) * nb // 4)
        la, lb = (10.0 * np.log10(m2[sl]) for m2 in mags)
        out[f"lsd_q{q}"] = round(float(np.mean(np.sqrt(np.mean(
            (la - lb) ** 2, axis=0)))), 3)
    return out


def score_utterance(net_g, item, i: int, d, multi: bool, *,
                    bands: bool = False, tts_max_frames: int = 0,
                    posterior_eps: Optional[torch.Tensor] = None,
                    tts_eps: Optional[torch.Tensor] = None
                    ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """One utterance's row and its clips (gt, copy[, tts]). The copy
    synthesis draws from a generator seeded i unless `posterior_eps`
    [1, F_pad, C] is given; with tts_max_frames > 0 the TTS decode draws
    from one seeded 1000 + i unless `tts_eps` [1, tts_max_frames, C] is."""
    from mb_istft_vits_torch.dsp.stft import spectrogram
    from mb_istft_vits_torch.utils.metrics import (
        f0_metrics,
        log_spectral_distance,
        mcd_dtw,
        mel_cepstral_distortion,
    )

    device = next(net_g.parameters()).device
    sr = d.sampling_rate
    stft_args = dict(n_fft=d.filter_length, hop_length=d.hop_length,
                     win_length=d.win_length)
    n_mels = min(d.n_mel_channels, d.filter_length // 2 + 1)
    gt = np.asarray(item["wav"], np.float32).reshape(-1)
    sid = (torch.tensor([int(item.get("sid", 0))], device=device) if multi
           else None)
    with torch.no_grad():
        spec = spectrogram(torch.from_numpy(gt[None]).to(device),
                           d.filter_length, d.hop_length,
                           d.win_length).transpose(1, 2)  # [1, F, bins]
        f = spec.shape[1]
        # 64-frame buckets, as the JAX script pads for one compile each
        spec = torch.nn.functional.pad(spec, (0, 0, 0, -(-f // 64) * 64 - f))
        out, _ = net_g.reconstruct(
            spec, torch.tensor([f], device=device), sid,
            posterior_eps=posterior_eps,
            generator=torch.Generator(device).manual_seed(i))
    recon = out[0, :f * d.hop_length, 0].float().cpu().numpy()
    row = {"i": i, "audio_s": round(len(gt) / sr, 2),
           "mcd": mel_cepstral_distortion(gt, recon, sr, n_mels=n_mels,
                                          **stft_args),
           "lsd": log_spectral_distance(gt, recon, sr, **stft_args)}
    if len(gt) >= 4096:
        m = f0_metrics(gt, recon, sr)
        row["f0_rmse_hz"] = m["f0_rmse_hz"]
        row["vde"] = m["voicing_decision_error"]
    if bands:
        row.update(band_lsd(gt, recon, d))
    clips = {"gt": gt, "copy": recon[:len(gt)]}
    if tts_max_frames:
        x = np.asarray(item["x"], np.int64)
        xb = np.zeros((1, -(-len(x) // 64) * 64), np.int64)  # text buckets
        xb[0, :len(x)] = x
        with torch.no_grad():
            syn_out = net_g.infer(
                torch.from_numpy(xb).to(device),
                torch.tensor([len(x)], device=device), sid,
                max_frames=tts_max_frames, eps=tts_eps,
                generator=torch.Generator(device).manual_seed(1000 + i))
        n_syn = int(syn_out.y_lengths[0]) * d.hop_length
        syn = syn_out.o[0, :n_syn, 0].float().cpu().numpy()
        t = mcd_dtw(gt, syn, sr, n_mels=n_mels, **stft_args)
        row["mcd_tts_dtw"] = t["mcd_dtw"]
        row["dur_ratio_tts"] = t["dur_ratio"]
        clips["tts"] = syn
    return row, clips


def summarize_rows(rows, checkpoint: str, bands: bool, tts: bool) -> dict:
    """JAX's summary: mean / std / max of each score, the worst utterance
    by MCD."""
    worst = max(rows, key=lambda r: r["mcd"])
    summary = {
        "checkpoint": checkpoint,
        "n_utts": len(rows),
        "mcd": _stats(rows, "mcd"),
        "lsd": _stats(rows, "lsd"),
        "f0_rmse_hz": _stats(rows, "f0_rmse_hz"),
        "vde": _stats(rows, "vde"),
        "worst_utt": {"i": worst["i"], "mcd": round(worst["mcd"], 3)},
    }
    if tts:
        summary["mcd_tts_dtw"] = _stats(rows, "mcd_tts_dtw")
        summary["dur_ratio_tts"] = _stats(rows, "dur_ratio_tts")
    if bands:
        summary["lsd_bands"] = {f"q{q}": _stats(rows, f"lsd_q{q}")["mean"]
                                for q in range(4)}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", required=True,
                    help="a reference-format generator G_*.pth")
    ap.add_argument("-f", "--filelist", default=None)
    ap.add_argument("-n", "--num", type=int, default=16)
    ap.add_argument("--out", default=None, help="write full JSON here")
    ap.add_argument("--bands", action="store_true",
                    help="also report LSD per frequency quartile "
                         "(0-25/25-50/50-75/75-100%% of Nyquist)")
    ap.add_argument("--tts", action="store_true",
                    help="also synthesize each utterance from its text "
                         "(Synthesizer.infer) and report the DTW-aligned "
                         "MCD and the predicted/ground-truth duration ratio")
    ap.add_argument("--save-audio", default=None, metavar="DIR",
                    help="write ground-truth / copy-synthesis / TTS wavs "
                         "of the first 3 utterances to DIR")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.data import TextAudioDataset
    from mb_istft_vits_torch.device import disable_tf32, resolve_device
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.utils.observability import encode_wav_bytes
    from mb_istft_vits_torch.weights import load_generator_pth

    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    if not args.checkpoint.endswith((".pth", ".pt")):
        raise SystemExit(f"{args.checkpoint}: the port reads reference "
                         "generator .pth files only (no Orbax directories)")
    cfg = Config.from_json(args.config)
    d = cfg.data
    ds = TextAudioDataset(args.filelist or d.validation_files, d,
                          device_spec=True)
    n = min(args.num, len(ds))
    net_g = Synthesizer(cfg.model)
    net_g.load_state_dict(load_generator_pth(args.checkpoint))
    net_g = net_g.to(device).eval()
    multi = d.n_speakers > 1
    tts_max_frames = 0
    if args.tts:
        # one max_frames for the run: the longest ground truth with 50 %
        # duration headroom, in 256-frame steps
        longest = max(len(np.asarray(ds[i]["wav"]).reshape(-1))
                      for i in range(n))
        tts_max_frames = ((longest // d.hop_length) * 3 // 2 // 256
                          + 1) * 256
    rows = []
    for i in range(n):
        row, clips = score_utterance(net_g, ds[i], i, d, multi,
                                     bands=args.bands,
                                     tts_max_frames=tts_max_frames)
        if args.save_audio and i < 3:
            os.makedirs(args.save_audio, exist_ok=True)
            for tag, wav in clips.items():
                with open(os.path.join(args.save_audio, f"utt{i}_{tag}.wav"),
                          "wb") as fh:
                    fh.write(encode_wav_bytes(wav, d.sampling_rate))
        rows.append(row)
        print(f"[{i + 1}/{n}] mcd={row['mcd']:.2f} lsd={row['lsd']:.2f} "
              + (f"tts_dtw={row['mcd_tts_dtw']:.2f} "
                 f"dur={row['dur_ratio_tts']:.2f} " if args.tts else "")
              + f"({row['audio_s']}s)", flush=True)
    summary = summarize_rows(rows, args.checkpoint, args.bands, args.tts)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"summary": summary, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
