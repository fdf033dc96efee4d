"""Phase-spectrum analysis of synthesized audio (the JAX package's
`scripts/analyze_phase.py`: the reference's `infer old/phase_spectrum.ipynb`
as a CLI), on the port's DSP (`dsp.stft`, `torch.stft` on the CPU) and
wav reader (`data.dataset.load_wav`) instead of librosa.

Three analyses from the notebook:
  1. loudest-frame phase spectrum (wrapped + unwrapped + magnitude)
     — notebook cell 0 (`analyze_phase_spectrum`)
  2. multi-file phase comparison at the shared loudest frame
     — cell 3 (`compare_three_phases`, e.g. natural vs iSTFT-VITS decode)
  3. phase trajectory over time at the dominant frequency bin
     — cell 4 (`analyze_phase_over_time`)

Usage:
  python -m mb_istft_vits_torch.analyze_phase a.wav [b.wav c.wav ...] \
      [--labels natural vits ...] [--out-dir DIR] [--n-fft 2048]

Writes PNGs (matplotlib) and prints the per-file summary statistics
either way: dominant bin/frequency, loudest frame, inter-frame phase-
difference stddev at the dominant bin (a phase-coherence proxy —
iSTFT-head phase predictions are noisier than natural phase here).
matplotlib is imported only to write the PNGs.
"""

import argparse
import os

import numpy as np
import torch


def load_wav_mono(path: str):
    from mb_istft_vits_torch.data.dataset import load_wav

    y, sr = load_wav(path)
    if y.ndim > 1:
        y = y.mean(axis=-1)
    # load_wav returns int16-range values for PCM16 but [-1, 1] for
    # IEEE-float wavs — dividing unconditionally would mis-scale float
    # files by ~32768x and poison every magnitude panel
    if np.abs(y).max() > 1.0 + 1e-6:
        y = y / 32768.0
    return y, sr


def stft_complex(y: np.ndarray, n_fft: int, hop: int):
    """[bins, frames] complex STFT (center=True torch.stft semantics)."""
    from mb_istft_vits_torch.dsp.stft import stft

    with torch.no_grad():
        real, imag = stft(torch.from_numpy(y[None].astype(np.float32)),
                          n_fft, hop, n_fft, center=True)
    return real[0].numpy() + 1j * imag[0].numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("wavs", nargs="+")
    parser.add_argument("--labels", nargs="*", default=None)
    parser.add_argument("--out-dir", default=None,
                        help="write PNG plots here (omit: stats only)")
    parser.add_argument("--n-fft", type=int, default=2048)
    parser.add_argument("--hop", type=int, default=256)
    args = parser.parse_args(argv)
    labels = args.labels or [os.path.basename(p) for p in args.wavs]
    if len(labels) != len(args.wavs):
        parser.error(f"{len(labels)} labels for {len(args.wavs)} wavs")

    specs, srs = [], []
    for path in args.wavs:
        y, sr = load_wav_mono(path)
        specs.append(stft_complex(y, args.n_fft, args.hop))
        srs.append(sr)
        print(f"{path}: {sr} Hz, {len(y)} samples, "
              f"{specs[-1].shape[1]} frames")
    sr = srs[0]
    if len(set(srs)) > 1:
        print("warning: sampling rates differ; axes use the first file's")
    n_frames = min(s.shape[1] for s in specs)
    specs = [s[:, :n_frames] for s in specs]

    # shared loudest frame / dominant bin from the FIRST file (notebook
    # cells 3-4 pick them from the reference signal so files compare at
    # the same spot)
    mag0 = np.abs(specs[0])
    loud_frame = int(np.argmax(mag0.sum(axis=0)))
    dom_bin = int(np.argmax(mag0.sum(axis=1)))
    freqs = np.fft.rfftfreq(args.n_fft, 1.0 / sr)
    print(f"loudest frame: {loud_frame}  dominant bin: {dom_bin} "
          f"({freqs[dom_bin]:.1f} Hz)")

    for lbl, spec in zip(labels, specs):
        phase_t = np.angle(spec[dom_bin])
        dphi = np.diff(np.unwrap(phase_t))
        print(f"  {lbl}: inter-frame phase-diff std at dominant bin "
              f"{np.std(dphi):.4f} rad "
              f"(mean |mag| {np.abs(spec).mean():.4f})")

    if not args.out_dir:
        return
    os.makedirs(args.out_dir, exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # 1+2: phase spectrum at the shared loudest frame
    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    for lbl, spec in zip(labels, specs):
        col = spec[:, loud_frame]
        axes[0].plot(freqs, 20 * np.log10(np.abs(col) + 1e-9), label=lbl,
                     alpha=0.8)
        axes[1].plot(freqs, np.angle(col), label=lbl, alpha=0.6)
        axes[2].plot(freqs, np.unwrap(np.angle(col)), label=lbl, alpha=0.8)
    axes[0].set_ylabel("magnitude [dB]")
    axes[1].set_ylabel("phase [rad]")
    axes[2].set_ylabel("unwrapped phase [rad]")
    axes[2].set_xlabel("frequency [Hz]")
    for ax in axes:
        ax.legend(fontsize=8)
    fig.suptitle(f"phase spectrum @ frame {loud_frame}")
    p1 = os.path.join(args.out_dir, "phase_spectrum.png")
    fig.savefig(p1, dpi=120)
    print(f"wrote {p1}")

    # 3: phase trajectory at the dominant bin
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    t = np.arange(n_frames) * args.hop / sr
    for lbl, spec in zip(labels, specs):
        axes[0].plot(t, np.unwrap(np.angle(spec[dom_bin])), label=lbl,
                     alpha=0.8)
        axes[1].plot(t, np.abs(spec[dom_bin]), label=lbl, alpha=0.8)
    axes[0].set_ylabel(f"unwrapped phase @ {freqs[dom_bin]:.0f} Hz [rad]")
    axes[1].set_ylabel("magnitude")
    axes[1].set_xlabel("time [s]")
    for ax in axes:
        ax.legend(fontsize=8)
    p2 = os.path.join(args.out_dir, "phase_over_time.png")
    fig.savefig(p2, dpi=120)
    print(f"wrote {p2}")


if __name__ == "__main__":
    main()
