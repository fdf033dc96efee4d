"""The synthetic corpus renderer (the port's copy of the renderer in the
JAX package's `scripts/make_corpus.py`): phoneme text to audio by a
deterministic source-filter formant synthesizer.

Phoneme identity drives the acoustics: vowels get formant sets,
fricatives shaped noise bands, stops a closure and a burst, stress marks
move pitch and duration, so the text-audio alignment is monotonic and
learnable. `_plan` reads the IPA of the cleaned LJSpeech filelists,
`_plan_jp` the UUDB phoneme tokens, and `_speaker_profile` gives each of
the 12 UUDB speakers its own base F0 and formant scale, so voice
conversion has a ground truth: the source utterance re-rendered in the
target's voice under the source's duration seed (`eval_vc`).

`render(..., sr=)` takes the sampling rate as a keyword (22.05 kHz by
default, 16 kHz for UUDB) where the JAX script reads a module-level `SR`;
the samples are the script's, bit for bit. `python -m
mb_istft_vits_torch.make_corpus` writes a corpus with it.
"""

from __future__ import annotations

import hashlib

import numpy as np
from scipy.signal import lfilter

SR = 22050  # LJSpeech; UUDB is 16 kHz

# ---------------------------------------------------------------- phone map
# (F1, F2, F3) in Hz for voiced sonorants (Peterson&Barney-style values).
VOWELS = {
    "i": (280, 2250, 2890), "ɪ": (400, 1920, 2560), "e": (400, 2100, 2700),
    "ɛ": (550, 1770, 2490), "æ": (690, 1660, 2490), "a": (750, 1300, 2500),
    "ɑ": (710, 1100, 2540), "ɒ": (590, 880, 2540), "ɔ": (590, 880, 2540),
    "o": (450, 800, 2830), "ʊ": (450, 1030, 2380), "u": (310, 870, 2250),
    "ʌ": (620, 1220, 2550), "ə": (500, 1500, 2500), "ɚ": (490, 1350, 1690),
    "ɝ": (490, 1350, 1690), "ɐ": (650, 1300, 2500), "ᵻ": (450, 1800, 2550),
    "y": (280, 2100, 2400), "ʏ": (400, 1800, 2300), "ø": (450, 1600, 2400),
    "ɵ": (500, 1400, 2400), "œ": (550, 1500, 2400), "ɶ": (650, 1400, 2400),
    "ɨ": (320, 1650, 2600), "ʉ": (320, 1300, 2300), "ɯ": (300, 1300, 2300),
    "ɤ": (460, 1200, 2500), "ɘ": (490, 1600, 2500), "ɞ": (550, 1350, 2450),
    "ɜ": (560, 1400, 2450),
}
GLIDES = {
    "l": (360, 1300, 2700), "ɫ": (380, 900, 2600), "ɭ": (360, 1300, 2700),
    "ʎ": (300, 2000, 2700), "ɹ": (310, 1060, 1380), "ɻ": (310, 1060, 1380),
    "r": (310, 1060, 1380), "ɾ": (310, 1060, 1380), "ɺ": (340, 1200, 2500),
    "ʀ": (400, 1100, 2200), "ʁ": (450, 1100, 2200), "ɽ": (320, 1100, 1500),
    "w": (290, 610, 2150), "ʍ": (290, 610, 2150), "j": (280, 2250, 2890),
    "ɥ": (280, 2000, 2400), "ʋ": (300, 900, 2300), "ⱱ": (300, 900, 2300),
}
NASALS = {
    "m": (250, 1000, 2200), "n": (250, 1500, 2500), "ŋ": (250, 2000, 2700),
    "ɱ": (250, 1000, 2200), "ɳ": (250, 1500, 2500), "ɲ": (250, 1800, 2600),
    "ɴ": (250, 1700, 2500), "N": (250, 1700, 2500),
}
# fricatives: (noise center Hz, bandwidth Hz, voiced?)
FRICS = {
    "s": (6500, 2500, False), "z": (6500, 2500, True),
    "ʃ": (3300, 2200, False), "ʒ": (3300, 2200, True),
    "ʂ": (3600, 2200, False), "ʐ": (3600, 2200, True),
    "ɕ": (4200, 2400, False), "ʑ": (4200, 2400, True),
    "f": (4500, 5000, False), "v": (4500, 5000, True),
    "θ": (5200, 5000, False), "ð": (5200, 5000, True),
    "ç": (3800, 2800, False), "ʝ": (3800, 2800, True),
    "x": (2600, 2200, False), "ɣ": (2600, 2200, True),
    "χ": (2200, 2000, False), "h": (1600, 2600, False),
    "ɦ": (1600, 2600, True), "ħ": (1400, 2000, False),
    "ʕ": (1200, 1500, True), "ɸ": (3800, 4500, False),
    "β": (3800, 4500, True), "ɬ": (4600, 3200, False),
    "ɮ": (4600, 3200, True), "ʜ": (1500, 2200, False),
    "ʢ": (1200, 1500, True), "ɧ": (3000, 2800, False),
}
# stops: (burst center Hz, voiced?)
STOPS = {
    "p": (900, False), "b": (900, True), "t": (4000, False),
    "d": (4000, True), "k": (2200, False), "g": (2200, True),
    "ɡ": (2200, True), "q": (1800, False), "ɢ": (1800, True),
    "ʔ": (500, False), "ʡ": (700, False), "c": (3200, False),
    "ɟ": (3200, True), "ʈ": (3800, False), "ɖ": (3800, True),
    "ɓ": (900, True), "ɗ": (3800, True), "ʄ": (3200, True),
    "ɠ": (2200, True), "ʛ": (1800, True), "ʘ": (1200, False),
    "ǀ": (4000, False), "ǁ": (3500, False), "ǂ": (3200, False),
    "ǃ": (2500, False),
}
AFFRICATES = {"ʧ": ("t", "ʃ"), "ʤ": ("d", "ʒ")}
SILENCE = {",": 0.14, ";": 0.14, ":": 0.12, ".": 0.22, "!": 0.22, "?": 0.22,
           "—": 0.18, "…": 0.25, "¡": 0.0, "¿": 0.0, '"': 0.0, "«": 0.0,
           "»": 0.0, "“": 0.0, "”": 0.0, " ": 0.045}
# prosody diacritics handled inline: ˈ ˌ ː ˑ ʼ ʴ ʰ ʱ ʲ ʷ ˠ ˤ ˞ ↓ ↑ → ↗ ↘ ̩


def _resonator(x: np.ndarray, f: float, bw: float, sr: int) -> np.ndarray:
    """Two-pole resonator, unity gain at the pole frequency."""
    r = np.exp(-np.pi * bw / sr)
    a1 = 2.0 * r * np.cos(2.0 * np.pi * f / sr)
    a2 = -r * r
    b0 = (1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(4.0 * np.pi * f / sr)
                             + r * r)
    return lfilter([b0], [1.0, -a1, -a2], x)


def _formant_filter(x: np.ndarray, formants, sr: int,
                    bws=(90, 110, 170)):
    y = x
    for f, bw in zip(formants, bws):
        y = _resonator(y, f, bw, sr)
    return y


def _noise_band(n: int, center: float, bw: float, rng,
                sr: int) -> np.ndarray:
    x = rng.standard_normal(n)
    return _resonator(x, min(center, sr / 2 - 500), bw, sr)


def _pulse_train(f0: np.ndarray, phase0: float, sr: int):
    """Impulse train from an instantaneous-f0 array (phase accumulator
    starting at `phase0` cycles), with a -12 dB/oct glottal tilt (two
    one-pole lowpasses). Returns (signal, phase-in-cycles array) so the
    caller can keep glottal phase CONTINUOUS across segments — a phase
    reset at every mora boundary (~12/s) destroys the periodicity that
    pitch trackers (and listeners) rely on."""
    phase = phase0 + np.cumsum(f0 / sr)
    imp = np.zeros(len(f0))
    k0, k1 = int(np.floor(phase0)) + 1, int(np.floor(phase[-1]))
    idx = np.searchsorted(phase, np.arange(k0, k1 + 1))
    imp[idx[idx < len(imp)]] = 1.0
    for _ in range(2):
        imp = lfilter([0.15], [1.0, -0.85], imp)
    return imp, phase


def _env(n: int, sr: int, attack: float = 0.008,
         release: float = 0.015) -> np.ndarray:
    e = np.ones(n)
    na, nr = int(attack * sr), int(release * sr)
    if na and na < n:
        e[:na] = np.linspace(0, 1, na)
    if nr and nr < n:
        e[-nr:] = np.linspace(1, 0, nr)
    return e


class Segment:
    __slots__ = ("kind", "dur", "params", "amp", "pitch_mul")

    def __init__(self, kind, dur, params=None, amp=1.0, pitch_mul=1.0):
        self.kind, self.dur, self.params = kind, dur, params
        self.amp, self.pitch_mul = amp, pitch_mul


def _plan(text: str, rng) -> list:
    """IPA string -> segment plan. Durations are phone-class-typical with
    seeded jitter; stress/length diacritics modulate the NEXT vowel /
    PREVIOUS phone like their phonetic function."""
    segs: list = []
    stress = 0.0
    for ch in text:
        j = 0.8 + 0.4 * rng.random()
        if ch in ("ˈ", "ˌ"):
            stress = 1.0 if ch == "ˈ" else 0.5
            continue
        if ch in ("ː", "ˑ"):
            if segs and segs[-1].kind != "sil":
                segs[-1].dur *= 1.6 if ch == "ː" else 1.3
            continue
        if ch in SILENCE:
            d = SILENCE[ch]
            if d > 0:
                segs.append(Segment("sil", d * j))
            continue
        if ch in AFFRICATES:
            a, b = AFFRICATES[ch]
            segs.append(Segment("stop", 0.045 * j, STOPS[a]))
            segs.append(Segment("fric", 0.06 * j, FRICS[b]))
            continue
        if ch in VOWELS:
            amp = 1.0 + 0.25 * stress
            pm = 1.0 + 0.18 * stress
            segs.append(Segment("vowel", (0.085 + 0.03 * stress) * j,
                                VOWELS[ch], amp, pm))
            stress = 0.0
        elif ch in GLIDES:
            segs.append(Segment("glide", 0.055 * j, GLIDES[ch], 0.7))
        elif ch in NASALS:
            segs.append(Segment("nasal", 0.06 * j, NASALS[ch], 0.6))
        elif ch in FRICS:
            segs.append(Segment("fric", 0.075 * j, FRICS[ch]))
        elif ch in STOPS:
            segs.append(Segment("stop", 0.055 * j, STOPS[ch]))
        # anything else (tone letters, superscripts) is prosodic decoration:
        # skipped, matching its zero acoustic footprint here
    return segs


# ------------------------------------------------------------- JP (UUDB)
# Token-level planner for the JP cleaned format (space-separated morae,
# reference text_JP japanese_cleaners output): vowels a i u e o (+`:`
# length), consonant onsets, moraic N, geminate Q (closure silence),
# `sp` pauses, `[`/`]` accentual-phrase brackets (pitch reset), and
# nonverbal tags (<breath>/<sigh>/<cough>).
JP_VOWELS = {
    "a": (750, 1300, 2500), "i": (280, 2250, 2890), "u": (300, 1300, 2300),
    "e": (450, 2000, 2600), "o": (450, 800, 2830),
}
JP_ONSETS: dict = {
    # token -> list of (kind, dur, params_table_entry)
    "k": [("stop", 0.050, STOPS["k"])], "g": [("stop", 0.045, STOPS["g"])],
    "t": [("stop", 0.050, STOPS["t"])], "d": [("stop", 0.045, STOPS["d"])],
    "p": [("stop", 0.050, STOPS["p"])], "b": [("stop", 0.045, STOPS["b"])],
    "s": [("fric", 0.075, FRICS["s"])], "z": [("stop", 0.02, STOPS["d"]),
                                              ("fric", 0.05, FRICS["z"])],
    "h": [("fric", 0.065, FRICS["h"])], "f": [("fric", 0.065, FRICS["ɸ"])],
    "sy": [("fric", 0.075, FRICS["ʃ"])],
    "zy": [("stop", 0.02, STOPS["d"]), ("fric", 0.05, FRICS["ʒ"])],
    "ch": [("stop", 0.035, STOPS["t"]), ("fric", 0.045, FRICS["ʃ"])],
    "ts": [("stop", 0.035, STOPS["t"]), ("fric", 0.045, FRICS["s"])],
    "m": [("nasal", 0.06, NASALS["m"])], "n": [("nasal", 0.055, NASALS["n"])],
    "r": [("glide", 0.04, GLIDES["ɾ"])], "w": [("glide", 0.05, GLIDES["w"])],
    "y": [("glide", 0.05, GLIDES["j"])],
    "v": [("fric", 0.06, FRICS["v"])],
}
# palatalized onsets Cy = C + j-glide
for _c in ("k", "g", "t", "d", "p", "b", "m", "n", "r", "h"):
    JP_ONSETS[_c + "y"] = JP_ONSETS.get(
        _c + "y", JP_ONSETS[_c] + [("glide", 0.035, GLIDES["j"])])
JP_NONVERBAL = {"<breath>": 0.25, "<sigh>": 0.35, "<cough>": 0.18,
                "<laugh>": 0.3, "<noise>": 0.2}


def _plan_jp(text: str, rng) -> list:
    """UUDB JP phoneme tokens -> segment plan (token-level, not char)."""
    segs: list = []
    phrase_pm = 1.0
    for tok in text.split():
        j = 0.85 + 0.3 * rng.random()
        if tok == "[":
            phrase_pm = 1.12  # accentual-phrase pitch reset (rise)
            continue
        if tok == "]":
            phrase_pm = 0.95
            continue
        if tok == "sp":
            segs.append(Segment("sil", 0.14 * j))
            continue
        if tok == "Q":  # geminate closure
            segs.append(Segment("sil", 0.07 * j))
            continue
        if tok in JP_NONVERBAL:
            segs.append(Segment("fric", JP_NONVERBAL[tok] * j,
                                (1200, 2000, False), 0.35))
            continue
        if tok == "N":  # moraic nasal: a full mora of murmur
            segs.append(Segment("nasal", 0.085 * j, NASALS["ɴ"], 0.6,
                                phrase_pm))
            continue
        base = tok.rstrip(":")
        long_v = tok.endswith(":")
        if base in JP_VOWELS:
            dur = 0.085 * (1.7 if long_v else 1.0)
            segs.append(Segment("vowel", dur * j, JP_VOWELS[base], 1.0,
                                phrase_pm))
            phrase_pm = max(0.97 * phrase_pm, 0.9)  # within-phrase declination
            continue
        for kind, dur, params in JP_ONSETS.get(base, ()):
            segs.append(Segment(kind, dur * j, params, 1.0, phrase_pm))
        # unknown tokens fall through silently (zero acoustic footprint)
    return segs


def _scale_formants(params, kind: str, fs: float):
    """Scale a segment's resonance frequencies by the speaker's
    vocal-tract factor (shorter tract -> higher formants)."""
    if fs == 1.0 or params is None:
        return params
    if kind in ("vowel", "glide", "nasal"):
        return tuple(f * fs for f in params)
    if kind == "fric":
        c, bw, v = params
        return (c * fs, bw, v)
    if kind == "stop":
        c, v = params
        return (c * fs, v)
    return params


def _segments(text: str, utt_id: str, planner):
    """The segment plan of `text` and the generator seeded by `utt_id`
    that drew it (render draws its noise from it next)."""
    seed = int.from_bytes(hashlib.sha1(utt_id.encode()).digest()[:4], "big")
    rng = np.random.default_rng(seed)
    return planner(text, rng) or [Segment("sil", 0.3)], rng


def rendered_samples(text: str, utt_id: str, planner=_plan, *,
                     sr: int = SR) -> int:
    """The length of `render`'s output, from the plan alone: 50 ms of
    lead-in and of tail around the segments."""
    segs, _ = _segments(text, utt_id, planner)
    return 2 * int(0.05 * sr) + sum(max(int(s.dur * sr), 8) for s in segs)


def render(text: str, utt_id: str, base_f0: float = 185.0,
           formant_scale: float = 1.0, planner=_plan, *,
           sr: int = SR) -> np.ndarray:
    """`text` (IPA for `_plan`, UUDB phoneme tokens for `_plan_jp`) as a
    float waveform at `sr`, peak 0.6, deterministic in `utt_id`."""
    segs, rng = _segments(text, utt_id, planner)
    total = sum(s.dur for s in segs) + 0.1
    n_total = int(total * sr)
    out = np.zeros(n_total + sr)  # slack, trimmed below
    # phrase-level declination + slow wobble
    t = 0.05  # lead-in silence
    pos = int(t * sr)
    dur_sum = sum(s.dur for s in segs)
    elapsed = 0.0
    phase0 = 0.0  # glottal phase in cycles, continuous across segments
    for s in segs:
        n = max(int(s.dur * sr), 8)
        if s.kind == "sil":
            pos += n
            elapsed += s.dur
            continue
        params = _scale_formants(s.params, s.kind, formant_scale)
        decl = 1.15 - 0.3 * (elapsed / max(dur_sum, 1e-6))
        f0 = base_f0 * decl * s.pitch_mul * (
            1.0 + 0.02 * np.sin(2 * np.pi * 3.1 * (elapsed + np.arange(n) / sr))
        )
        if s.kind in ("vowel", "glide", "nasal"):
            src, phase = _pulse_train(f0, phase0, sr)
            phase0 = float(phase[-1])
            y = _formant_filter(src, params, sr)
            if s.kind == "nasal":
                y = lfilter([0.25], [1.0, -0.75], y)  # murmur lowpass
            # normalize the segment to a speech-like RMS: the formant
            # filter's passband gain is ~1e-4, so unnormalized vowels sat
            # ~80 dB below the consonant noise bursts after the global
            # peak normalization — inaudible vowels, and every pitch
            # tracker gated them out as silence
            y *= 0.18 / (np.sqrt(np.mean(y**2)) + 1e-9)
            # explicit fundamental partial at ~-7 dB vs the segment: real
            # glottal flow is strongest at f0, but the formant bandpasses
            # (all >= ~250 Hz) strip it from the impulse train — without
            # it, pitch trackers (utils/metrics.yin_f0) lock onto
            # formant-region harmonics on these renders
            y = y + 0.08 * np.sin(2 * np.pi * phase)
            y *= s.amp
        elif s.kind == "fric":
            center, bw, voiced = params
            y = 0.25 * _noise_band(n, center, bw, rng, sr)
            if voiced:
                src, phase = _pulse_train(f0, phase0, sr)
                phase0 = float(phase[-1])
                bar = _formant_filter(
                    src,
                    _scale_formants((300, 1400, 2500), "vowel",
                                    formant_scale), sr)
                bar *= 0.10 / (np.sqrt(np.mean(bar**2)) + 1e-9)
                y = 0.6 * y + bar
        else:  # stop: closure then burst
            center, voiced = params
            y = np.zeros(n)
            nb = min(int(0.012 * sr), n)
            y[-nb:] = 0.8 * _noise_band(nb, center, 1800, rng, sr)
            if voiced:
                src, phase = _pulse_train(f0, phase0, sr)
                phase0 = float(phase[-1])
                bar = _formant_filter(
                    src,
                    _scale_formants((250, 1200, 2400), "vowel",
                                    formant_scale), sr)
                y += 0.08 / (np.sqrt(np.mean(bar**2)) + 1e-9) * bar
        y = y[:n] * _env(n, sr)
        out[pos:pos + n] += y
        pos += n
        elapsed += s.dur
    out = out[:pos + int(0.05 * sr)]
    peak = np.max(np.abs(out)) + 1e-9
    return (0.6 / peak) * out


# Per-speaker voice profiles for the 12 UUDB speakers: a wide, decorrelated
# spread of base f0 (105-250 Hz) and vocal-tract formant scale (0.88-1.15),
# deterministic per sid. The (sid*5)%12 permutation decorrelates the two
# dimensions so voice-conversion evidence can separate pitch from timbre.
def _speaker_profile(sid: int) -> tuple:
    f0 = 105.0 + 13.0 * sid
    fs = 0.88 + 0.024 * ((sid * 5) % 12)
    return f0, fs
