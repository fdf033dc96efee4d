"""Japanese frontend: katakana-mora → space-separated phoneme tokens (the
port's own copy of `mb_istft_vits_tpu/text/jp.py`; the symbol list, and
with it every id and `n_vocab`, must stay equal to the JAX package's).

Behavior contract: reference `text_JP/` — mora tables
(`phonemize.py:138-271`), symbol set derived from the tables + 'sp' + long
vowels (`symbols.py:47-60`), token-level (space-split) ID mapping
(`__init__.py:22,35`), pyopenjtalk g2p cleaner with placeholder handling
(`cleaners_v2.py:5-34`).
"""

from __future__ import annotations

import re
from typing import List, Sequence

# two-char moras (reference phonemize.py:139-190; symbols.py table2_jpn)
TABLE2 = {
    "キャ": "ky a", "キュ": "ky u", "キョ": "ky o",
    "ギャ": "gy a", "ギュ": "gy u", "ギョ": "gy o",
    "シャ": "sy a", "シュ": "sy u", "シェ": "sy e", "ショ": "sy o",
    "ジャ": "zy a", "ジュ": "zy u", "ジェ": "zy e", "ジョ": "zy o",
    "チャ": "ch a", "チュ": "ch u", "チェ": "ch e", "チョ": "ch o",
    "ニャ": "ny a", "ニュ": "ny u", "ニョ": "ny o",
    "ヒャ": "hy a", "ヒュ": "hy u", "ヒョ": "hy o",
    "ピャ": "py a", "ピュ": "py u", "ピョ": "py o",
    "ビャ": "by a", "ビュ": "by u", "ビョ": "by o",
    "ミャ": "my a", "ミュ": "my u", "ミョ": "my o",
    "リャ": "ry a", "リュ": "ry u", "リョ": "ry o",
    "ティ": "t i", "ディ": "d i",
    "トゥ": "t u", "ドゥ": "d u",
    "ツァ": "ts a", "ツェ": "ts e", "ツォ": "ts o",
    "スィ": "s i", "ズィ": "z i",
    "ファ": "f a", "フィ": "f i", "フェ": "f e", "フォ": "f o",
    "ウィ": "w i", "ウェ": "w e",
}

# single-char moras (reference phonemize.py:191-262; symbols.py table_jpn,
# which additionally has ヲ→o)
TABLE = {
    "ア": "a", "イ": "i", "ウ": "u", "エ": "e", "オ": "o",
    "カ": "k a", "キ": "k i", "ク": "k u", "ケ": "k e", "コ": "k o",
    "ガ": "g a", "ギ": "g i", "グ": "g u", "ゲ": "g e", "ゴ": "g o",
    "サ": "s a", "シ": "s i", "ス": "s u", "セ": "s e", "ソ": "s o",
    "ザ": "z a", "ジ": "z i", "ズ": "z u", "ゼ": "z e", "ゾ": "z o",
    "タ": "t a", "チ": "t i", "ツ": "t u", "テ": "t e", "ト": "t o",
    "ダ": "d a", "ヂ": "z i", "ヅ": "z u", "デ": "d e", "ド": "d o",
    "ナ": "n a", "ニ": "n i", "ヌ": "n u", "ネ": "n e", "ノ": "n o",
    "ハ": "h a", "ヒ": "h i", "フ": "h u", "ヘ": "h e", "ホ": "h o",
    "パ": "p a", "ピ": "p i", "プ": "p u", "ペ": "p e", "ポ": "p o",
    "バ": "b a", "ビ": "b i", "ブ": "b u", "ベ": "b e", "ボ": "b o",
    "マ": "m a", "ミ": "m i", "ム": "m u", "メ": "m e", "モ": "m o",
    "ヤ": "y a", "ユ": "y u", "ヨ": "y o",
    "ラ": "r a", "リ": "r i", "ル": "r u", "レ": "r e", "ロ": "r o",
    "ワ": "w a", "ン": "N", "ッ": "Q", "＃": "#", "ヲ": "o",
}

# symbol set (reference text_JP/symbols.py:1-62)
_pad = "_"
_punctuation = ';:,.!?¡¿—…«»“” []'
_phoneme_set = set()
for v in TABLE.values():
    _phoneme_set.update(v.split(" "))
for v in TABLE2.values():
    _phoneme_set.update(v.split(" "))
_phoneme_set.add("sp")
_phoneme_set.update(["a:", "i:", "u:", "e:", "o:"])

symbols: List[str] = [_pad] + list(_punctuation) + sorted(_phoneme_set)
SPACE_ID = symbols.index(" ")

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}


def mora2phoneme(text: str, reference_compat: bool = False) -> str:
    """Katakana mora string → phoneme token string
    (reference phonemize.py:138-271).

    Divergence from the reference (documented quirk fix): the reference
    does ``text.replace(" ", "sp")`` *before* the mora tables append
    their trailing spaces, so a space between phrases yields a glued
    token like ``sps a`` — which the space-split ID mapping then drops
    entirely, losing both the pause and the following phoneme
    (phonemize.py:263, __init__.py:22). Here the pause is held as a
    sentinel through the table pass and emitted as a proper separated
    ``sp`` token. Pass ``reference_compat=True`` to reproduce the
    reference's exact (buggy) tokenization — e.g. when serving a
    checkpoint trained with the reference frontend, whose model never
    saw pauses at those positions."""
    if reference_compat:
        text = text.replace(" ", "sp")
    else:
        text = text.replace(" ", "▁")
    for m, p in TABLE2.items():
        text = text.replace(m, p + " ")
    for m, p in TABLE.items():
        # ヲ exists only in the reference's symbols.py table — its runtime
        # mora2phoneme_jpn table lacks it, so a raw ヲ survives as a glued
        # token and is dropped at ID mapping. compat mode must reproduce
        # that exactly (the serving cleaner maps ヲ→オ *before* this, so
        # real text is unaffected either way).
        if reference_compat and m == "ヲ":
            continue
        text = text.replace(m, p + " ")
    text = text.rstrip()
    text = text.replace(" ー", ": ")
    if reference_compat:
        return text
    text = text.replace("▁", "sp ")
    return " ".join(text.split())


# ---------------------------------------------------------------------
# IPA variant (reference phonemize.py:3-136 mora2phoneme_text2phoneme).
# Rather than a second hand-written kana table, the IPA tables are derived
# from the romaji tables above through a phone-level rewrite (plus the
# handful of morae whose romaji is ambiguous, e.g. チ vs ティ both "t i").
# ---------------------------------------------------------------------
# the reference writes ç as DECOMPOSED 'c' + U+0327 combining cedilla
# (phonemize.py table bytes) — match it exactly so emitted token strings
# compare equal
_CCEDILLA = "c\u0327"
_IPA_PHONE = {
    "u": "ɯ", "f": "ɸ", "y": "j", "r": "ɾ", "N": "ɴ",
    "ky": "k j", "gy": "g j", "ny": "n j", "hy": _CCEDILLA + " j",
    "py": "p j",
    "by": "b j", "my": "m j", "ry": "ɾ j",
    "sy": "ɕ", "zy": "d ʑ", "ch": "t ɕ", "ts": "t s",
}
_IPA_CONTEXT = {  # (consonant, following vowel) -> IPA consonant
    ("s", "i"): "ɕ", ("z", "i"): "d ʑ", ("t", "i"): "t ɕ",
    ("t", "u"): "t s", ("h", "i"): _CCEDILLA, ("h", "u"): "ɸ",
}
_IPA_MORA_EXCEPTIONS = {
    # morae whose romaji collides with another mora's (phonemize.py:175-189)
    "ティ": "t i", "ディ": "d i", "トゥ": "t ɯ", "ドゥ": "d ɯ",
    "スィ": "s i", "ズィ": "z i",
    # デュ exists only in the reference IPA table (no romaji counterpart
    # to derive it from, phonemize.py table2)
    "デュ": "d j ɯ",
    # only ワ is the compressed [ɰᵝ]; ウィ/ウェ stay plain w (:54,:113)
    "ワ": "ɰᵝ a",
}


def _romaji_to_ipa(romaji: str) -> str:
    toks = romaji.split(" ")
    out = []
    for i, t in enumerate(toks):
        nxt = toks[i + 1] if i + 1 < len(toks) else ""
        if (t, nxt) in _IPA_CONTEXT:
            out.append(_IPA_CONTEXT[(t, nxt)])
        else:
            out.append(_IPA_PHONE.get(t, t))
    return " ".join(out)


IPA_TABLE2 = {
    k: _IPA_MORA_EXCEPTIONS.get(k, _romaji_to_ipa(v))
    for k, v in TABLE2.items()
}
# morae that exist ONLY in the reference IPA table (no romaji source row)
IPA_TABLE2["デュ"] = _IPA_MORA_EXCEPTIONS["デュ"]
IPA_TABLE = {
    k: _IPA_MORA_EXCEPTIONS.get(k, _romaji_to_ipa(v))
    for k, v in TABLE.items() if k != "ッ"
}


def mora2ipa(text: str) -> str:
    """Katakana mora string → IPA phone tokens (the reference's IPA
    variant, phonemize.py:3-136): spaces become a '▁' word-boundary
    token, 'ー' lengthens the preceding vowel with 'ː'-style ':', and
    sokuon ッ geminates the following consonant (':' after it) or
    becomes a glottal stop ʔ before a vowel / word boundary / the end.

    Note: this is a standalone phonemizer (`Phonemizer("ipa")`), matching
    the reference where the IPA variant exists beside — but is not wired
    into — the jpn symbol table; its IPA tokens are NOT part of
    `symbols`, so its output is not meant for `cleaned_text_to_sequence`.
    """
    text = text.replace(" ", "▁")
    for m, p in IPA_TABLE2.items():
        text = text.replace(m, p + " ")
    for m, p in IPA_TABLE.items():
        text = text.replace(m, p + " ")
    text = text.rstrip()
    text = text.replace(" ー", ": ")
    # sokuon (phonemize.py:132-134 behavior, but boundary-aware: the
    # '▁' word boundary stops gemination — a word-final ッ is a glottal
    # stop, it must not geminate the next word's consonant)
    text = re.sub("ッ([^aiɯeo▁]*) ([aiɯeo])", r"\1: \2", text)
    text = re.sub("ッ ?([aiɯeo])", r"ʔ \1", text)
    text = re.sub("ッ(?=▁)", "ʔ ", text)
    text = re.sub("ッ$", "ʔ", text)
    text = text.replace("▁", "▁ ")
    return " ".join(text.split())


class Phonemizer:
    """reference phonemize.py:273-279 — selectable mora→phoneme backend."""

    def __init__(self, variant: str = "jpn"):
        self.mora2phoneme = {"jpn": mora2phoneme, "ipa": mora2ipa}[variant]

    def __call__(self, text: str) -> str:
        return self.mora2phoneme(text)


def japanese_cleaners(text: str) -> str:
    """reference text_JP/cleaners.py:5-6"""
    return mora2phoneme(text)


def openjtalk_cleaner(text: str) -> str:
    """pyopenjtalk g2p with <cough>/bracket placeholders
    (reference text_JP/cleaners_v2.py:5-34). Needs optional pyopenjtalk.

    Reference-inherited quirk (kept for parity, documented): pyopenjtalk
    g2p emits phonemes outside the mora-table symbol set (sh, j, cl, ty,
    dy, v, devoiced A/I/U/E/O...), and the split-and-filter ID mapping
    silently DROPS them — e.g. 'ちょっと' → 'ch o cl t o' loses the
    geminate 'cl'. For raw Japanese text prefer
    `japanese_cleaners_revised` (the serving pipeline's cleaner), which
    converts to katakana first and phonemizes through the mora tables,
    staying inside `symbols`."""
    try:
        import pyopenjtalk  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "openjtalk_cleaner needs the optional 'pyopenjtalk' package."
        ) from e
    replacements = {
        "<cough>": "__COUGH__",
        "{cough}": "__COUGH__",
        "[": "__LBRACKET__",
        "]": "__RBRACKET__",
    }
    for old, new in replacements.items():
        text = text.replace(old, new)
    phonemes = pyopenjtalk.g2p(text)
    phonemes = phonemes.replace("pau", "sp")
    phonemes = phonemes.replace("__COUGH__", " <cough> ")
    phonemes = phonemes.replace("__LBRACKET__", " [ ")
    phonemes = phonemes.replace("__RBRACKET__", " ] ")
    return " ".join(phonemes.split())


def japanese_cleaners_revised(text: str) -> str:
    """RAW Japanese text (kanji/kana mix) → phoneme tokens: the reference
    SERVING pipeline's cleaner (synthesis_module.py:34-64
    `_japanese_cleaner_revised`) — without it no cleaner can tokenize
    anything but pre-katakana-ized input. Splits on {cough}/<cough>/
    [...] placeholders and 、。 punctuation (→ separated `sp` pauses),
    converts each plain segment to katakana via pyopenjtalk
    g2p(kana=True) with ヲ→オ, then phonemizes through the mora tables.
    Needs optional pyopenjtalk."""
    try:
        import pyopenjtalk  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "japanese_cleaners_revised needs the optional 'pyopenjtalk' "
            "package; pre-phonemized input (cleaned_text) works without it."
        ) from e

    parts = re.split(r"({cough}|<cough>|\[.*?\]|[、。])", text)
    phoneme_parts: List[str] = []
    for part in parts:
        if not part or part.isspace():
            continue
        if part.startswith("[") and part.endswith("]") and len(part) > 2:
            content = part[1:-1]
            if not content:
                phoneme_parts.append("[ ]")
            else:
                kana = pyopenjtalk.g2p(content, kana=True).replace("ヲ", "オ")
                phoneme_parts.append(f"[ {mora2phoneme(kana)} ]")
            continue
        if part in ("{cough}", "<cough>"):
            phoneme_parts.append("<cough>")
            continue
        if part in "、。":
            phoneme_parts.append("sp")
            continue
        kana = pyopenjtalk.g2p(part, kana=True).replace("ヲ", "オ")
        phoneme_parts.append(mora2phoneme(kana))
    return re.sub(r"\s+", " ", " ".join(phoneme_parts)).strip()


_CLEANERS = {
    "japanese_cleaners": japanese_cleaners,
    "japanese_cleaners_revised": japanese_cleaners_revised,
    "openjtalk_cleaner": openjtalk_cleaner,
}


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        text = _CLEANERS[name](text)
    return text


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Token-level (space-split) mapping (reference text_JP/__init__.py:10-25)."""
    clean_text = _clean_text(text, cleaner_names)
    return [
        _symbol_to_id[s] for s in clean_text.split(" ") if s in _symbol_to_id
    ]


def cleaned_text_to_sequence(cleaned_text: str) -> List[int]:
    return [
        _symbol_to_id[s]
        for s in cleaned_text.split(" ")
        if s in _symbol_to_id
    ]


def sequence_to_text(sequence: Sequence[int]) -> str:
    return "".join(_id_to_symbol[i] for i in sequence)
