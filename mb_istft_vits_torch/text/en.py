"""English/IPA character-level frontend.

Behavior contract: reference `text/symbols.py` (pad + punctuation + letters
+ IPA), `text/cleaners.py` (abbreviation expansion, lowercasing,
espeak-phonemizer cleaners) and `text/__init__.py` ID mapping.

The espeak-backed cleaners require the optional `phonemizer` package; the
`cleaned_text` path (all shipped configs) needs no external deps.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence

# symbol set (reference text/symbols.py:6-16)
_pad = "_"
_punctuation = ';:,.!?¡¿—…"«»“” '
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_letters_ipa = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤ"
    "ʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
symbols: List[str] = [_pad] + list(_punctuation) + list(_letters) + list(
    _letters_ipa
)
SPACE_ID = symbols.index(" ")

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    """unidecode equivalent via NFKD fold (unidecode is optional)."""
    try:
        from unidecode import unidecode  # type: ignore

        return unidecode(text)
    except ImportError:
        return (
            unicodedata.normalize("NFKD", text)
            .encode("ascii", "ignore")
            .decode("ascii")
        )


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def _phonemize(text: str, **kwargs) -> str:
    try:
        from phonemizer import phonemize  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "english_cleaners/english_cleaners2 need the optional "
            "'phonemizer' package (espeak backend). Use pre-phonemized "
            "filelists with cleaned_text=true instead."
        ) from e
    return phonemize(text, language="en-us", backend="espeak", strip=True,
                     **kwargs)


def english_cleaners(text: str) -> str:
    text = expand_abbreviations(lowercase(convert_to_ascii(text)))
    return collapse_whitespace(_phonemize(text))


def english_cleaners2(text: str) -> str:
    """+ punctuation + stress (reference text/cleaners.py:93-100)."""
    text = expand_abbreviations(lowercase(convert_to_ascii(text)))
    return collapse_whitespace(
        _phonemize(text, preserve_punctuation=True, with_stress=True)
    )


_CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "english_cleaners2": english_cleaners2,
}


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        text = _CLEANERS[name](text)
    return text


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Char-level mapping (reference text/__init__.py:11-25)."""
    clean_text = _clean_text(text, cleaner_names)
    return [_symbol_to_id[s] for s in clean_text if s in _symbol_to_id]


def cleaned_text_to_sequence(cleaned_text: str) -> List[int]:
    return [_symbol_to_id[s] for s in cleaned_text if s in _symbol_to_id]


def sequence_to_text(sequence: Sequence[int]) -> str:
    return "".join(_id_to_symbol[i] for i in sequence)
