"""Text frontend (host-side).

The config's `data.text_module` selects the frontend, as in the reference
(data_utils.py:33-36): "text" is English/IPA, "text_JP" Japanese.
"""

from __future__ import annotations

from typing import List, Sequence

from mb_istft_vits_torch.text import en, jp

_MODULES = {"text": en, "en": en, "text_JP": jp, "jp": jp}


def get_module(text_module: str):
    try:
        return _MODULES[text_module]
    except KeyError:
        raise ValueError(f"Unknown text_module {text_module!r}; expected one "
                         f"of {sorted(_MODULES)}") from None


def get_symbols(text_module: str = "text") -> List[str]:
    return get_module(text_module).symbols


def text_to_sequence(text: str, cleaner_names: Sequence[str],
                     text_module: str = "text") -> List[int]:
    return get_module(text_module).text_to_sequence(text, cleaner_names)


def cleaned_text_to_sequence(cleaned_text: str,
                             text_module: str = "text") -> List[int]:
    return get_module(text_module).cleaned_text_to_sequence(cleaned_text)


def intersperse(lst: List[int], item: int = 0) -> List[int]:
    """Insert blank tokens between symbols (reference commons.py:24-27)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def frontend_ids(text: str, text_module: str, text_cleaners,
                 add_blank: bool, cleaned_text: bool) -> List[int]:
    """(cleaned_)text_to_sequence + optional blank interspersal
    (reference data_utils.py:89-98)."""
    if cleaned_text:
        ids = cleaned_text_to_sequence(text, text_module)
    else:
        ids = text_to_sequence(text, text_cleaners, text_module)
    if add_blank:
        ids = intersperse(ids, 0)
    return ids
