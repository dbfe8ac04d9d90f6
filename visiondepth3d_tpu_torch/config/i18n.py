"""Message catalog and languages.

The port's copy of ``visiondepth3d_tpu/config/i18n.py``, with its own copy
of the five language packs (``languages/{en,fr,de,es,ja}.json``, the
reference's packs, VisionDepth3D.py:88-110): ``set_language`` + ``t`` with
English fallback, ``th`` for the CLI's help strings, and ``catalog`` for a
language without touching the global one.
"""

from __future__ import annotations

import json
from pathlib import Path

_LANG_DIR = Path(__file__).resolve().parent / "languages"
_current: dict = {}
_fallback: dict = {}
_lang = "en"


def available_languages() -> list[str]:
    return sorted(p.stem for p in _LANG_DIR.glob("*.json"))


def set_language(lang: str) -> None:
    global _current, _fallback, _lang
    _fallback = json.loads((_LANG_DIR / "en.json").read_text())
    path = _LANG_DIR / f"{lang}.json"
    _current = json.loads(path.read_text()) if path.exists() else {}
    _lang = lang


def t(key: str, **fmt) -> str:
    if not _fallback:
        set_language(_lang)
    msg = _current.get(key, _fallback.get(key, key))
    return msg.format(**fmt) if fmt else msg


def catalog(lang: str | None = None, prefixes: tuple[str, ...] = ()) -> dict:
    """The merged en-fallback catalog of ``lang``, without touching the
    global language. ``prefixes`` filters key namespaces."""
    base = json.loads((_LANG_DIR / "en.json").read_text())
    if lang and lang != "en":
        p = _LANG_DIR / f"{lang}.json"
        if p.exists():
            base.update(json.loads(p.read_text()))
    if prefixes:
        base = {k: v for k, v in base.items() if k.startswith(prefixes)}
    return base


def current_language() -> str:
    return _lang


def th(text: str) -> str:
    """Translate a CLI help string, keyed by the English text itself
    (``help.<english>`` in the non-en packs); a missing translation falls
    back to the English."""
    if not _fallback:
        set_language(_lang)
    return _current.get("help." + text, text)
