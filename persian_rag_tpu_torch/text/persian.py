"""Persian text normalization and tokenization (host-side, first-party).

A copy of ``persian_rag_tpu.text.persian`` (stdlib only): the port imports
nothing of the JAX package.

Behavior-compatible replacement for the reference's hazm-backed
PersianTextProcessor (reference: src/utils.py:13-41). hazm is a trained
Python NLP stack; the reference itself falls back to regex splits whenever
hazm fails (reference: src/chunking.py:94-97, :139-140), so a deterministic
regex implementation covers the same behavioral envelope with no model
downloads:

* whitespace / newline collapse (identical to src/utils.py:24-26),
* Arabic -> Persian character folding (ي→ی, ك→ک, ...), the core of
  hazm's character_refinement,
* Arabic/ASCII diacritic stripping,
* word tokenization splitting punctuation from words,
* sentence tokenization on Persian/Latin terminators keeping the
  delimiter.
"""
from __future__ import annotations

import re
from typing import List

# Arabic presentation forms -> Persian canonical characters.
_CHAR_FOLD = {
    "ي": "ی",  # ي -> ی
    "ى": "ی",  # ى -> ی
    "ك": "ک",  # ك -> ک
    "ؤ": "و",  # ؤ -> و
    "ة": "ه",  # ة -> ه
    "أ": "ا",  # أ -> ا
    "إ": "ا",  # إ -> ا
    "آ": "آ",  # آ stays
}
_FOLD_RE = re.compile("|".join(map(re.escape, _CHAR_FOLD)))

# Arabic diacritics (tashkeel) + tatweel.
_DIACRITICS_RE = re.compile(r"[ً-ٰٟـ]")

_WS_RE = re.compile(r"\s+")
_NL_RE = re.compile(r"\n+")

# Words (\w already covers Persian/Arabic letters and digits in Unicode
# mode; ZWNJ joins compound words) or a single punctuation/symbol char.
_WORD_RE = re.compile(r"[\w‌]+|[^\w\s]", re.UNICODE)

_SENT_END = re.compile(r"([.!?؟…⸮]+)\s+")


class PersianTextProcessor:
    """normalize / tokenize_words / tokenize_sentences."""

    def normalize_text(self, text: str) -> str:
        if not text:
            return ""
        text = _NL_RE.sub(" ", text)
        text = _WS_RE.sub(" ", text).strip()
        text = _FOLD_RE.sub(lambda m: _CHAR_FOLD[m.group()], text)
        text = _DIACRITICS_RE.sub("", text)
        return text.strip()

    def tokenize_words(self, text: str) -> List[str]:
        return _WORD_RE.findall(self.normalize_text(text))

    def tokenize_sentences(self, text: str) -> List[str]:
        normalized = self.normalize_text(text)
        if not normalized:
            return []
        # Split after terminator runs, keeping the terminator attached.
        parts = _SENT_END.split(normalized)
        sentences: List[str] = []
        buffer = ""
        for i, part in enumerate(parts):
            if i % 2 == 0:
                buffer += part
            else:
                buffer += part
                if buffer.strip():
                    sentences.append(buffer.strip())
                buffer = ""
        if buffer.strip():
            sentences.append(buffer.strip())
        return sentences


def fold_persian_digits(text: str) -> str:
    """Persian digits -> ASCII (reference: src/evaluation.py:176)."""
    return re.sub(
        r"[۰-۹]", lambda m: str(ord(m.group()) - 0x06F0), text
    )
