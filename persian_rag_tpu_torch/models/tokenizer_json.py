"""An interpreter of HuggingFace ``tokenizer.json`` files, in plain Python.

The port serves on a machine without the ``tokenizers`` library, so it
reads the file itself. It covers exactly the components of the tokenizers
of the models the repository names, and gives the ids ``tokenizers``
gives:

* Unigram (paraphrase-multilingual-MiniLM-L12-v2, multilingual-e5-base:
  the XLM-R sentencepiece): the ``Precompiled`` normalizer (the
  sentencepiece double array of ``precompiled_charsmap``, applied per
  grapheme as ``tokenizers`` applies it), ``Replace``, the ``Metaspace``
  pre-tokenizer and decoder, and Viterbi over the pieces with the unknown
  piece scored and fused as ``tokenizers`` does;
* WordPiece (distiluse, BERT): ``BertNormalizer``, ``BertPreTokenizer``,
  greedy longest match with the continuing prefix and
  ``max_input_chars_per_word``;
* byte-level BPE (Llama 3): ``Split`` with the Llama-3 pattern, ``ByteLevel``
  and merges by rank.

In every case: added tokens are split out before the model runs, the
post-processors ``TemplateProcessing``, ``BertProcessing``,
``RobertaProcessing`` and ``ByteLevel`` add the special tokens, the file's
truncation and padding apply, and the decoders join the pieces. Any other
component, or a setting of one that is not covered, raises
`NotImplementedError` naming it.

The model's output is cached per pre-token: each model tokenizes a
pre-token independently of the others, so the cache changes no id.
"""
from __future__ import annotations

import base64
import json
import math
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_CACHE_LIMIT = 1 << 18  # pre-tokens (and Precompiled words) kept per model

# Unicode White_Space: Rust's char::is_whitespace and Oniguruma's \s
_WHITE_SPACE = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000])


def _is_ws(c: str) -> bool:
    return ord(c) in _WHITE_SPACE


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"tokenizer.json component {what} is not supported by the port's "
        "tokenizer.json reader")


# ---------------------------------------------------------------------------
# Unicode classes, built once from unicodedata
# ---------------------------------------------------------------------------

_CLASSES: Dict[str, str] = {}


def _ranges(mask: np.ndarray) -> str:
    """A regex character-class body of the code points where mask[cp]."""
    edges = np.flatnonzero(np.diff(np.concatenate(([0], mask.view(np.int8),
                                                   [0]))))
    return "".join(
        re.escape(chr(a)) if a == b - 1
        else f"{re.escape(chr(a))}-{re.escape(chr(b - 1))}"
        for a, b in zip(edges[0::2].tolist(), edges[1::2].tolist()))


def _table(ranges) -> np.ndarray:
    mask = np.zeros(0x110000, bool)
    for a, b in ranges:
        mask[a:b + 1] = True
    return mask


def _unicode_classes() -> Dict[str, str]:
    """Regex class bodies: letters (L), numbers (N), White_Space (S) and
    the grapheme-break classes, from this Python's unicodedata."""
    if not _CLASSES:
        code: Dict[str, int] = {}
        cats = np.array([code.setdefault(c, len(code)) for c in map(
            unicodedata.category, map(chr, range(0x110000)))], np.int8)

        def cat(*wanted):
            return np.isin(cats, [code[w] for w in wanted if w in code])

        _CLASSES["L"] = _ranges(cat("Lu", "Ll", "Lt", "Lm", "Lo"))
        _CLASSES["N"] = _ranges(cat("Nd", "Nl", "No"))
        _CLASSES["S"] = _ranges(_table((c, c) for c in _WHITE_SPACE))
        _CLASSES.update(_grapheme_classes(cat))
    return _CLASSES


# ---------------------------------------------------------------------------
# Extended grapheme clusters (UAX #29), which Precompiled works on
# ---------------------------------------------------------------------------

_OTHER_GRAPHEME_EXTEND = (
    (0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E), (0x0B57, 0x0B57),
    (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7), (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6),
    (0x0D3E, 0x0D3E), (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
    (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F),
    (0x1133E, 0x1133E), (0x11357, 0x11357), (0x114B0, 0x114B0),
    (0x114BD, 0x114BD), (0x115AF, 0x115AF), (0x11930, 0x11930),
    (0x1D165, 0x1D165), (0x1D16E, 0x1D172), (0xE0020, 0xE007F),
    (0x1F3FB, 0x1F3FF),  # emoji modifiers: Grapheme_Cluster_Break=Extend
)
_PREPEND = (
    (0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891),
    (0x08E2, 0x08E2), (0x0D4E, 0x0D4E), (0x110BD, 0x110BD),
    (0x110CD, 0x110CD), (0x111C2, 0x111C3), (0x1193F, 0x1193F),
    (0x11941, 0x11941), (0x11A3A, 0x11A3A), (0x11A84, 0x11A89),
    (0x11D46, 0x11D46), (0x11F02, 0x11F02),
)
_NOT_SPACING_MARK = (
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D),
    (0x1083, 0x1083), (0x1087, 0x108C), (0x108F, 0x108F), (0x109A, 0x109C),
    (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
    (0x11720, 0x11721),
)
_IGNORABLE_UNASSIGNED = (
    (0x2065, 0x2065), (0xFFF0, 0xFFF8), (0xE0000, 0xE0000),
    (0xE0002, 0xE001F), (0xE0080, 0xE00FF), (0xE01F0, 0xE0FFF),
)
# Extended_Pictographic (emoji-data.txt, Unicode 15)
_EXT_PICT = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD),
)


def _grapheme_classes(cat) -> Dict[str, str]:
    """Grapheme_Cluster_Break classes as regex class bodies."""
    extend = cat("Mn", "Me") | _table(_OTHER_GRAPHEME_EXTEND)
    prepend = _table(_PREPEND)
    control = (cat("Zl", "Zp", "Cc", "Cs", "Cf")
               | (cat("Cn") & _table(_IGNORABLE_UNASSIGNED)))
    control &= ~prepend
    control[[0x0A, 0x0D, 0x200C, 0x200D]] = False
    spacing = cat("Mc") & ~extend & ~_table(_NOT_SPACING_MARK)
    spacing[[0x0E33, 0x0EB3]] = True
    zwj = _table([(0x200D, 0x200D)])
    return {
        "g_ctl": _ranges(control),
        "g_ext": _ranges(extend | zwj | spacing),
        "g_ext_only": _ranges(extend),
        "g_pre": _ranges(prepend),
        "g_pict": _ranges(_table(_EXT_PICT)),
    }


_GRAPHEME_RE: List[re.Pattern] = []


def _grapheme_re() -> re.Pattern:
    """The extended grapheme cluster as a regex (UAX #29, table 1b)."""
    if not _GRAPHEME_RE:
        c = _unicode_classes()
        lv = "".join(chr(cp) for cp in range(0xAC00, 0xD7A4, 28))
        l_, v_, t_ = ("\u1100-\u115f\ua960-\ua97c",
                      "\u1160-\u11a7\ud7b0-\ud7c6",
                      "\u11a8-\u11ff\ud7cb-\ud7fb")
        hangul = (f"[{l_}]*(?:[{v_}]+|[{lv}][{v_}]*"
                  f"|[\uac00-\ud7a3](?<![{lv}]))[{t_}]*"
                  f"|[{l_}]+|[{t_}]+")
        core = (f"(?:{hangul}|[\U0001F1E6-\U0001F1FF]{{2}}"
                f"|[{c['g_pict']}](?:[{c['g_ext_only']}]*\u200d"
                f"[{c['g_pict']}])*"
                f"|[^{c['g_ctl']}\r\n])")
        _GRAPHEME_RE.append(re.compile(
            f"\r\n|[{c['g_ctl']}\r\n]|[{c['g_pre']}]*{core}"
            f"[{c['g_ext']}]*", re.DOTALL))
    return _GRAPHEME_RE[0]


def graphemes(text: str) -> List[str]:
    """`text` split into extended grapheme clusters."""
    return _grapheme_re().findall(text)


# ---------------------------------------------------------------------------
# Normalizers
# ---------------------------------------------------------------------------


class Precompiled:
    """sentencepiece's normalization from a ``precompiled_charsmap``: a
    u32 trie size, a darts-clone double array of that many bytes, then the
    normalized strings, each ended by NUL. As ``tokenizers`` applies it:
    a grapheme shorter than 6 bytes is replaced whole by the value of the
    SHORTEST key that is a prefix of it, if any; otherwise each of its
    characters that is a key is replaced by its value."""

    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        n_units = trie_size // 4
        self._units = struct.unpack_from(f"<{n_units}I", blob, 4)
        self._normalized = blob[4 + trie_size:]
        self._memo: Dict[str, Optional[str]] = {}
        self._words: Dict[str, str] = {}
        self._starts: Dict[str, bool] = {}
        self._prepend: Optional[re.Pattern] = None

    def _walk(self, key: bytes, first_only: bool):
        """Values of the keys that are prefixes of `key`, shortest first
        (`first_only`: the first of them); and whether the walk consumed
        all of `key`."""
        units = self._units
        pos = units[0] >> 10 << ((units[0] & (1 << 9)) >> 6)
        found = []
        for c in key:
            if c == 0:
                return found, False
            pos ^= c
            if pos >= len(units):
                return found, False
            unit = units[pos]
            if (unit & ((1 << 31) | 0xFF)) != c:
                return found, False
            pos ^= unit >> 10 << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                found.append(units[pos] & ((1 << 31) - 1))
                if first_only:
                    return found, True
        return found, True

    def _value(self, offset: int) -> str:
        end = self._normalized.index(b"\0", offset)
        return self._normalized[offset:end].decode("utf-8")

    def transform(self, chunk: str) -> Optional[str]:
        if chunk not in self._memo:
            found, _ = self._walk(chunk.encode("utf-8"), True)
            self._memo[chunk] = self._value(found[0]) if found else None
        return self._memo[chunk]

    def _may_start(self, ch: str) -> bool:
        """Whether some key begins with `ch`."""
        if ch not in self._starts:
            found, whole = self._walk(ch.encode("utf-8"), False)
            self._starts[ch] = bool(found) or whole
        return self._starts[ch]

    def _normalize_word(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)

    def __call__(self, text: str) -> str:
        if not any(self._may_start(ch) for ch in set(text)):
            return text
        # A grapheme boundary stands before every U+0020 whose left
        # neighbour is not a Prepend character, so the text normalizes
        # word by word (each word memoized).
        if self._prepend is None:
            self._prepend = re.compile(f"[{_unicode_classes()['g_pre']}]")
        pieces = text.split(" ")
        words = [pieces[0]]
        for piece in pieces[1:]:
            if words[-1] and self._prepend.match(words[-1][-1]):
                words[-1] += " " + piece
            else:
                words.append(" " + piece)
        out = []
        for word in words:
            got = self._words.get(word)
            if got is None:
                if len(self._words) >= _CACHE_LIMIT:
                    self._words.clear()
                got = self._words[word] = self._normalize_word(word)
            out.append(got)
        return "".join(out)


def _is_chinese_char(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BertNormalizer:
    def __init__(self, spec: dict):
        self.clean_text = spec.get("clean_text", True)
        self.handle_chinese_chars = spec.get("handle_chinese_chars", True)
        self.lowercase = spec.get("lowercase", True)
        strip = spec.get("strip_accents")
        self.strip_accents = self.lowercase if strip is None else strip

    def __call__(self, text: str) -> str:
        if self.clean_text:
            text = "".join(
                " " if (c in "\t\n\r" or _is_ws(c)) else c for c in text
                if not (c in ("\0", "\ufffd")
                        or (c not in "\t\n\r"
                            and unicodedata.category(c)[0] == "C")))
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _is_chinese_char(ord(c)) else c
                           for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.lowercase:
            # per character, as Rust's char::to_lowercase (no final sigma)
            text = "".join(c.lower() for c in text)
        return text


# Replace regexes of the tokenizers the repo names (XLM-R's space runs).
# Python's re and Oniguruma read class escapes (\s, \w, \d) and
# Unicode classes differently, so any other regex is refused.
REPLACE_REGEXES = (" {2,}",)


def _replace_pattern(pattern: dict) -> re.Pattern:
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if pattern.get("Regex") in REPLACE_REGEXES:
        return re.compile(pattern["Regex"])
    raise _unsupported(f"Replace pattern {pattern!r}")


def _make_normalizer(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_make_normalizer(s) for s in spec["normalizers"]]

        def seq(text):
            for step in steps:
                text = step(text)
            return text
        return seq
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        if not blob:
            return lambda text: text
        return Precompiled(base64.b64decode(blob))
    if kind == "Replace":
        pattern = _replace_pattern(spec["pattern"])
        content = spec["content"]
        return lambda text: pattern.sub(lambda m: content, text)
    if kind == "BertNormalizer":
        return BertNormalizer(spec)
    raise _unsupported(f"normalizer {kind!r}")


# ---------------------------------------------------------------------------
# Pre-tokenizers: each maps a list of pre-tokens to a list of pre-tokens
# ---------------------------------------------------------------------------

# llama.cpp's llama-bpe / Llama-3 tokenizer.json Split pattern
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_LLAMA3_RE: List[re.Pattern] = []


def llama3_split_re() -> re.Pattern:
    """`LLAMA3_PATTERN` for Python's re: \\p{L}, \\p{N} and \\s become
    explicit classes (Unicode letters, numbers and White_Space, as
    Oniguruma reads them; Python's \\s is another set)."""
    if not _LLAMA3_RE:
        c = _unicode_classes()
        L, N, S = c["L"], c["N"], c["S"]
        _LLAMA3_RE.append(re.compile(
            r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
            f"|[^\\r\\n{L}{N}]?[{L}]+|[{N}]{{1,3}}"
            f"| ?[^{S}{L}{N}]+[\\r\\n]*|[{S}]*[\\r\\n]+|[{S}]+(?![^{S}])"
            f"|[{S}]+"))
    return _LLAMA3_RE[0]


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}


def _split_on(pieces: List[str], is_delim) -> List[str]:
    """Split each piece at delimiter characters, which are removed."""
    out = []
    for piece in pieces:
        cur = []
        for ch in piece:
            if is_delim(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
    return out


def _is_bert_punc(ch: str) -> bool:
    return (ch.isascii() and not ch.isalnum() and 33 <= ord(ch) <= 126) or (
        unicodedata.category(ch)[0] == "P")


def _make_pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_make_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return seq
    if kind == "WhitespaceSplit":
        return lambda pieces: _split_on(pieces, _is_ws)
    if kind == "BertPreTokenizer":
        def bert(pieces):
            out = []
            for piece in _split_on(pieces, _is_ws):
                cur = []
                for ch in piece:
                    if _is_bert_punc(ch):
                        if cur:
                            out.append("".join(cur))
                            cur = []
                        out.append(ch)
                    else:
                        cur.append(ch)
                if cur:
                    out.append("".join(cur))
            return out
        return bert
    if kind == "Metaspace":
        return _metaspace_pre(spec)
    if kind == "Split":
        pattern = spec.get("pattern", {})
        if (pattern.get("Regex") != LLAMA3_PATTERN
                or spec.get("behavior") != "Isolated" or spec.get("invert")):
            raise _unsupported(
                f"pre-tokenizer Split {pattern!r} behavior "
                f"{spec.get('behavior')!r} invert {spec.get('invert')!r} "
                "(only the Llama-3 pattern, Isolated)")
        return lambda pieces: [p for piece in pieces
                               for p in _isolated(llama3_split_re(), piece)]
    if kind == "ByteLevel":
        if spec.get("use_regex", True) or spec.get("add_prefix_space", True):
            raise _unsupported("pre-tokenizer ByteLevel with use_regex or "
                               "add_prefix_space (only Llama 3's, both off)")
        return lambda pieces: ["".join(BYTE_TO_CHAR[b] for b in p.encode(
            "utf-8")) for p in pieces]
    raise _unsupported(f"pre-tokenizer {kind!r}")


def _isolated(pattern: re.Pattern, text: str) -> List[str]:
    """Matches and the gaps between them, in order (Split "Isolated")."""
    out, at = [], 0
    for m in pattern.finditer(text):
        if m.start() > at:
            out.append(text[at:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        at = m.end()
    if at < len(text):
        out.append(text[at:])
    return out


def _prepend_scheme(spec: dict) -> str:
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "never"):
        raise _unsupported(f"Metaspace prepend_scheme {scheme!r}")
    return scheme


def _metaspace_pre(spec: dict):
    rep = spec.get("replacement", "▁")
    always = _prepend_scheme(spec) == "always"
    split = spec.get("split", True)

    def metaspace(pieces):
        out = []
        for piece in pieces:
            piece = piece.replace(" ", rep)
            if always and not piece.startswith(rep):
                piece = rep + piece
            if not split:
                out.append(piece)
                continue
            # each replacement starts a piece (MergedWithNext)
            parts = piece.split(rep)
            if parts[0]:
                out.append(parts[0])
            out.extend(rep + part for part in parts[1:])
        return out
    return metaspace


# ---------------------------------------------------------------------------
# Models: pre-token -> ids
# ---------------------------------------------------------------------------


class _Model:
    vocab: Dict[str, int]

    def __init__(self):
        self._cache: Dict[str, List[int]] = {}
        self.id_to_token: Dict[int, str] = {}

    def tokenize(self, piece: str) -> List[int]:
        ids = self._cache.get(piece)
        if ids is None:
            if len(self._cache) >= _CACHE_LIMIT:
                self._cache.clear()
            ids = self._cache[piece] = self._tokenize(piece)
        return ids

    def _tokenize(self, piece: str) -> List[int]:
        raise NotImplementedError


class Unigram(_Model):
    """Viterbi over the pieces, as ``tokenizers``' optimized encode: ties
    keep the first path found; a character no piece starts with is the
    unknown piece, scored min score - 10, and neighbouring unknowns fuse."""

    def __init__(self, spec: dict):
        super().__init__()
        if spec.get("byte_fallback"):
            raise _unsupported("Unigram byte_fallback")
        self.pieces = [(str(p), float(s)) for p, s in spec["vocab"]]
        self.vocab = {}
        for i, (piece, _) in enumerate(self.pieces):
            self.vocab[piece] = i
        self.id_to_token = dict(enumerate(p for p, _ in self.pieces))
        self.scores = [s for _, s in self.pieces]
        self.unk_id = spec.get("unk_id")
        self.min_score = min(self.scores) if self.scores else 0.0
        self.max_len = max((len(p) for p, _ in self.pieces), default=1)

    def _tokenize(self, text: str) -> List[int]:
        if not text:
            return []
        n = len(text)
        unk_score = self.min_score - 10.0
        best = [-math.inf] * (n + 1)
        start_of: List[Optional[int]] = [None] * (n + 1)
        id_of = [0] * (n + 1)
        best[0] = 0.0
        vocab, scores = self.vocab, self.scores
        for s in range(n):
            here = best[s]
            single = False
            for end in range(s + 1, min(n, s + self.max_len) + 1):
                tid = vocab.get(text[s:end])
                if tid is None:
                    continue
                cand = scores[tid] + here
                if start_of[end] is None or cand > best[end]:
                    best[end], start_of[end], id_of[end] = cand, s, tid
                if end == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: no unk_id for an unknown "
                                     f"character {text[s]!r}")
                cand = unk_score + here
                if start_of[s + 1] is None or cand > best[s + 1]:
                    best[s + 1], start_of[s + 1], id_of[s + 1] = (
                        cand, s, self.unk_id)
        ids: List[int] = []
        end = n
        fused_unk = False
        while end > 0:
            s = start_of[end]
            tid = id_of[end]
            if tid == self.unk_id:
                if not fused_unk:
                    ids.append(tid)
                fused_unk = True
            else:
                ids.append(tid)
                fused_unk = False
            end = s
        ids.reverse()
        return ids


class WordPiece(_Model):
    def __init__(self, spec: dict):
        super().__init__()
        self.vocab = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def _unk(self) -> List[int]:
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece: unk token {self.unk!r} not in vocab")
        return [self.vocab[self.unk]]

    def _tokenize(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return self._unk()
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    found = self.vocab[sub]
                    break
                end -= 1
            if found is None:
                return self._unk()
            ids.append(found)
            start = end
        return ids


class BPE(_Model):
    """Merges by rank, the lowest rank first and the leftmost among equal
    ranks; a character outside the vocabulary is dropped (there is no
    unknown token: a byte-level vocabulary holds every byte)."""

    def __init__(self, spec: dict):
        super().__init__()
        for key in ("continuing_subword_prefix", "end_of_word_suffix",
                    "unk_token"):
            if spec.get(key):
                raise _unsupported(f"BPE {key}={spec[key]!r}")
        if spec.get("byte_fallback"):
            raise _unsupported("BPE byte_fallback")
        if spec.get("dropout") not in (None, 0, 0.0):
            raise _unsupported(f"BPE dropout={spec['dropout']!r}")
        self.vocab = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(spec.get("merges", [])):
            left, right = (merge.split(" ", 1) if isinstance(merge, str)
                           else merge)
            if left + right not in self.vocab:
                raise ValueError(f"BPE merge {left!r} {right!r} makes a token "
                                 "outside the vocabulary")
            self.ranks[(left, right)] = rank  # a repeated pair: the last rank

    def _tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        symbols = [ch for ch in word if ch in self.vocab]
        ranks = self.ranks
        while len(symbols) > 1:
            best, at = None, -1
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            symbols[at:at + 2] = [symbols[at] + symbols[at + 1]]
        return [self.vocab[s] for s in symbols]


def _make_model(spec: dict) -> _Model:
    kind = spec.get("type")
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "BPE":
        return BPE(spec)
    raise _unsupported(f"model {kind!r}")


# ---------------------------------------------------------------------------
# Post-processors: (ids, add_special_tokens) -> ids
# ---------------------------------------------------------------------------


def _make_post_processor(spec: Optional[dict]):
    """-> (process(ids) with the special tokens, count of added ids)."""
    if spec is None:
        return (lambda ids: ids), 0
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_make_post_processor(s) for s in spec["processors"]]

        def seq(ids):
            for step, _ in steps:
                ids = step(ids)
            return ids
        return seq, sum(n for _, n in steps)
    if kind == "ByteLevel":  # moves offsets only
        return (lambda ids: ids), 0
    if kind in ("BertProcessing", "RobertaProcessing"):
        cls_id, sep_id = int(spec["cls"][1]), int(spec["sep"][1])
        return (lambda ids: [cls_id] + ids + [sep_id]), 2
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        before: List[int] = []
        after: List[int] = []
        seen_a = False
        for item in spec["single"]:
            if "SpecialToken" in item:
                ids = [int(i) for i in specials[item["SpecialToken"]["id"]]["ids"]]
                (after if seen_a else before).extend(ids)
            elif "Sequence" in item:
                if item["Sequence"]["id"] != "A" or seen_a:
                    raise _unsupported(
                        f"TemplateProcessing single {spec['single']!r}")
                seen_a = True
            else:
                raise _unsupported(f"TemplateProcessing piece {item!r}")
        return (lambda ids: before + ids + after), len(before) + len(after)
    raise _unsupported(f"post-processor {kind!r}")


# ---------------------------------------------------------------------------
# Decoders: tokens -> text
# ---------------------------------------------------------------------------


def _wordpiece_cleanup(s: str) -> str:
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        s = s.replace(a, b)
    return s


def _make_decoder(spec: Optional[dict]):
    """-> decode_chain(tokens) -> tokens."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        drop_first = _prepend_scheme(spec) != "never"
        return lambda tokens: [
            "".join(("" if (i == 0 and drop_first) else " ") if c == rep
                    else c for c in tok)
            for i, tok in enumerate(tokens)]
    if kind == "WordPiece":
        prefix = spec.get("prefix", "##")
        cleanup = spec.get("cleanup", True)

        def wordpiece(tokens):
            out = []
            for i, tok in enumerate(tokens):
                if i != 0:
                    tok = (tok.replace(prefix, "", 1) if tok.startswith(prefix)
                           else " " + tok)
                out.append(_wordpiece_cleanup(tok) if cleanup else tok)
            return out
        return wordpiece
    if kind == "ByteLevel":
        def byte_level(tokens):
            raw = bytearray()
            for tok in tokens:
                if all(c in CHAR_TO_BYTE for c in tok):
                    raw.extend(CHAR_TO_BYTE[c] for c in tok)
                else:
                    raw.extend(tok.encode("utf-8"))
            return [bytes(raw).decode("utf-8", errors="replace")]
        return byte_level
    raise _unsupported(f"decoder {kind!r}")


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------


class AddedToken:
    def __init__(self, spec: dict):
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.special = bool(spec.get("special", False))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.normalized = bool(spec.get("normalized", not self.special))
        if spec.get("single_word"):
            raise _unsupported(f"added token {self.content!r} single_word")


def _matcher(tokens: List[AddedToken], contents: List[str]):
    """Leftmost-longest matcher over `contents` (alternatives longest
    first, so Python's leftmost-first alternation picks the longest)."""
    if not tokens:
        return None
    order = sorted(range(len(tokens)), key=lambda i: -len(contents[i]))
    pattern = re.compile("|".join(f"({re.escape(contents[i])})"
                                  for i in order if contents[i]))
    return pattern, [tokens[i] for i in order if contents[i]]


class TokenizerJSON:
    """A ``tokenizer.json`` file: encode, encode_batch, decode."""

    def __init__(self, spec: dict):
        self.normalizer = _make_normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _make_pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _make_model(spec["model"])
        self.post, self.n_added = _make_post_processor(
            spec.get("post_processor"))
        self.decoder = _make_decoder(spec.get("decoder"))
        self.truncation = spec.get("truncation")
        if self.truncation and self.truncation.get("direction",
                                                   "Right") not in ("Right", "Left"):
            raise _unsupported(f"truncation {self.truncation!r}")
        self.padding = spec.get("padding")
        self.added = [AddedToken(t) for t in spec.get("added_tokens", [])]
        self.added_by_content = {t.content: t for t in self.added}
        self.added_by_id = {t.id: t for t in self.added}
        self.special_contents = {t.content for t in self.added if t.special}
        raw = [t for t in self.added if not t.normalized]
        norm = [t for t in self.added if t.normalized]
        self._raw = _matcher(raw, [t.content for t in raw])
        self._norm = _matcher(norm, [self._normalize(t.content) for t in norm])

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJSON":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- vocabulary ----------------------------------------------------------

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added_by_content:
            return self.added_by_content[token].id
        return self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        if tid in self.added_by_id:
            return self.added_by_id[tid].content
        return self.model.id_to_token.get(tid)

    def get_vocab_size(self) -> int:
        ids = set(self.model.id_to_token) | set(self.added_by_id)
        return max(ids, default=-1) + 1

    # -- encoding ------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        return self.normalizer(text) if self.normalizer is not None else text

    @staticmethod
    def _split_added(text: str, matcher) -> List[Tuple[str, Optional[int]]]:
        """[(segment, added id or None)] as ``tokenizers`` finds added
        tokens: leftmost-longest, lstrip / rstrip taking the whitespace
        beside a match."""
        if matcher is None or not text:
            return [(text, None)]
        pattern, tokens = matcher
        out, at = [], 0
        for m in pattern.finditer(text):
            tok = tokens[m.lastindex - 1]
            start, stop = m.start(), m.end()
            if tok.lstrip:
                while start > at and _is_ws(text[start - 1]):
                    start -= 1
            if tok.rstrip:
                while stop < len(text) and _is_ws(text[stop]):
                    stop += 1
            if at < start:
                out.append((text[at:start], None))
            out.append((text[start:stop], tok.id))
            at = stop
        if at < len(text):
            out.append((text[at:], None))
        return out

    def _raw_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for seg, tid in self._split_added(text, self._raw):
            if tid is not None:
                ids.append(tid)
                continue
            for piece, ptid in self._split_added(self._normalize(seg),
                                                 self._norm):
                if ptid is not None:
                    ids.append(ptid)
                    continue
                if not piece:
                    continue
                for pre in self.pre_tokenizer([piece]):
                    ids.extend(self.model.tokenize(pre))
        return ids

    def _pad(self, encs: List[List[int]], length: int) -> List[List[int]]:
        p = self.padding
        multiple = p.get("pad_to_multiple_of")
        if multiple and length % multiple:
            length += multiple - length % multiple
        pad_id = int(p.get("pad_id", 0))
        left = p.get("direction", "Right") == "Left"
        out = []
        for ids in encs:
            extra = [pad_id] * max(length - len(ids), 0)
            out.append(extra + ids if left else ids + extra)
        return out

    def _pad_length(self, encs: List[List[int]]) -> int:
        strategy = self.padding.get("strategy", "BatchLongest")
        if isinstance(strategy, dict) and "Fixed" in strategy:
            return int(strategy["Fixed"])
        if strategy != "BatchLongest":
            raise _unsupported(f"padding strategy {strategy!r}")
        return max((len(e) for e in encs), default=0)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._raw_ids(text)
        if self.truncation:
            limit = int(self.truncation["max_length"])
            if add_special_tokens and self.n_added:
                limit = max(limit - self.n_added, 0)
            if len(ids) > limit:
                ids = (ids[len(ids) - limit:]
                       if self.truncation.get("direction") == "Left"
                       else ids[:limit])
        if add_special_tokens:
            ids = self.post(ids)
        if self.padding:
            ids = self._pad([ids], self._pad_length([ids]))[0]
        return ids

    def encode_batch(self, texts: Sequence[str],
                     add_special_tokens: bool = True) -> List[List[int]]:
        encs = [self.encode(t, add_special_tokens) for t in texts]
        if self.padding:
            encs = self._pad(encs, self._pad_length(encs))
        return encs

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None:
                continue
            if skip_special_tokens and tok in self.special_contents:
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
