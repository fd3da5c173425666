"""PDF text extraction (host-side).

The reference shells this to PyPDF2 (reference: src/data_loader.py:61-65).
The port depends on neither PyPDF2 nor pdfplumber, so this is a first-party
minimal extractor for the common case: FlateDecode content streams with
Tj / TJ / ' / " text-showing operators and literal or hex strings. It is
not a full PDF renderer — encrypted files, exotic filters and CID-encoded
fonts degrade to whatever text is recoverable, mirroring the reference's
own lossy behavior on RTL documents (its shipped corpus is
character-reversed; see SURVEY.md §6 caveats).

If a full-featured library (pypdf) happens to be importable it is
preferred automatically. A copy of ``persian_rag_tpu.text.pdf`` (stdlib
only): the port imports nothing of the JAX package. One chosen divergence:
a Flate stream is decoded with the end-of-line before ``endstream`` still
attached (zlib ignores bytes past the end of its stream), so compressed
data that ends in a CR byte keeps it; the JAX reader strips CR LF there
and loses that stream's text.
"""
from __future__ import annotations

import re
import zlib
from typing import List

# (the stream with its end-of-line, the stream without it)
_STREAM_RE = re.compile(rb"stream\r?\n((.*?)(?:\r?\n)?)endstream",
                        re.DOTALL)
# text-showing ops inside BT/ET blocks
_BT_RE = re.compile(rb"BT(.*?)ET", re.DOTALL)
_TJ_RE = re.compile(rb"\((?:\\.|[^\\()])*\)\s*Tj|\[(?:[^\]])*\]\s*TJ")
_STR_RE = re.compile(rb"\((?:\\.|[^\\()])*\)")
_HEX_RE = re.compile(rb"<([0-9A-Fa-f\s]+)>")

_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}


def _decode_literal(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal escape
                oct_digits = raw[i + 1 : i + 4]
                j = 1
                while j <= 3 and raw[i + j : i + j + 1].isdigit():
                    j += 1
                out.append(int(oct_digits[: j - 1], 8) & 0xFF)
                i += j
                continue
            i += 2
            continue
        out += c
        i += 1
    return bytes(out)


def _bytes_to_text(data: bytes) -> str:
    # try UTF-16 (BOM) then UTF-8 then latin-1
    if data[:2] in (b"\xfe\xff", b"\xff\xfe"):
        try:
            return data.decode("utf-16")
        except UnicodeDecodeError:
            pass
    for codec in ("utf-8", "latin-1"):
        try:
            return data.decode(codec)
        except UnicodeDecodeError:
            continue
    return data.decode("latin-1", errors="replace")


def _extract_from_content(content: bytes) -> List[str]:
    texts: List[str] = []
    for block in _BT_RE.findall(content) or [content]:
        for match in _TJ_RE.finditer(block):
            op = match.group(0)
            for literal in _STR_RE.finditer(op):
                raw = literal.group(0)[1:-1]
                decoded = _decode_literal(raw)
                if decoded.strip():
                    texts.append(_bytes_to_text(decoded))
            for hexstr in _HEX_RE.finditer(op):
                raw = re.sub(rb"\s", b"", hexstr.group(1))
                if len(raw) % 2:
                    raw += b"0"
                data = bytes.fromhex(raw.decode("ascii"))
                # heuristically decode 2-byte CIDs as UTF-16BE
                if len(data) >= 2 and data[0] == 0:
                    try:
                        texts.append(data.decode("utf-16-be"))
                        continue
                    except UnicodeDecodeError:
                        pass
                texts.append(_bytes_to_text(data))
    return texts


def extract_pdf_text(path: str) -> str:
    """Extract text from a PDF file."""
    try:  # prefer a real library when present
        import pypdf  # noqa: F401

        reader = pypdf.PdfReader(path)
        return "\n".join(page.extract_text() or "" for page in reader.pages)
    except ImportError:
        pass

    with open(path, "rb") as f:
        data = f.read()

    pieces: List[str] = []
    for whole, raw_stream in _STREAM_RE.findall(data):
        stream = raw_stream
        try:
            stream = zlib.decompress(whole)  # the end-of-line is ignored
        except zlib.error:
            pass  # not Flate-compressed; try as-is
        if b"Tj" in stream or b"TJ" in stream:
            pieces.extend(_extract_from_content(stream))
    return " ".join(p.strip() for p in pieces if p.strip())
