"""Configuration: the dataclasses, `load_config`, `save_results`,
`ensure_directories`.

The counterpart of ``persian_rag_tpu.core.config``: the same fields and
defaults, and a YAML file overlaid on them (a missing file gives the
defaults, unknown keys are skipped). The port reads YAML itself
(`parse_yaml`), since the machine with the card has no PyYAML: the subset
that ``config.yaml`` uses, resolved as ``yaml.safe_load`` resolves it
(YAML 1.1). Anything outside it raises ValueError with its line number.
The ``mesh`` and ``compute`` sections are kept as data; nothing in the port
reads them.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_MODELS = [
    "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2",
    "sentence-transformers/distiluse-base-multilingual-cased-v2",
    "intfloat/multilingual-e5-base",
]


@dataclass
class ChunkingConfig:
    word_chunk_size: int = 150
    word_overlap: int = 25
    sentences_per_chunk: int = 5


@dataclass
class RetrievalConfig:
    methods: List[str] = field(default_factory=lambda: ["bm25", "dense", "tfidf"])
    top_k: List[int] = field(default_factory=lambda: [1, 3, 5, 10])
    dense_weight: float = 0.6
    bm25_weight: float = 0.4
    max_context_length: int = 2000


@dataclass
class EvaluationConfig:
    test_size: float = 0.1
    batch_size: int = 16
    sample_size: Optional[int] = 100


@dataclass
class TrainingConfig:
    epochs: int = 1
    warmup_steps: int = 50
    max_train_samples: Optional[int] = 5000
    batch_size: int = 16
    learning_rate: float = 2e-5


@dataclass
class MeshConfig:
    """The JAX package's device-mesh layout (data only in the port)."""

    corpus_axis: int = -1
    data_axis: int = 1


@dataclass
class ComputeConfig:
    """The JAX package's dtype and kernel policy (data only in the port)."""

    matmul_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    corpus_tile: int = 1024
    query_tile: int = 128
    use_pallas: Optional[bool] = None


@dataclass
class PathsConfig:
    data_dir: str = "data"
    raw_dir: str = "data/raw"
    processed_dir: str = "data/processed"
    results_dir: str = "results"
    models_dir: str = "models"
    index_dir: str = "results/index"
    logs_dir: str = "logs"


@dataclass
class GenerationConfig:
    server_url: str = "http://127.0.0.1:8080"
    max_tokens: int = 128
    temperature: float = 0.05
    top_p: float = 0.85
    timeout: int = 120


@dataclass
class Config:
    models: List[str] = field(default_factory=lambda: list(DEFAULT_MODELS))
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str) -> Any:
        """Dict-style access (config["chunking"]["word_chunk_size"])."""
        value = getattr(self, key)
        if dataclasses.is_dataclass(value):
            return dataclasses.asdict(value)
        return value


def _update_dataclass(obj: Any, data: Dict[str, Any]) -> None:
    for key, value in data.items():
        if not isinstance(key, str) or not hasattr(obj, key):
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value)
        else:
            setattr(obj, key, value)


def load_config(path: str = "config.yaml") -> Config:
    """The defaults, overlaid with the YAML file at `path` when it exists."""
    config = Config()
    if path and os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            raw = parse_yaml(f.read()) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: the document is not a mapping")
        _update_dataclass(config, raw)
    return config


def _csv_cell(value: Any) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return str(value)


def write_csv_records(filepath: str, rows) -> None:
    """Write a list of row dicts as CSV the way pandas'
    `DataFrame(rows).to_csv(filepath, index=False)` does for str, int and
    bool cells: columns in first-seen order, minimal quoting, missing cells
    empty, no index column. (pandas writes an int column with a missing
    cell as floats; this writer keeps each cell's own text.)"""
    rows = list(rows)
    columns: List[str] = []
    for row in rows:
        columns += [c for c in row if c not in columns]
    with open(filepath, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_cell(row.get(c)) for c in columns])


def save_results(results, filename: str, directory: str = "results") -> str:
    """Write results as JSON, or as CSV (`write_csv_records`), as the JAX
    package's writer does."""
    os.makedirs(directory, exist_ok=True)
    filepath = os.path.join(directory, filename)
    if filename.endswith(".json"):
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
    elif filename.endswith(".csv"):
        write_csv_records(filepath, results)
    else:
        raise ValueError(f"unsupported result format: {filename}")
    return filepath


def ensure_directories(config: Optional[Config] = None) -> None:
    """Create the artifact directory tree."""
    paths = (config or Config()).paths
    for directory in (paths.raw_dir, paths.processed_dir, paths.results_dir,
                      paths.models_dir, paths.index_dir, paths.logs_dir):
        os.makedirs(directory, exist_ok=True)


# ---------------------------------------------------------------------------
# A YAML reader for the subset config.yaml uses.
#
# Block mappings and block sequences (items: scalars, flow sequences, or a
# nested block), flow sequences on one line, plain and quoted scalars on one
# line, comments (also after a value), and the implicit types of
# yaml.safe_load (YAML 1.1: null, bool, int, float; anything else a string).
# Outside it, and raising ValueError: anchors and aliases, tags, block
# scalars (| >), flow mappings, several documents, directives, complex keys,
# multi-line scalars, timestamps, merge keys, and tabs in indentation.
# ---------------------------------------------------------------------------

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no = no
        self.indent = indent
        self.text = text


def _fail(no: int, msg: str):
    raise ValueError(f"line {no}: {msg} (outside the YAML subset the port "
                     "reads)")


def _sexagesimal(value: str, part) -> Any:
    out, base = 0, 1
    for digit in reversed(value.split(":")):
        out += part(digit) * base
        base *= 60
    return out


def _resolve(text: str, no: int) -> Any:
    """A plain scalar's value, as yaml.safe_load resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        _fail(no, f"a timestamp, merge or value key {text!r}")
    return text


def _quoted(text: str, pos: int, no: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos] and the position after it."""
    quote = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _HEX_ESCAPES:
                width = _HEX_ESCAPES[esc]
                digits = text[i + 2:i + 2 + width]
                if len(digits) != width or not re.fullmatch(
                        r"[0-9a-fA-F]+", digits):
                    _fail(no, f"a bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + width
            else:
                _fail(no, f"the escape \\{esc or 'at the line end'}")
            continue
        out.append(ch)
        i += 1
    _fail(no, "a quoted scalar that goes on past its line")


def _comment_or_end(text: str, pos: int, no: int) -> None:
    rest = text[pos:]
    if rest.strip() and not (rest[:1] in (" ", "\t")
                             and rest.strip().startswith("#")):
        _fail(no, f"text after a value: {rest.strip()!r}")


def _plain(text: str, no: int, flow: bool = False) -> Any:
    if not text:
        return None
    if text[0] in "&*!|>%@`{}" or (text[0] in "?:-" and text[1:2] in ("",
                                                                       " ")):
        _fail(no, f"the indicator {text[0]!r}")
    if ": " in text or text.endswith(":") or "\t#" in text:
        _fail(no, f"a mapping or tab inside the scalar {text!r}")
    if flow and any(c in text for c in ",[]{}"):
        _fail(no, f"a flow indicator inside {text!r}")
    return _resolve(text, no)


def _flow_seq(text: str, pos: int, no: int) -> Tuple[list, int]:
    """The flow sequence starting at text[pos] == '[' (one line) and the
    position after it."""
    out: List[Any] = []
    i = pos + 1
    need_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            _fail(no, "a flow sequence that goes on past its line")
        ch = text[i]
        if ch == "]":
            return out, i + 1
        if ch == ",":
            if need_item:
                _fail(no, "an empty flow entry")
            need_item = True
            i += 1
            continue
        if not need_item:
            _fail(no, "flow entries without a comma")
        if ch == "[":
            value, i = _flow_seq(text, i, no)
        elif ch in "'\"":
            value, i = _quoted(text, i, no)
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                if text[j] == "#" and text[j - 1] == " ":
                    _fail(no, "a comment inside a flow sequence")
                j += 1
            value = _plain(text[i:j].rstrip(), no, flow=True)
            i = j
        out.append(value)
        need_item = False


def _inline(text: str, no: int) -> Any:
    """The value written after 'key:' or '- ' on its line."""
    if text[:1] == "[":
        value, end = _flow_seq(text, 0, no)
        _comment_or_end(text, end, no)
        return value
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0, no)
        _comment_or_end(text, end, no)
        return value
    if text.startswith("#"):
        return None
    cut = re.search(r"[ \t]#", text)
    return _plain((text[:cut.start()] if cut else text).rstrip(), no)


def _split_key(text: str, no: int) -> Optional[Tuple[Any, str]]:
    """(key, the text after ':') for a mapping line, None for a scalar
    line."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0, no)
        rest = text[end:].lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip(" ")
    if text[:1] in "[{?&*!|>%@`":
        _fail(no, f"a key starting with {text[0]!r}")
    m = re.search(r":(?: |$)", text)
    cut = re.search(r"[ \t]#", text)
    if m is None or (cut is not None and cut.start() < m.start()):
        return None
    return _plain(text[:m.start()].rstrip(), no), text[m.end():].strip(" ")


def _is_entry(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith("- ")


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    if _is_entry(lines[i]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines: List[_Line], i: int, indent: int,
            seq_same_indent: bool) -> Tuple[Any, int]:
    """The block under a 'key:' or '-' whose value is on the next lines:
    more indented, or (under a key) a sequence at the key's indent."""
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > indent:
            return _block(lines, i, nxt.indent)
        if seq_same_indent and nxt.indent == indent and _is_entry(nxt):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if _is_entry(line):
            _fail(line.no, "a sequence entry inside a mapping")
        split = _split_key(line.text, line.no)
        if split is None:
            _fail(line.no, f"a scalar where a mapping key belongs: "
                           f"{line.text!r}")
        key, rest = split
        i += 1
        if rest and not rest.startswith("#"):
            out[key] = _inline(rest, line.no)
            if i < len(lines) and lines[i].indent > indent:
                _fail(lines[i].no, "a multi-line scalar or a block after "
                                   "an inline value")
        else:
            out[key], i = _nested(lines, i, indent, seq_same_indent=True)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].no, "an indentation that matches no block")
    return out, i


def _sequence(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out: List[Any] = []
    while i < len(lines) and lines[i].indent == indent and _is_entry(
            lines[i]):
        line = lines[i]
        rest = line.text[1:].strip(" ")
        i += 1
        if rest and not rest.startswith("#"):
            if _is_entry(_Line(line.no, 0, rest)) or (
                    rest[0] != "[" and _split_key(rest, line.no) is not None):
                _fail(line.no, "a compact nested block in a sequence entry")
            out.append(_inline(rest, line.no))
            if i < len(lines) and lines[i].indent > indent:
                _fail(lines[i].no, "a multi-line scalar after an entry")
        else:
            value, i = _nested(lines, i, indent, seq_same_indent=False)
            out.append(value)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].no, "an indentation that matches no block")
    return out, i


def parse_yaml(text: str) -> Any:
    """One YAML document of the subset above, as yaml.safe_load reads it
    (None for an empty one). Raises ValueError, with the line number,
    outside the subset."""
    lines: List[_Line] = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = raw.rstrip(" \t\r")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped[0] == "\t":
            _fail(no, "a tab in the indentation")
        if stripped[0] == "%" or (body in ("---", "...")
                                  or body.startswith(("--- ", "... "))):
            _fail(no, "a directive or a document marker")
        lines.append(_Line(no, len(body) - len(stripped), stripped))
    if not lines:
        return None
    first = lines[0]
    if not _is_entry(first) and _split_key(first.text, first.no) is None:
        if len(lines) > 1:
            _fail(lines[1].no, "a multi-line scalar document")
        return _inline(first.text, first.no)
    value, i = _block(lines, 0, first.indent)
    if i < len(lines):
        _fail(lines[i].no, "text after the document's block")
    return value
