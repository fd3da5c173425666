"""The port's configuration (`core.config`) against the JAX package's and
its YAML reader against `yaml.safe_load`, on the CPU.

* `parse_yaml` equals `yaml.safe_load` on `config.yaml` and on
  hypothesis-generated documents of its subset: block mappings and
  sequences (a sequence under a key at the key's indent or deeper), flow
  sequences (nested, a trailing comma), plain, single- and double-quoted
  scalars, comment lines and comments after values, blank lines, and the
  YAML 1.1 implicit types (2.0e-5 a float but 2e-5 a string, yes / off
  booleans, 1_000, 0x1F, 017, 1:30 integers, ~ and null);
* every document outside the subset raises ValueError naming its line;
* `load_config(path).to_dict()` equals the JAX package's (config.yaml, a
  partial file with unknown keys, a missing file), and `save_results` /
  `ensure_directories` write what the JAX package's write.
"""
import json
import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from persian_rag_tpu.core import config as jconfig
from persian_rag_tpu_torch.core import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLAIN = ["word", "two words", "دارو", "x-y", "a.b", "path/to/file", "0",
         "12", "-3", "+7", "1_000", "0x1F", "017", "0b101", "1:30", "2.0e-5",
         "2e-5", "1.5", ".5", "-1.0e+3", "1.0e5", "-.inf", ".Inf", "yes",
         "No", "on", "OFF", "true", "False", "y", "~", "null", "NULL",
         "None", "bfloat16", "http://127.0.0.1:8080", "it's", "a#b", "-x"]
QUOTED_CHARS = st.sampled_from(list("ab 'dé\"\\\t\n#:,[]") + ["دارو"])


@st.composite
def quoted(draw):
    s = "".join(draw(st.lists(QUOTED_CHARS, max_size=6)))
    if draw(st.booleans()):
        return "'" + s.replace("'", "''").replace("\n", " ").replace(
            "\t", " ") + "'"
    return json.dumps(s, ensure_ascii=False)


scalar = st.one_of(st.sampled_from(PLAIN), quoted())
flow_scalar = st.one_of(st.sampled_from(
    [p for p in PLAIN if not any(c in p for c in ",[]{}#")]), quoted())


def flow_seq(depth=0):
    item = flow_scalar if depth else st.one_of(flow_scalar,
                                               st.deferred(lambda: flow_seq(1)))
    return st.builds(
        lambda items, trail: "[" + ", ".join(items) + ("," if trail and items
                                                        else "") + "]",
        st.lists(item, max_size=4), st.booleans())


KEYS = st.sampled_from(["models", "chunking", "top_k", "a", "b_c", "server",
                        "x1", "دانه", "yes", "12", "null"])
COMMENT = st.sampled_from(["", "", "  # note", " # a: b, [c]"])


@st.composite
def block(draw, indent, depth):
    """Lines of a block mapping at `indent`."""
    step = draw(st.sampled_from([2, 4]))
    lines = []
    for key in draw(st.lists(KEYS, min_size=1, max_size=4, unique=True)):
        if draw(st.booleans()):
            lines.append(" " * indent + "# a comment line")
        kind = draw(st.sampled_from(
            ["scalar", "flow", "seq", "map", "empty"] if depth < 2
            else ["scalar", "flow", "seq", "empty"]))
        head = " " * indent + key + ":"
        if kind == "scalar":
            lines.append(f"{head} {draw(scalar)}{draw(COMMENT)}")
        elif kind == "flow":
            lines.append(f"{head} {draw(flow_seq())}{draw(COMMENT)}")
        elif kind == "empty":
            lines.append(head + draw(COMMENT))
        elif kind == "seq":
            lines.append(head + draw(COMMENT))
            at = indent + draw(st.sampled_from([0, step]))
            for item in draw(st.lists(st.one_of(scalar, flow_seq()),
                                      min_size=1, max_size=3)):
                lines.append(" " * at + "- " + item + draw(COMMENT))
                if draw(st.booleans()):
                    lines.append("")
        else:
            lines.append(head + draw(COMMENT))
            lines += draw(block(indent + step, depth + 1))
    return lines


@settings(max_examples=300, deadline=None)
@given(block(0, 0))
def test_generated_documents_equal_safe_load(lines):
    text = "\n".join(lines) + "\n"
    assert tconfig.parse_yaml(text) == yaml.safe_load(text), text


@settings(max_examples=100, deadline=None)
@given(st.lists(st.one_of(scalar, flow_seq()), min_size=1, max_size=5),
       st.sampled_from([0, 2]))
def test_generated_top_level_sequences_equal_safe_load(items, indent):
    text = "".join(" " * indent + "- " + i + "\n" for i in items)
    assert tconfig.parse_yaml(text) == yaml.safe_load(text), text


def test_config_yaml_equals_safe_load():
    with open(os.path.join(ROOT, "config.yaml"), encoding="utf-8") as f:
        text = f.read()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)
    for text in ("", "# only a comment\n", "word\n", "'quoted'\n", "12\n",
                 'a: "\\x41\\u00e9\\L\\P\\_\\N\\e\\/"\n'):
        assert tconfig.parse_yaml(text) == yaml.safe_load(text)


OUTSIDE = {
    "anchor": ("a: &x 1\nb: 2\n", 1),
    "alias": ("a: 1\nb: *a\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "block_scalar": ("a: |\n  text\n", 1),
    "folded_scalar": ("a: >\n  text\n", 1),
    "flow_mapping": ("a: {b: 1}\n", 1),
    "documents": ("a: 1\n---\nb: 2\n", 2),
    "directive": ("%YAML 1.1\na: 1\n", 1),
    "multi_line_plain": ("a: b\n  c\n", 2),
    "multi_line_quoted": ("a: 'b\n  c'\n", 1),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "timestamp": ("a: 2001-12-14\n", 1),
    "complex_key": ("? a\n: 1\n", 1),
    "compact_nested": ("a:\n  - b: 1\n", 2),
    "merge_key": ("a:\n  <<: 1\n", 2),
    "bad_indent": ("a:\n    b: 1\n  c: 2\n", 3),
    "mapping_in_value": ("a: b: c\n", 1),
}


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_outside_the_subset_raises_with_its_line(case):
    text, line = OUTSIDE[case]
    with pytest.raises(ValueError, match=f"line {line}:"):
        tconfig.parse_yaml(text)


def test_load_config_equals_jax(tmp_path):
    path = os.path.join(ROOT, "config.yaml")
    assert (tconfig.load_config(path).to_dict()
            == jconfig.load_config(path).to_dict())
    partial = tmp_path / "partial.yaml"
    partial.write_text("chunking:\n  word_chunk_size: 99\n  extra: 1\n"
                       "unknown_section: [1, 2]\npaths:\n  processed_dir: "
                       "/data/p  # here\nevaluation:\n  sample_size: ~\n",
                       encoding="utf-8")
    got = tconfig.load_config(str(partial))
    assert got.to_dict() == jconfig.load_config(str(partial)).to_dict()
    assert got.chunking.word_chunk_size == 99
    assert got["chunking"]["word_chunk_size"] == 99
    missing = str(tmp_path / "missing.yaml")
    assert (tconfig.load_config(missing).to_dict()
            == jconfig.load_config(missing).to_dict()
            == tconfig.Config().to_dict())


def test_save_results_and_directories_equal_jax(tmp_path):
    rows = [{"method": "bm25", "top_k": 5, "f1": 0.25, "ok": True,
             "note": "a, \"b\""},
            {"method": "dense", "top_k": 10, "f1": 0.125, "ok": False,
             "note": "دارو"}]
    for name in ("r.json", "r.csv"):
        a = tconfig.save_results(rows, name, str(tmp_path / "t"))
        b = jconfig.save_results(rows, name, str(tmp_path / "j"))
        with open(a, encoding="utf-8") as fa, open(b, encoding="utf-8") as fb:
            assert fa.read() == fb.read(), name
    with pytest.raises(ValueError, match="unsupported"):
        tconfig.save_results(rows, "r.txt", str(tmp_path / "t"))
    cfg = tconfig.Config()
    cwd = os.getcwd()
    try:
        for sub, mod in (("t", tconfig), ("j", jconfig)):
            os.makedirs(tmp_path / "dirs" / sub)
            os.chdir(tmp_path / "dirs" / sub)
            mod.ensure_directories(cfg if mod is tconfig else None)
        os.chdir(cwd)
        walk = {sub: sorted(r.replace(str(tmp_path / "dirs" / sub), "")
                            for r, _, _ in os.walk(tmp_path / "dirs" / sub))
                for sub in ("t", "j")}
        assert walk["t"] == walk["j"] and len(walk["t"]) > 5
    finally:
        os.chdir(cwd)
