"""The port's ingest path (text -> chunks -> encoder -> index files)
against the JAX package's.

`phase3.main` in both packages on the same synthetic text, with the JAX
encoder's parameters carried into the port's (models/convert.py): equal
chunk CSVs (byte for byte: pandas' in the JAX package, the csv module's in
the port), equal chunk statistics and `num_vectors`, index vectors within
1e-4, and equal smoke-query ids from the index and from the collection
(the test asserts that those ranks stand apart). The port's index files,
FAISS files and collections load in the JAX package. `create_embeddings`
with and without `force`, and with `verify`, gives the JAX results;
`encode_robust` counts a forced per-item failure as JAX does; and the two
commands run as `python -m persian_rag_tpu_torch ... --tiny --device cpu`.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from persian_rag_tpu.core.config import Config as JaxConfig
from persian_rag_tpu.index import faiss_io as jio
from persian_rag_tpu.index.collections import CollectionStore as JaxStore
from persian_rag_tpu.index.dense import DenseIndex as JaxDenseIndex
from persian_rag_tpu.models.encoder import EncoderConfig as JaxEncConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from persian_rag_tpu.pipelines import create_embeddings as jce
from persian_rag_tpu.pipelines import phase3 as jphase3

from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch import __main__ as tmain
from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer
from persian_rag_tpu_torch.pipelines import common as tcommon
from persian_rag_tpu_torch.pipelines import create_embeddings as tce
from persian_rag_tpu_torch.pipelines import phase3 as tphase3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=3000, hidden_size=48, num_layers=2, num_heads=4,
             intermediate_size=96, max_position_embeddings=64)
ENCODER_SEED = 3  # a seed whose smoke-query ranks stand apart


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxSentenceEncoder(
        JaxEncConfig(**SMALL), tokenizer=JaxHashTokenizer(SMALL["vocab_size"]),
        max_seq_len=48, seed=ENCODER_SEED,
    )
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(SMALL["vocab_size"]), max_seq_len=48,
        device="cpu",
    )
    return jenc, tenc


def _config(cls):
    cfg = cls()
    cfg.models = ["tiny-model"]
    cfg.chunking.word_chunk_size = 40
    cfg.chunking.word_overlap = 8
    cfg.chunking.sentences_per_chunk = 4
    return cfg


@pytest.fixture(scope="module")
def runs(encoders, tmp_path_factory):
    """phase3 then create_embeddings in each package, each in its own
    working directory, on the carried encoder."""
    jenc, tenc = encoders
    mp = pytest.MonkeyPatch()
    for module, enc in ((jphase3, jenc), (jce, jenc), (tphase3, tenc),
                        (tce, tenc)):
        mp.setattr(module, "build_encoder", lambda *a, _e=enc, **k: _e)
    out = {}
    cwd = os.getcwd()
    try:
        for name, phase3, ce, cfg, kw in (
                ("jax", jphase3, jce, _config(JaxConfig), {}),
                ("torch", tphase3, tce, _config(Config), {"device": "cpu"})):
            d = tmp_path_factory.mktemp(name)
            os.chdir(d)
            p3 = phase3.main(cfg, **kw)
            first = ce.main(cfg, **kw)
            again = ce.main(cfg, **kw)
            forced = ce.main(cfg, force=True, **kw)
            verify = ce.main(cfg, verify=True, **kw)
            out[name] = dict(dir=str(d), phase3=p3, first=first, again=again,
                             forced=forced, verify=verify)
    finally:
        os.chdir(cwd)
        mp.undo()
    return out


def _path(run, *parts):
    return os.path.join(run["dir"], *parts)


def test_phase3_outputs_equal_jax(runs, encoders):
    j, t = runs["jax"], runs["torch"]
    assert t["phase3"]["success"] and j["phase3"]["success"]
    for kind in ("word", "sentence"):
        csv_name = f"drugs_{kind}_chunks.csv"
        got = open(_path(t, "data", "processed", csv_name), "rb").read()
        assert got == open(_path(j, "data", "processed", csv_name),
                           "rb").read()
    js, ts = j["phase3"]["steps"], t["phase3"]["steps"]
    for key in ("word_chunks", "sentence_chunks", "word_stats",
                "sentence_stats"):
        assert ts["chunking"][key] == js["chunking"][key]
    assert ts["extract"]["chars"] == js["extract"]["chars"]
    assert ts["chunking"]["word_chunks"] > 50
    for kind in ("word", "sentence"):
        for key in ("num_vectors", "dim", "encode_failures", "memory_mb"):
            assert ts[f"{kind}_index"][key] == js[f"{kind}_index"][key]
        assert ts[f"{kind}_index"]["encode_fallback_items"] == 0
        assert ts[f"{kind}_collection"]["count"] == \
            js[f"{kind}_collection"]["count"]
        assert ts[f"{kind}_collection"]["persist_dir"] == \
            js[f"{kind}_collection"]["persist_dir"]
        base = os.path.join("results", "index", f"drugs_{kind}_chunks.npz")
        got = np.load(_path(t, base))["vectors"]
        want = np.load(_path(j, base))["vectors"]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # the smoke query's ranks stand apart, so equal ids mean something
        q = encoders[0].encode([jphase3.SMOKE_QUERY])
        d2 = np.sort(((want - q) ** 2).sum(1))[:4]
        assert np.diff(d2).min() > 1e-3
        for key in ("top_ids", "collection_top_ids", "success", "query"):
            assert ts[f"{kind}_smoke_test"][key] == \
                js[f"{kind}_smoke_test"][key]
        np.testing.assert_allclose(ts[f"{kind}_smoke_test"]["top_distances"],
                                   js[f"{kind}_smoke_test"]["top_distances"],
                                   rtol=1e-4)
    assert t["phase3"]["index_files"] == j["phase3"]["index_files"]
    written = json.load(open(_path(
        t, "results", "phase3_pdf_processing_results.json"), encoding="utf-8"))
    assert written["steps"]["word_index"]["num_vectors"] == \
        ts["word_index"]["num_vectors"]


def test_port_index_files_load_in_jax(runs):
    t = runs["torch"]
    for kind in ("word", "sentence"):
        base = _path(t, "results", "index", f"drugs_{kind}_chunks")
        vectors = np.load(base + ".npz")["vectors"]
        index = JaxDenseIndex.load(base)
        assert index.ntotal == vectors.shape[0] and index.metric == "l2"
        flat, metric = jio.read_faiss_flat(base + ".index")
        assert metric == "l2"
        np.testing.assert_array_equal(flat, vectors)
        store = JaxStore(path=_path(t, "results", "index", "collections"))
        col = store.get_or_create_collection(f"drugs_{kind}")
        assert col.count() == vectors.shape[0]
        got = col.query(query_embeddings=vectors[:3], n_results=2)
        assert [r[0] for r in got["ids"]] == [
            f"{kind}_chunk_{i}" for i in range(3)]


def test_create_embeddings_equals_jax(runs):
    j, t = runs["jax"], runs["torch"]
    for stage in ("first", "again", "forced"):
        jm, tm = j[stage]["models"], t[stage]["models"]
        assert list(tm) == list(jm) == ["tiny-model"]
        for kind in ("word", "sentence"):
            got, want = tm["tiny-model"][kind], jm["tiny-model"][kind]
            assert got["skipped"] == want["skipped"] == (stage == "again")
            assert got["path"] == want["path"]
            for key in ("num_vectors", "dim"):
                assert got.get(key) == want.get(key)
    jv, tv = j["verify"]["verify"], t["verify"]["verify"]
    assert list(tv) == list(jv) and len(tv) == 4
    for name in tv:
        assert tv[name] == jv[name] and tv[name]["ok"]
        base = os.path.join("results", "index", name)
        np.testing.assert_allclose(np.load(_path(t, base))["vectors"],
                                   np.load(_path(j, base))["vectors"],
                                   rtol=1e-4, atol=1e-4)


def test_encode_robust_counts_like_jax(encoders, monkeypatch):
    texts = ["دارو برای قلب", "ويتامين", "", "bad item", "درمان درد"]
    out = {}
    for name, enc in zip(("jax", "torch"), encoders):
        plain = enc.encode

        def failing(batch, batch_size=32, _plain=plain, **kw):
            if "bad item" in batch:
                raise RuntimeError("forced failure")
            return _plain(batch, batch_size=batch_size)

        monkeypatch.setattr(enc, "encode", failing)
        out[name] = enc.encode_robust(texts, batch_size=4)
        clean = enc.encode_robust(texts[:3], batch_size=4)
        assert clean[1] == {"failed": 0, "fallback_items": 0}
        monkeypatch.undo()
    (j_emb, j_stats), (t_emb, t_stats) = out["jax"], out["torch"]
    assert t_stats == j_stats == {"failed": 1, "fallback_items": 4}
    assert not t_emb[3].any()
    np.testing.assert_allclose(t_emb, j_emb, rtol=1e-4, atol=1e-5)


def test_build_encoder_refuses_what_it_cannot_load(tmp_path):
    cfg = Config()
    cfg.paths.models_dir = str(tmp_path / "models")
    native = tmp_path / "models" / "minilm_finetuned"
    native.mkdir(parents=True)
    (native / "params.msgpack").write_bytes(b"\x80")
    # a fine-tuned directory loads through EmbeddingTrainer.load_model:
    # without its config.json, or with a cut params.msgpack, it raises
    with pytest.raises(FileNotFoundError, match="config.json"):
        tcommon.build_encoder("org/minilm", cfg, device="cpu")
    (native / "config.json").write_text(json.dumps(
        {"encoder_config": {"vocab_size": 10}}))
    (native / "params.msgpack").write_bytes(b"\x82\xa7encoder\x81")
    with pytest.raises(ValueError, match="truncated"):
        tcommon.build_encoder("org/minilm", cfg, device="cpu")
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "config.json").write_text("{}")
    with pytest.raises(Exception):
        tcommon.build_encoder(str(broken), cfg, device="cpu")
    tiny = tcommon.build_encoder("tiny-model", cfg, tiny=True, device="cpu")
    assert tiny.config == tcommon.TINY_PRESET and tiny.max_seq_len == 64
    assert tcommon.prefixes_for("intfloat/multilingual-e5-base") == {
        "query_prefix": "query: ", "passage_prefix": "passage: "}
    assert tcommon.short_name("a/b/c") == "c"
    # a mesh is ported: a non-Mesh raises, a mesh encodes data-parallel
    with pytest.raises(TypeError, match="Mesh"):
        tcommon.build_encoder("tiny-model", cfg, mesh=object())
    mesh = build_mesh(1, 2, devices=["cpu", "cpu"])
    dp = tcommon.build_encoder("tiny-model", cfg, tiny=True, mesh=mesh)
    assert dp.mesh is mesh and dp.data_parallel == 2
    np.testing.assert_allclose(dp.encode(["a b", "c d e"]),
                               tiny.encode(["a b", "c d e"]), atol=1e-5)


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-m", "persian_rag_tpu_torch", *args,
         "--config", "config.yaml", "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_cli_phase3_and_create_embeddings(tmp_path):
    (tmp_path / "config.yaml").write_text(
        'models:\n  - "tiny-model"\nchunking:\n  word_chunk_size: 40\n'
        "  word_overlap: 8\n  sentences_per_chunk: 4\n", encoding="utf-8")
    out = _cli(str(tmp_path), "phase3", "--tiny")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["success"] is True
    out = _cli(str(tmp_path), "create-embeddings", "--tiny", "--force")
    assert out.returncode == 0, out.stderr
    assert "tiny-model" in out.stdout
    out = _cli(str(tmp_path), "create-embeddings", "--tiny", "--verify")
    assert out.returncode == 0, out.stderr
    verify = json.loads(out.stdout)["verify"]
    assert len(verify) == 4 and all(v["ok"] for v in verify.values())


def test_cli_options_follow_their_commands():
    parse = tmain.build_parser().parse_args
    ns = parse(["create-embeddings", "--force", "--verify", "--config",
                "c.yaml"])
    assert ns.force and ns.verify and ns.config == "c.yaml"
    assert parse(["phase3", "--tiny", "--config", "c.yaml"]).tiny
    for argv in (["phase3", "--force"], ["serve", "--verify"]):
        with pytest.raises(SystemExit):
            parse(argv)
    for command in ("phase1", "run-all"):
        assert parse([command, "--tiny", "--config", "c.yaml"]).tiny
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 1"):
        tmain.main(["bench"])
