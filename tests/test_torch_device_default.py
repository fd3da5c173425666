"""Every entry point of the port runs on the card unless the caller asks
for the CPU: without `device` it resolves `require_cuda()`, which raises on
a host without CUDA (no quiet CPU run); `device="cpu"` works."""
import pytest
import torch

from persian_rag_tpu_torch.core.device import require_cuda, resolve_device
from persian_rag_tpu_torch.gen.generator import TextGenerator
from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
from persian_rag_tpu_torch.index.collections import Collection
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.index.ivf import IVFIndex
from persian_rag_tpu_torch.index.lexical import BM25Index, TfidfIndex
from persian_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    init_cache,
    random_quantized_params,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.pipelines.common import build_encoder
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem

TINY = EncoderConfig(vocab_size=50, hidden_size=8, num_layers=1, num_heads=2,
                     intermediate_size=16, max_position_embeddings=16)

DEC = DecoderConfig.tiny(num_layers=1)

ENTRY_POINTS = {
    "DenseIndex": lambda **kw: DenseIndex(8, **kw),
    "BM25Index": lambda **kw: BM25Index(**kw),
    "TfidfIndex": lambda **kw: TfidfIndex(**kw),
    "SentenceEncoder": lambda **kw: SentenceEncoder(TINY, **kw),
    "RetrievalSystem": lambda **kw: RetrievalSystem(method="bm25", **kw),
    "TextGenerator": lambda **kw: TextGenerator(DEC, **kw),
    "BM25Index.load": lambda **kw: BM25Index.load("missing", **kw),
    "TfidfIndex.load": lambda **kw: TfidfIndex.load("missing", **kw),
    "IVFIndex": lambda **kw: IVFIndex(8, **kw),
    "IVFIndex.load": lambda **kw: IVFIndex.load("missing", **kw),
    "Collection": lambda **kw: Collection("docs", **kw),
    "build_encoder": lambda **kw: build_encoder("tiny-model", tiny=True,
                                                **kw),
}


@pytest.fixture
def no_cuda(monkeypatch):
    """This host has no card; pin it, so that the test says the same on a
    host that has one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_needs_cuda(name, no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", [n for n in sorted(ENTRY_POINTS)
                                  if not n.endswith(".load")])
def test_cpu_on_request(name, no_cuda):
    assert ENTRY_POINTS[name](device="cpu").device == torch.device("cpu")


def test_retrieval_system_follows_its_encoder(no_cuda):
    enc = SentenceEncoder(TINY, device="cpu")
    assert RetrievalSystem(method="hybrid", encoder=enc).device == enc.device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        require_cuda()


def test_generation_defaults_to_the_card(no_cuda):
    """The decoder's tree and cache makers need the card too, and a generation server
    serves its generator where that lives."""
    for build in (lambda: random_quantized_params(DEC),
                  lambda: init_cache(DEC, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    tree = random_quantized_params(DEC, device="cpu")
    assert tree["embed_tokens"]["values"].device == torch.device("cpu")
    gen = TextGenerator(DEC, device="cpu")
    server = LocalGenerationServer(gen)
    with server:
        assert server.generator.device == torch.device("cpu")


def test_loaded_encoder_and_cli_default_to_the_card(no_cuda, tmp_path):
    """SentenceEncoder.from_pretrained and the CLI's gen-serve /
    gguf-export take the card unless --device / device= names another."""
    transformers = pytest.importorskip("transformers")
    from persian_rag_tpu_torch import __main__ as cli

    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=50, hidden_size=8, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=16,
        max_position_embeddings=140)).save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SentenceEncoder.from_pretrained(str(tmp_path))
    enc = SentenceEncoder.from_pretrained(str(tmp_path), device="cpu")
    assert enc.device == torch.device("cpu")
    for argv in (["gen-serve", "--tiny"],
                 ["gguf-export", "--checkpoint", str(tmp_path), "--gguf",
                  str(tmp_path / "out.gguf")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert cli.build_parser().parse_args(["gen-serve"]).device is None


def test_mesh_defaults_to_the_cards(no_cuda):
    """build_mesh() takes the CUDA devices (raises without them); with a
    mesh of CPU devices every entry point lives on the mesh's first
    device."""
    from persian_rag_tpu_torch.core.mesh import build_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh(2, 1)
    mesh = build_mesh(2, 1, devices=["cpu", "cpu"])
    for name in sorted(ENTRY_POINTS):
        if name.endswith(".load"):
            continue
        assert ENTRY_POINTS[name](mesh=mesh).device == torch.device("cpu"), \
            name
    index = DenseIndex(8, mesh=mesh)
    index.add(torch.randn(5, 8).numpy())
    scores, ids = index.search(torch.randn(2, 8).numpy(), 3)
    assert ids.device == torch.device("cpu") and ids.shape == (2, 3)
