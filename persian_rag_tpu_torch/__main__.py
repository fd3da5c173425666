"""CLI: python -m persian_rag_tpu_torch <command>.

The counterpart of ``python -m persian_rag_tpu``, with its flags and
defaults. Ported so far:

* ``gen-serve`` serves the Llama-architecture decoder behind the
  llama.cpp HTTP contract (/completion, /v1/chat/completions) on the
  card: random weights (``--tiny`` or full Llama-3.2-1B width), an HF
  LlamaForCausalLM directory (``--checkpoint``) or a GGUF file
  (``--gguf``). Real weights without their tokenizer are refused (exit
  code 2): the byte fallback would emit garbage while looking healthy.
* ``gguf-export`` writes an HF LlamaForCausalLM directory as a
  llama.cpp-servable GGUF (``--quant q8_0|f16|f32``).
* ``serve`` builds BM25 over ``<paths.processed_dir>/drugs_word_chunks.csv``
  and serves ``RetrievalServer`` (POST /search, /rag) on ``--port``
  (default 8200).
* ``status`` prints which processed artifacts exist and what the LLM
  server at ``generation.server_url`` answers.
* ``phase3`` extracts ``<paths.raw_dir>/Drugs.pdf`` (synthetic Persian
  text without it), writes the word and sentence chunk CSVs, encodes them
  with the first configured model (``--tiny``: a small random encoder) and
  writes flat indexes, FAISS files and cosine collections under
  ``paths.index_dir``; it prints the results JSON.
* ``create-embeddings`` indexes the chunk CSVs for every configured model
  (``--force`` rebuilds existing indexes; ``--verify`` reloads and
  test-searches them instead).
* ``phase2`` scores every configured encoder by multiple-choice retrieval
  accuracy and prints the results JSON.
* ``phase4`` evaluates RAG end to end (retrieve, generate through the LLM
  server at ``generation.server_url``, score) for each chunk CSV and each
  of ``--methods`` (comma-separated, default ``bm25,tfidf``) and writes
  timestamped JSON and markdown reports; ``phase4-enhanced`` does it per
  configured encoder over the word chunks with rank metrics.
* ``phase1`` writes the train / test CSVs of the QA records, fine-tunes
  every configured encoder into ``<paths.models_dir>/<name>_finetuned``
  (``--tiny``: small random encoders) and prints the results JSON;
  ``run-all`` runs phase1, phase2, phase3 and phase4 in turn.
* ``fast-test`` opens the interactive menu of smoke checks.
* ``ui`` serves the web app on ``--port`` (default 7860).

``--config`` (default ``config.yaml``; a missing file gives the defaults)
is read by the commands of `_CONFIG_COMMANDS` only; the other commands
refuse it, ``--force`` / ``--verify`` are ``create-embeddings``' alone and
``--methods`` is ``phase4``'s.
``--device`` picks where the model or index lives: the card by default
(the command raises without CUDA), ``cpu`` for tests. ``bench`` raises
NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_UNPORTED = {
    "bench": "queue 1 item 1 (P0: the port's benchmark)",
}
# the commands that read --config
_CONFIG_COMMANDS = ("serve", "status", "phase1", "phase2", "phase3",
                    "phase4", "phase4-enhanced", "create-embeddings",
                    "run-all", "fast-test", "ui")
_PIPELINES = ("phase1", "phase2", "phase3", "phase4", "phase4-enhanced",
              "create-embeddings", "run-all")


class _Parser(argparse.ArgumentParser):
    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if ns.config is not None and ns.command not in _CONFIG_COMMANDS:
            self.error(f"unrecognized arguments: --config {ns.config} (read "
                       f"by {', '.join(_CONFIG_COMMANDS)} only)")
        for flag in ("force", "verify"):
            if getattr(ns, flag) and ns.command != "create-embeddings":
                self.error(f"unrecognized arguments: --{flag} (read by "
                           "create-embeddings only)")
        if ns.methods is not None and ns.command != "phase4":
            self.error(f"unrecognized arguments: --methods {ns.methods} "
                       "(read by phase4 only)")
        return ns


def build_parser() -> argparse.ArgumentParser:
    parser = _Parser(prog="persian_rag_tpu_torch")
    parser.add_argument(
        "command",
        choices=[
            "phase1", "phase2", "phase3", "phase4", "phase4-enhanced",
            "create-embeddings", "run-all",
            "fast-test", "status", "ui", "serve", "gen-serve", "bench",
            "gguf-export",
        ],
    )
    parser.add_argument("--config", default=None,
                        help=f"{' / '.join(_CONFIG_COMMANDS)}: the YAML "
                             "config (default config.yaml; a missing file "
                             "gives the defaults)")
    parser.add_argument("--tiny", action="store_true",
                        help="gen-serve: a tiny random-weight decoder; "
                             "phase1 / phase2 / phase3 / phase4 / "
                             "phase4-enhanced / create-embeddings / "
                             "run-all / ui: a tiny random encoder (smoke "
                             "runs)")
    parser.add_argument("--methods", default=None,
                        help="phase4: comma-separated retrieval methods "
                             "(bm25, tfidf, dense, hybrid; default "
                             "bm25,tfidf)")
    parser.add_argument("--force", action="store_true",
                        help="create-embeddings: rebuild existing indices")
    parser.add_argument("--verify", action="store_true",
                        help="create-embeddings: reload + test-search "
                             "every saved index")
    parser.add_argument("--mesh-corpus", type=int, default=1,
                        help="pipelines: shard the indexes over this many "
                             "devices; gen-serve: tensor-parallel decoder "
                             "over them")
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="pipelines: data-parallel encoding and "
                             "training over this many devices")
    parser.add_argument("--port", type=int, default=None,
                        help="serve port (default 8200) / gen-serve port "
                             "(default 8080, the reference llama.cpp port) "
                             "/ ui port (default 7860); 0 picks a free one")
    parser.add_argument("--checkpoint", default=None,
                        help="gen-serve / gguf-export: HF LlamaForCausalLM "
                             "checkpoint dir (.bin/.safetensors); omitted "
                             "= random weights (smoke serving)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="gen-serve: micro-batch cap for concurrent "
                             "requests")
    parser.add_argument("--continuous", action="store_true",
                        help="gen-serve: continuous batching (llama.cpp "
                             "slot scheduler)")
    parser.add_argument("--quantize", nargs="?", const="int8",
                        choices=["int8", "int4"], default=None,
                        help="gen-serve: serve decoder weights quantized "
                             "through the dequant kernels. Bare flag = "
                             "int8; int4 nibble-packs layer projections")
    parser.add_argument("--max-len", type=int, default=None,
                        help="gen-serve: context window (prompt + answer) "
                             "in tokens. Default 2048; --tiny 512")
    parser.add_argument("--quantize-kv", action="store_true",
                        help="gen-serve: int8 KV cache")
    parser.add_argument("--gguf", default=None,
                        help="gen-serve: llama.cpp GGUF file to serve "
                             "(f32/f16/bf16/q8_0/q4_0 tensors; the "
                             "embedded BPE tokenizer is rebuilt from the "
                             "file). gguf-export: output path.")
    parser.add_argument("--quant", default="q8_0",
                        choices=["q8_0", "f16", "f32"],
                        help="gguf-export: tensor storage in the written "
                             "file")
    parser.add_argument("--speculative", nargs="?", const=True,
                        default=False, choices=[True, "auto"],
                        metavar="auto",
                        help="gen-serve --continuous: prompt-lookup "
                             "speculative verification per row")
    parser.add_argument("--device", default=None,
                        help="where the model or index lives: the card by "
                             "default (raises without CUDA); 'cpu' for "
                             "tests")
    return parser


def _serve(generator, args, what: str) -> int:
    from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer

    server = LocalGenerationServer(
        generator, port=8080 if args.port is None else args.port,
        max_batch=args.max_batch, continuous=args.continuous,
        speculative=args.speculative,
    ).start()
    print(f"generation server at {server.url} (llama.cpp-compatible "
          f"/completion, /v1/chat/completions; {what})", flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()
    return 0


def _mesh(args):
    """The (--mesh-corpus, --mesh-data) mesh, None for a 1 x 1 one: over
    the CUDA devices (raises when there are too few), or over `--device`
    repeated when one is named."""
    n = args.mesh_corpus * args.mesh_data
    if n <= 1:
        return None
    from persian_rag_tpu_torch.core.mesh import build_mesh

    devices = None if args.device is None else [args.device] * n
    return build_mesh(args.mesh_corpus, args.mesh_data, devices=devices)


def _refuse(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _read_hf_decoder(checkpoint: str, device, **config_kw):
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig,
        params_from_llama,
    )
    from persian_rag_tpu_torch.models.hf_loader import _read_state_dict

    with open(os.path.join(checkpoint, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    config = DecoderConfig.from_hf(hf, **config_kw)
    sd = {k: v.to(device) for k, v in _read_state_dict(checkpoint).items()}
    return config, params_from_llama(sd, config)


def gen_serve(args) -> int:
    import torch

    from persian_rag_tpu_torch.core.device import resolve_device
    from persian_rag_tpu_torch.gen.generator import ByteTokenizer, TextGenerator
    from persian_rag_tpu_torch.models.decoder import DecoderConfig

    device = resolve_device(args.device)
    if args.max_len is None:
        args.max_len = 512 if args.tiny else 2048
    if args.gguf:
        generator = TextGenerator.from_gguf(
            args.gguf, max_len=args.max_len, quantize=args.quantize or None,
            quantize_kv=args.quantize_kv, device=device, mesh=_mesh(args))
        if isinstance(generator.tokenizer, ByteTokenizer):
            return _refuse(f"{args.gguf} embeds no tokenizer.ggml.tokens "
                           "metadata; gen-serve needs the file's tokenizer")
        return _serve(generator, args, f"GGUF: {args.gguf}")
    params, tokenizer = None, None
    if args.checkpoint:
        from persian_rag_tpu_torch.models.tokenizer import HFTokenizer

        tok_path = os.path.join(args.checkpoint, "tokenizer.json")
        if not os.path.exists(tok_path):
            return _refuse(
                f"{tok_path} not found; gen-serve needs the checkpoint's "
                "tokenizer.json (sentencepiece-only checkpoints: convert "
                "with transformers' convert_slow_tokenizer first)")
        tokenizer = HFTokenizer(tok_path)
        dec_config, params = _read_hf_decoder(
            args.checkpoint, device, compute_dtype=torch.bfloat16)
    elif args.tiny:
        dec_config = DecoderConfig.tiny(compute_dtype=torch.bfloat16)
    else:
        dec_config = DecoderConfig.llama32_1b(compute_dtype=torch.bfloat16)
    generator = TextGenerator(
        dec_config, params=params, tokenizer=tokenizer,
        max_len=args.max_len, quantize=args.quantize,
        quantize_kv=args.quantize_kv, device=device, mesh=_mesh(args))
    return _serve(generator, args, "random weights — smoke only"
                  if params is None else "checkpoint loaded")


def gguf_export(args) -> int:
    from persian_rag_tpu_torch.core.device import resolve_device
    from persian_rag_tpu_torch.models.gguf import (
        tokenizer_metadata_from_hf,
        write_decoder_gguf,
    )

    if not args.checkpoint or not args.gguf:
        return _refuse("usage: gguf-export --checkpoint <hf_dir> --gguf "
                       "<out.gguf> [--quant q8_0|f16|f32]")
    device = resolve_device(args.device)
    dec_config, params = _read_hf_decoder(args.checkpoint, device)
    extra = None
    tok_json = os.path.join(args.checkpoint, "tokenizer.json")
    if os.path.exists(tok_json):
        extra = tokenizer_metadata_from_hf(tok_json)
    else:
        print("warning: no tokenizer.json in the checkpoint — the exported "
              "GGUF will not tokenize under llama.cpp", file=sys.stderr)
    write_decoder_gguf(
        args.gguf, dec_config, params, quant=args.quant,
        name=os.path.basename(args.checkpoint.rstrip("/")) or "decoder",
        extra_metadata=extra,
    )
    size = os.path.getsize(args.gguf)
    print(f"wrote {args.gguf} ({size / 1e6:.1f} MB, {args.quant})")
    return 0


def serve(args) -> int:
    from persian_rag_tpu_torch.core.config import load_config
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
    from persian_rag_tpu_torch.serve.api import RetrievalServer

    config = load_config(args.config or "config.yaml")
    chunk_csv = os.path.join(config.paths.processed_dir,
                             "drugs_word_chunks.csv")
    retriever = RetrievalSystem(method="bm25", device=args.device)
    retriever.load_chunks_and_index(chunk_csv)
    server = RetrievalServer(
        retriever, port=8200 if args.port is None else args.port).start()
    print(f"retrieval API at {server.url} (POST /search, /rag)", flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()
    return 0


def status(args) -> int:
    from persian_rag_tpu_torch.core.config import load_config
    from persian_rag_tpu_torch.pipelines.fast_test import show_system_status

    out = show_system_status(load_config(args.config or "config.yaml"))
    print(json.dumps(out, ensure_ascii=False, indent=2, default=str)[:4000])
    return 0


def pipeline(args) -> int:
    from persian_rag_tpu_torch.core.config import load_config

    config = load_config(args.config or "config.yaml")
    kw = dict(tiny=args.tiny, device=args.device, mesh=_mesh(args))
    if args.command == "phase1":
        from persian_rag_tpu_torch.pipelines import phase1

        out = phase1.main(config, **kw)
    elif args.command == "run-all":
        from persian_rag_tpu_torch.pipelines import run_all

        out = run_all.main(config, **kw)
    elif args.command == "phase2":
        from persian_rag_tpu_torch.pipelines import phase2

        out = phase2.main(config, **kw)
    elif args.command == "phase3":
        from persian_rag_tpu_torch.pipelines import phase3

        out = phase3.main(config, **kw)
    elif args.command == "phase4":
        from persian_rag_tpu_torch.pipelines import phase4

        methods = args.methods.split(",") if args.methods else None
        out = phase4.main(config, methods=methods, **kw)
    elif args.command == "phase4-enhanced":
        from persian_rag_tpu_torch.pipelines import phase4_enhanced

        out = phase4_enhanced.main(config, **kw)
    else:
        from persian_rag_tpu_torch.pipelines import create_embeddings

        out = create_embeddings.main(
            config, force=args.force, verify=args.verify, **kw)
    print(json.dumps(out, ensure_ascii=False, indent=2, default=str)[:4000])
    return 0


def fast_test(args) -> int:
    from persian_rag_tpu_torch.core.config import load_config
    from persian_rag_tpu_torch.pipelines import fast_test as ft

    ft.run_menu(load_config(args.config or "config.yaml"), device=args.device)
    return 0


def ui(args) -> int:
    from persian_rag_tpu_torch.core.config import load_config
    from persian_rag_tpu_torch.ui.app import launch

    launch(load_config(args.config or "config.yaml"),
           port=7860 if args.port is None else args.port, tiny=args.tiny,
           device=args.device)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command in _UNPORTED:
        raise NotImplementedError(
            f"{args.command} is not ported to persian_rag_tpu_torch yet "
            f"(ROADMAP {_UNPORTED[args.command]})")
    if args.command == "serve":
        return serve(args)
    if args.command == "status":
        return status(args)
    if args.command in _PIPELINES:
        return pipeline(args)
    if args.command == "fast-test":
        return fast_test(args)
    if args.command == "ui":
        return ui(args)
    if args.command == "gen-serve":
        return gen_serve(args)
    return gguf_export(args)


if __name__ == "__main__":
    sys.exit(main())
