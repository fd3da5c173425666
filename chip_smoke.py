"""Chip smoke test of persian_rag_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — dense (flat and IVF), BM25 and hybrid
retrieval and quantized Llama generation served over HTTP, statically and
continuously batched, the ingest path (PDF -> chunks -> encoder ->
index files), the evaluation pipelines and the UI, training (the
embedding trainer, phase1, LoRA) and the parallel layer (sharded search,
data-parallel encoding and training, a tensor-parallel decoder) — at the
full width of
paraphrase-multilingual-MiniLM-L12-v2 over a 100,000-chunk Persian corpus
and of Llama-3.2-1B (random weights from a seed), and checks it:

1. device: the card's name, capability and nvidia-smi power limit;
2. build: compiles the CUDA kernels from ``persian_rag_tpu_torch/csrc``;
3. kernel vs plain: both stage-1 candidate kernels against their plain
   PyTorch version at N=100,000, d=384, Q in {1, 16, 64, 512}, l2 and dot:
   the extracted keys and bounds hold the proof contract, and the two-stage
   ids equal the full f32 scan's; median CUDA-event times of both beside
   the byte bound and the f32 floor. Each kernel's keys also equal, bit
   for bit, the f32 chain it computes (flat_topk.bf16_chain_scores,
   bf16x2_chain_scores), a second call's, and a query's alone and in a
   batch of nine (the bf16 kernel's also in the (d, N) layout); then at
   their edges (bf16x2: odd d, d = 512 and 768, tiles of 128, 1,000 and
   2,048 rows, d = 2,048 and 2,050 in query windows; bf16: odd d, n_easy 1
   and 7, d = 777, 2,048 and 4,001 in query windows, tiles of 128 and a
   short one, both layouts);
3c. width: DenseIndex at d = 1,024 and 2,048 (past what a block of the
   bf16x2, running and, at 64 queries, bf16 and int8 kernels holds of its
   queries: they stage them in windows) over 100,000 seeded clustered
   rows, f32 (its commit probe: bf16), bf16, raw int8 and int8 + refine
   storage, Q = 64, a batch of 16 on an index pinned to bf16x2, modes
   fasti and fastg, and maxonly: no call raises, each launches a dense
   kernel and prints the regime and kernels that served it, and the ids
   equal an f64 ranking of the tier's operands, near-ties aside;
4. dense end to end: a RetrievalServer answers /health, 176 /search
   requests of 1-16 queries (80 from one client, then 96 from 8
   concurrent clients) and /rag; every served id list equals an exact f32
   scan for the same query embeddings, and the candidate kernels' launch
   counters rose during this phase. It prints p50/p90 request latency of
   each phase and the concurrent phase's queries per second. The commit
   probe picks one stage-1 kernel for the encoded corpus; a second
   deployment of the same vectors is forced onto the other kernel.
5. lexical corpus: 100,000 seeded chunks (85% of 150 words, 15% tails of
   10-149) drawn Zipf (s=1.1) over WORDS plus 50,000 synthetic Persian
   forms. Its BM25 index has narrow flat buckets and a hashed 150-word
   bucket.
6. sparse kernels vs plain: the four sparse top-k kernels against their
   plain PyTorch versions at the index's own bucket shapes, B in {1, 16,
   64, 512}, k=10 (the per-term kernels must equal plain bit for bit);
   median CUDA-event times of both; then one request each to #11 and #10
   at the edges of their query table (13 queries, a term twice in one query
   and shared by another, an all-pad row; k = 10 and 300; T >= 64 for #11,
   T = 3,400 for #10, past the earlier #10's limit), equal to plain.
7. BM25 and TF-IDF: RetrievalSystem(method="bm25") on the card behind
   RetrievalServer under the same 176-request load, then in-process
   batches of 128 and 512 queries past the union gate, and a union edge
   batch (a union of several 64-term chunks, k = 10 and 200: #12 must
   launch); TF-IDF over the first TFIDF_CHUNKS of the same texts in
   process. Every id list is held to an f64 scorer of the
   same ELL (scipy CSR), near-ties within the f32 bound counted. Then #13:
   its walk held to plain at B = 128 and 512 and on a union edge request,
   k = 10 and 200, with a hash of its outputs, timed beside #11 on the
   same queries; and through each of the four entries one request of
   6,400 query slots (past what one block holds: walked in passes) held
   to plain, and 3,000 live slots padded to 6,400 (passes) bit-equal to
   the same rows at their live width (one pass).
7b. the lexical leftovers, over the same corpus: native (the index of C's
   first 25,000 chunks by the native builder and by the Python builder,
   bit-equal, both timed);
   twopass (stage 1 of #12 over C's largest flat bucket and over C16, C's
   chunks cut to their first 16 words, and of #13 over C's hashed bucket,
   bit-equal to plain at B = 128 and 512 and timed beside the exact modes;
   then two_pass="auto" batches of 128 and 512 at k = 10 and 16 through C
   and C16, held to the f64 scorer and the exact kernels' lists, with the
   proof pass rate, the fallbacks and the stage-1 launches); prefilter
   (build_prefilter over C, "verified" ids equal to the exact scan,
   "fast" Recall@10, the proof pass rate, #1's launches); cli (`python -m
   persian_rag_tpu_torch serve --config` in a subprocess over C's chunks
   as a CSV, on the card, 100 /search requests equal to the in-process
   system's, then `status`).
8. hybrid: the first 33,000 of the same chunks encoded once with the
   full-width encoder,
   RetrievalSystem(method="hybrid") served under the same load, then
   in-process rerank. Every dispatch's fused lists equal the host fusion
   loop applied to its own channel outputs; the dense channel is held to
   the f32 scan, the BM25 channel to the f64 scorer, the rerank to a host
   cosine.
9. storage tiers: kernel #4 (int8 row-scaled candidates; also bit for
   bit against the chain it computes, flat_topk.int8_chain_candidates) and
   the running top-k kernels #5 / #6 against their plain versions at the
   shapes the tiers give them; deployment E (int8 + exact refine, cosine) and F (bf16
   storage, l2, behind the commit-time quality gate) served over HTTP under
   the same load over deployment A's vectors; raw int8, int8 + refine below
   the candidate-pool gate and search_mode="fast" in process; then index
   files: save -> load and export_faiss -> from_faiss -> RetrievalSystem.
   Then kernels #3, #7, #8 and #9 (phase 9b, run beside #4-#6): first the
   entry points that reach them, counted (DenseIndex search_mode fasti /
   fastg at 100k, equal to mode fast's lists; the two-stage regime with a
   grouped stage 1 at Q=2,048 x 100k and with JAX's lane-sliced pick, 16
   slots depth 3 at tile 2,048, over 1M x 384 at Q=2,048; flat_topk mode
   maxonly); then #3 against its plain version and the stage-1 contract
   (group 16 at tile 1,024, Q in {64, 2048}, dot and l2; the lane slice on
   256 of its queries), the two-stage ms and proof rate with and without
   it; #7 and #8 equal to #6's lists and held to their plain versions, #9
   to its plain version and the f64 maximum and equal to #5's first score
   (the same f32 chain), at #5 / #6's cases and N =
   20,481-20,483; every kernel that takes the (d, N) layout equal bit for
   bit to its (N, d) result.
10. quantized matmuls: kernels #14, #15 and #17 (int8 weights), #18 (int4)
   and #16 (int8 x int8) against their plain versions at the Llama-3.2-1B
   shapes, at every activation row count that picks another instantiation
   (1, 2, 3, 4, 5, 7, 8, 64, 256): within the f32 summation bound of the f64
   result (#16: bit-equal), a row alone bit-equal to the row in a batch; at
   1, 8, 64 and 256 rows device times beside the bound, the plain version and
   the library product (bf16 matmul; torch._int_mm for #16); #14, #15 and
   #17 also at edge shapes (one chunk, a ragged last chunk, one strip).
10b. the matvec probe: kernel #19 (the 2-D w8a16 tile of
   scripts/bench_matvec_probe.py) against its plain version at the probe's
   four Llama-3.2-1B shapes, every tile the probe runs there and every row
   count above (within the f32 summation bound, rows alone bit-equal, two
   calls bit-equal, bit-equal again after another tile's launch, tiles of
   equal block_k bit-equal); then the
   probe entry point (persian_rag_tpu_torch.scripts.bench_matvec_probe) at
   batch 1 and 8, which must launch #19: every arm's time, GB/s and share
   of the byte bound.
11. generation: TextGenerator at the full width of Llama-3.2-1B (random int8
   weights, bf16 compute) behind LocalGenerationServer: logits with the
   kernels against logits with their plain versions at batches 1, 2, 3 and
   5 (bf16 and f32 compute), the greedy routes against the host loop on
   several prompts, then /completion (sequential, concurrent, streamed),
   /v1/chat/completions, /embedding and, through LlamaClient and
   RetrievalServer, /rag over the dense deployment; the largest and the
   smallest group the server formed are replayed in process (equal answers)
   and with the plain versions (equal, or parting at a near tie); the three
   kernels' launch counters must stand 96 : 1 : 16 per decode forward.
12. continuous int4 generation: the same model with int4 layer weights
   (deployment H) behind LocalGenerationServer(continuous=True, max_batch=8,
   segment=32): logits with the kernels against plain, ContinuousBatcher
   greedy streams (plain and speculative, requests admitted mid-flight)
   against the single-request loop, then G's served load with /slots polled
   (more than one busy row) and /props; two served requests, spread over
   the served order, replayed in process (equal) and with the plain
   versions (equal, or parting at a near tie); #18 : #15 launches 112 : 1
   per forward, #14 and #17 idle; H's decode forward and p50 / p90 printed
   beside G's from the same call.
13. files: deployment A's encoder written as a sentence-transformers
   directory (F32 safetensors under HF BERT names, mean pooling, a
   250,037-piece Unigram tokenizer.json with a Precompiled normalizer and
   Metaspace), loaded by RetrievalSystem(model_path=) over A's first
   FILES_CHUNKS chunks and
   served (60 sequential and 80 concurrent /search requests): embeddings
   on the same ids within 1e-5 of A's, ids equal to the f32 scan, a
   stage-1 kernel launched; then a Q8_0 GGUF of Llama-3.2-1B (seeded bf16
   weights, an embedded 128,256-entry byte-level BPE tokenizer) written by
   write_decoder_gguf, loaded by TextGenerator.from_gguf (logits within
   0.12 of plain, #14 / #15 / #17 launched, prompts round-trip through the
   tokenizer) and served by `python -m persian_rag_tpu_torch gen-serve
   --gguf` in a subprocess, whose 3 greedy answers must equal the
   in-process server's. The files live in a temporary directory.
14. ingest (after 9, over deployment A's vectors): IVF at a user's size,
   RetrievalSystem(dense_index_type="ivf") at its defaults (100 cells,
   nprobe 8), its state on the card, 104 /search requests (24 from one
   client, 80 from 8), every served list equal to the search it came from
   and, near-ties aside (<= 1%), to the same state searched on the CPU;
   Recall@10 against the f32 scan, the exported IVF FAISS file served
   again with equal lists, calibrate_nprobe(0.95). Then phase3.main in
   process at the full width of the MiniLM-L12 preset (random weights) over
   a generated 1,000-page Flate-compressed PDF of 42,000 seeded contexts
   (~1.4 M words): all text extracted, no encode failure or fallback, the
   word and sentence indexes (the sentence index in the two-stage regime)
   and the reopened cosine collection held to the f32 scans on 32 queries;
   create-embeddings over the chunk CSVs for MiniLM alone, then --verify
   (`phase3 --tiny` from the command line runs in 16's `run-all --tiny`).
15. evaluate (after 14, over its phase3's chunk CSVs: 10,959 word and
   33,600 sentence chunks; 200 test items from the records that made its
   PDF): phase2.main over the three configured encoders at their presets
   (random weights), phase4.main over both chunk types with bm25, tfidf,
   dense and hybrid (sample 50), phase4_enhanced.main over the word chunks
   and the three encoders, both against the extractive FakeLlamaServer;
   RAGEvaluator.evaluate_single_rag of 2 questions over the dense
   sentence-chunk system through LlamaClient and G's model behind
   LocalGenerationServer (no failed group, every request answered over
   HTTP); the UI (`launch`, method dense, MiniLM at full width) with
   /api/init and 3 /api/ask, whose contexts equal get_contexts_for_rag's.
   No retrieval fails; every served list is held to its exact scorer
   (dense: the f32 scan; BM25 / TF-IDF: the f64 scorer; hybrid: the host
   fusion loop) up to near-ties; every results file holds the JAX
   package's key names; #1 or #2, #10-#13 and #14 / #15 / #17 launch.
16. train (last): EmbeddingTrainer at the full width of MiniLM-L12
   (random weights, 128 tokens): two steps on the card and on the CPU from
   the same weights and batch (loss within 1e-5, parameters within one
   step at the default rate), 60 steps of 16 under the warmup-linear
   schedule (the late loss below the early; ms a step, samples/s, peak
   memory), save_model -> build_encoder bit-equal, a checkpoint at step 4
   and a resume equal to the uninterrupted run bit for bit; `python -m
   persian_rag_tpu_torch phase1` over the three configured encoders at full
   width (64 records) in a subprocess, each fine-tuned directory loaded by
   build_encoder; LoraTrainer at the full width of Llama-3.2-1B (random f32
   base, rank 32, alpha 32, batch 4, 128 tokens: the merged tree equals the
   base at step 0, the loss falls, the merged tree's logits equal the
   training forward's), its merged tree int8-quantized and served greedy
   through #14 / #15 / #17 (logits within G's limit of plain); and `run-all
   --tiny` in a subprocess against a FakeLlamaServer.
17. parallel (after the lexical phases, before 16): meshes of the card
   (distinct cards where the host has them, else cuda:0 repeated): A's
   vectors in RetrievalSystem(mesh=) on a (2, 2) mesh (50,000 rows a
   shard: #1 or #2 on each, the 2-D route and the 1-D one held to the f32
   scan, 8 /search requests through RetrievalServer equal to the system's
   own answers), E's int8 + refine tier at corpus 4 (#4 on each shard,
   exact refined scores, Recall@k >= 0.99), C's BM25 ELL at corpus 4 (a
   per-term and a union batch: #10-#13, held to the f64 scorer), A-IVF's
   cells at corpus 4 (equal to the CPU's sharded search near-ties aside,
   Recall@10 at least the single-device probe's), a data-parallel MiniLM
   encode and 2 EmbeddingTrainer steps at data 2 held to one device's, and
   G's int8 Llama-3.2-1B at TP 2 (logits within G's limit, 16 greedy
   tokens of 2 prompts equal to one device's).
``python3 chip_smoke.py --gen-readings 0 1 2`` runs 10, 11 and 12 alone, 11
and 12 once per seed, and prints the readings that their limits are set
from.
Every kernel's launch counter must have risen on a served or in-process
path. The kernels line gives, for each kernel, its time beside its bound
(the larger of bytes over the card's 3.35 TB/s and operations over its
peak rate for their type) and, where one PyTorch call does the same work,
that call's time.

It needs CUDA and exits non-zero without it (it never falls back to the
CPU). The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
and a ``geometry`` line before that gives the launches of #1, #2, #4 and
#10-#13 (as their C entries pick them), #14 on the main path, and the
slots a pass of #10-#13 on a query longer than one block holds.
"""
from __future__ import annotations

import csv
import hashlib
import json
import math
import multiprocessing
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib

import numpy as np
import torch

N_CORPUS = 100_000
DIM = 384
SEED = 0
# the served /search load of each deployment
REQUEST_SIZES = (1, 2, 4, 8, 16)  # queries per request
# one client back to back, then CLIENTS closed-loop concurrent clients:
# 176 requests (280 until the evaluate phase needed the time; 440 before
# PR 20)
SEQ_REQUESTS = 80
CLIENTS, PER_CLIENT = 8, 12

# a small Persian vocabulary for seeded chunk and query texts
WORDS = (
    "دارو درمان بیماری پزشک بیمارستان سلامت قلب خون فشار دیابت سرطان "
    "ویروس واکسن کودک مادر تغذیه ورزش خواب درد سر معده کبد کلیه ریه "
    "عفونت آنتی‌بیوتیک قرص شربت آمپول جراحی آزمایش تشخیص علائم نشانه "
    "پیشگیری مراقبت پرستار داروخانه نسخه دوز عوارض حساسیت آلرژی پوست "
    "چشم گوش دندان استخوان عضله مفصل التهاب تب سرفه سرماخوردگی آنفولانزا "
    "کرونا بهداشت آب غذا میوه سبزی گوشت شیر نان برنج روغن نمک قند "
    "ویتامین آهن کلسیم پروتئین چربی کربوهیدرات وزن چاقی لاغری رژیم "
    "اضطراب افسردگی استرس روان اعصاب مغز حافظه سالمند نوزاد بارداری "
    "زایمان شیردهی ژنتیک ارثی مزمن حاد شدید خفیف درمانی بالینی پژوهش "
    "مطالعه نتیجه روش کتاب فصل بخش صفحه قانون حقوق تاریخ ایران تهران "
    "دانشگاه دانشجو استاد کلاس درس امتحان زبان فارسی ادبیات شعر شاعر "
    "حافظ سعدی فردوسی مولوی کشور شهر روستا خانه خانواده کار اقتصاد "
    "بازار قیمت پول بانک است و در به از که این را با برای یک هر"
).split()


def log(msg: str) -> None:
    print(msg, flush=True)


def run_phase(name: str, fn, *args, **kw):
    """fn(*args, **kw), with a `phase` line of its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log("phase " + json.dumps({"name": name,
                               "seconds": time.perf_counter() - t0}))
    return out


def cuda_median_ms(fn, runs: int = 15, warmup: int = 3) -> float:
    """Median of per-run CUDA-event times (ms) of fn() on the current
    stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_median_ms(fn, runs: int = 15, warmup: int = 3) -> float:
    """Median host time (ms) of one fn() call, the card idle at its start:
    what the wrapper costs the host before its work is queued."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def cuda_queued_ms(fn, launches: int = 20, reps: int = 7,
                   warmup: int = 3) -> float:
    """Device time (ms) of one fn(): `launches` calls are queued behind a
    spin of a few milliseconds, so the host runs ahead and the calls run
    back to back on the card; the median over `reps` of the CUDA-event time
    divided by `launches`. For a kernel of a few microseconds, whose
    one-call event time would be the host's launch path."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(8_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, dense FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def roofline(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the HBM rate, or the operations at
    the peak rate of their operand type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[kind]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# -- phase 3: kernels against their plain version ---------------------------


def _decode(slots: torch.Tensor, ft) -> torch.Tensor:
    return ft._ikey_to_score(slots & ~ft._COL_MASK)


def check_contract(slots, ref, eps, tile_n, n_easy, ft) -> float:
    """Hold candidate slots (Q, J, n_easy+1) to the stage-1 contract
    against ref (Q, N), the full-f32 score the stage-1 value approximates
    within eps (Q,). Returns the largest violation (<= 0 when it holds)."""
    n_q, n = ref.shape
    n_tiles = slots.shape[1]
    keys = slots[:, :, :n_easy]
    val = _decode(keys, ft)
    bump = val + val.abs() * 2.0 ** -11
    col = (tile_n - 1 - (keys & ft._COL_MASK)).long()
    rows = torch.arange(n_tiles, device=ref.device)[None, :, None] * tile_n + col
    present = keys != ft._INT_MIN
    if not bool((rows[present] < n).all()):
        raise AssertionError("an extracted key decodes to a row >= N")
    got = torch.gather(ref, 1, torch.where(present, rows, 0).reshape(n_q, -1))
    got = got.reshape(keys.shape)
    e = eps[:, None, None]
    over = torch.maximum(got - (bump + e), (val - e) - got)
    worst = float(torch.where(present, over, -torch.inf).max())
    # every element not extracted is bounded by its tile's bound key
    padded = torch.full(
        (n_q, n_tiles * tile_n), -torch.inf, device=ref.device
    )
    padded[:, :n] = ref
    padded = padded.view(n_q, n_tiles, tile_n)
    taken = torch.zeros(padded.shape, dtype=torch.int32, device=ref.device)
    taken.scatter_add_(2, torch.where(present, col, 0), present.int())
    padded = padded.masked_fill(taken > 0, -torch.inf)
    rest = padded.max(dim=2).values
    bound = _decode(slots[:, :, n_easy], ft)
    bound = bound + bound.abs() * 2.0 ** -11
    over_b = torch.where(
        torch.isfinite(rest), rest - (bound + eps[:, None]), -torch.inf
    )
    return max(worst, float(over_b.max()))


# the stage-1 query batches: a request's query alone, a served request, a
# full dispatch, an indexing batch
CAND_Q = (1, 16, 64, 512)
# (d, N, Q, tile_n) of the bf16x2 kernel's edges, each held bit for bit to
# the f32 chain it mirrors: odd d (rows staged by the threads) at 16
# queries a block, d = 512 at 32, d = 768 at 16, a tile of one partial part
# and tiles of one part (128 rows) at 8, tiles of eight parts (2,048 rows),
# Q off every query block
X2_EDGES = ((385, 5_000, 9, 1024), (512, 20_000, 40, 1024),
            (768, 20_000, 64, 1024), (384, 1_000, 3, 1024),
            (384, 5_000, 20, 2048), (384, 300, 5, 128),
            (2_048, 5_000, 17, 1024), (2_050, 3_000, 5, 1024))


def x2_edge_phase(ft, dev) -> list:
    """The bf16x2 kernel (#2) at X2_EDGES, l2 and dot: its slots equal
    `bf16x2_chain_candidates` bit for bit and hold the stage-1 contract."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = []
    for d, n, n_q, tile_n in X2_EDGES:
        corpus = torch.randn(n, d, device=dev, generator=g)
        corpus /= corpus.norm(dim=1, keepdim=True)
        csq = torch.sum(corpus * corpus, dim=-1)
        hi = corpus.bfloat16()
        lo = (corpus - hi.float()).bfloat16()
        q = torch.randn(n_q, d, device=dev, generator=g)
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        chain = ft.bf16x2_chain_scores(q, hi, lo)
        with ft.full_f32():
            ref_dot = q @ corpus.T
        for metric in ("dot", "l2"):
            cn = csq if metric == "l2" else None
            got = ft.extract_candidates_bf16x2_cuda(q, hi, lo, cn, tile_n, 4)
            torch.cuda.synchronize()
            s = 2.0 * chain - csq[None, :] if cn is not None else chain
            want = ft._tile_slots(s, tile_n, 4)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"bf16x2 d={d} N={n} Q={n_q} tile {tile_n} {metric}: "
                    f"keys differ from the f32 chain at "
                    f"{int((got != want).sum())} of {got.numel()} slots")
            err_f = 2.0 if metric == "l2" else 1.0
            ref = 2.0 * ref_dot - csq[None, :] if cn is not None else ref_dot
            eps = err_f * ft._bf16x2_matmul_eps(d) * q.norm(dim=1) * float(
                torch.sqrt(csq.max()))
            violation = check_contract(got, ref, eps, tile_n, 4, ft)
            if violation > 0:
                raise AssertionError(
                    f"bf16x2 d={d} N={n} Q={n_q} {metric}: stage-1 contract "
                    f"violated by {violation:.3e}")
            rows.append({"d": d, "N": n, "Q": n_q, "tile_n": tile_n,
                         "metric": metric, "same_keys": 1.0,
                         "contract_margin": violation,
                         "geometry": ft.bf16x2_geometry(
                             n_q, n, d, tile_n)._asdict()})
    log("x2edge " + json.dumps(rows))
    return rows


def kernel_phase(ft) -> dict:
    """Both candidate kernels against the plain version at serving width;
    each also bit for bit against the f32 chain it mirrors, across two
    calls and with a query alone (#1 also in the (d, N) layout)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    corpus = torch.randn(N_CORPUS, DIM, device=dev, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    # the serving caches, built as DenseIndex.commit builds them
    csq = torch.sum(corpus * corpus, dim=-1)
    mu = corpus.mean(dim=0)
    centered = corpus - mu[None, :]
    center_sqmax = torch.max(torch.sum(centered * centered, dim=-1))
    hi = centered.bfloat16()
    hi_t = hi.t().contiguous()
    lo = (centered - hi.float()).bfloat16()
    tile_n, n_easy = ft.TWO_STAGE_TILE_N, 4
    results = {"bf16": [], "bf16x2": []}
    for n_q in CAND_Q:
        idx = torch.randint(0, N_CORPUS, (n_q,), device=dev, generator=g)
        q = corpus[idx] + 0.3 * torch.randn(
            n_q, DIM, device=dev, generator=g
        ) / DIM ** 0.5
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        with ft.full_f32():
            ref_dot = q @ centered.T
        chains = {"bf16": ft.bf16_chain_scores(q, hi),
                  "bf16x2": ft.bf16x2_chain_scores(q, hi, lo)}
        for metric in ("dot", "l2"):
            cn = csq if metric == "l2" else None
            ref = 2.0 * ref_dot - csq[None, :] if metric == "l2" else ref_dot
            err_f = 2.0 if metric == "l2" else 1.0
            qn = q.norm(dim=1)
            for variant, c_lo, wrapper, eps_fn in (
                ("bf16", None, ft.extract_candidates_bf16_cuda,
                 ft._bf16_matmul_eps),
                ("bf16x2", lo, ft.extract_candidates_bf16x2_cuda,
                 ft._bf16x2_matmul_eps),
            ):
                eps = err_f * eps_fn(DIM) * qn * torch.sqrt(center_sqmax)
                if c_lo is None:
                    def launch():
                        return wrapper(q, hi, cn, tile_n, n_easy)
                else:
                    def launch():
                        return wrapper(q, hi, c_lo, cn, tile_n, n_easy)

                def plain():
                    return ft.flat_topk_candidates_plain(
                        q, hi, cn, tile_n, n_easy, c_lo
                    )

                got = launch()
                torch.cuda.synchronize()
                want = plain()
                violation = max(
                    check_contract(got, ref, eps, tile_n, n_easy, ft),
                    check_contract(want, ref, eps, tile_n, n_easy, ft),
                )
                if violation > 0:
                    raise AssertionError(
                        f"{variant} {metric} Q={n_q}: stage-1 contract "
                        f"violated by {violation:.3e}"
                    )
                dk, dp = _decode(got, ft), _decode(want, ft)
                live = (got != ft._INT_MIN) | (want != ft._INT_MIN)
                max_err = float((dk - dp).abs()[live].max())
                tol = float(2 * eps.max() + 2.0 ** -10 * dp[live].abs().max())
                if not max_err <= tol:
                    raise AssertionError(
                        f"{variant} {metric} Q={n_q}: kernel vs plain "
                        f"{max_err:.3e} > {tol:.3e}"
                    )
                same = float((got == want).float().mean())
                if c_lo is None:
                    extra = stage1_bits(
                        ft, variant, lambda qq: wrapper(qq, hi, cn, tile_n,
                                                        n_easy),
                        q, got, chains[variant], cn, tile_n, n_easy,
                        ft.bf16_geometry, {"the (d, N) layout": wrapper(
                            q, hi_t, cn, tile_n, n_easy, True)})
                else:
                    extra = stage1_bits(
                        ft, variant, lambda qq: wrapper(qq, hi, c_lo, cn,
                                                        tile_n, n_easy),
                        q, got, chains[variant], cn, tile_n, n_easy,
                        ft.bf16x2_geometry)
                ms = cuda_median_ms(launch)
                plain_ms = cuda_median_ms(plain)

                # the whole two-stage regime against the full f32 scan
                def e2s():
                    return ft.flat_topk_exact2_stream(
                        q, corpus, 10, metric, corpus_sqnorm=csq,
                        corpus_bf16=hi, corpus_center=mu,
                        center_sqmax=center_sqmax, corpus_bf16_lo=c_lo,
                        return_ok=True,
                    )

                s2, i2, ok = e2s()
                s_ref, i_ref = ft.flat_topk_ref(q, corpus, 10, metric)
                if not torch.equal(i2, i_ref):
                    raise AssertionError(
                        f"{variant} {metric} Q={n_q}: two-stage ids differ "
                        "from the f32 scan"
                    )
                e2s_ms = cuda_median_ms(e2s, runs=10)
                ref_ms = cuda_median_ms(
                    lambda: ft.flat_topk_ref(q, corpus, 10, metric), runs=10
                )
                parts = 3 if c_lo is not None else 1  # bf16x2: 3 products
                flops = 2.0 * parts * n_q * N_CORPUS * DIM
                row = {
                    "variant": variant, "metric": metric, "Q": n_q,
                    **roofline(_nbytes(q, hi, c_lo, cn, got), flops, "bf16"),
                    # the same FMAs on the CUDA cores, which these kernels use
                    "f32_floor_ms": 1e3 * flops / PEAK_FLOPS["f32"],
                    "contract_margin": violation, "max_abs_err": max_err,
                    "tol": tol, "same_keys": same, "ms": ms,
                    "plain_ms": plain_ms, "proof_ok": float(ok.float().mean()),
                    "two_stage_ms": e2s_ms, "f32_scan_ms": ref_ms, **extra,
                }
                results[variant].append(row)
                log("kernel " + json.dumps(row))
    return results


def stage1_bits(ft, name, call, q, got, chain, cn, tile_n, n_easy,
                geometry, more=None) -> dict:
    """A stage-1 kernel's slots `got` for queries q: equal bit for bit to
    the f32 chain they mirror (`chain`, the (Q, N) scores of
    `bf16_chain_scores` / `bf16x2_chain_scores`), to a second call
    (`call(q)`), to the first query alone, to the first nine as a batch and
    to `more` (what -> slots). Returns the launch's geometry."""
    s = 2.0 * chain - cn[None, :] if cn is not None else chain
    checks = {"the f32 chain": ft._tile_slots(s, tile_n, n_easy),
              "a second call": call(q), **(more or {})}
    for m in (1, 9):
        if m < q.shape[0]:
            checks[f"the first {m} queries alone"] = call(q[:m].contiguous())
    for what, want in checks.items():
        if not torch.equal(got[:want.shape[0]], want):
            raise AssertionError(
                f"{name} Q={q.shape[0]}: keys differ from {what} at "
                f"{int((got[:want.shape[0]] != want).sum())} slots")
    return {"same_as_chain": 1.0, "geometry": geometry(
        q.shape[0], chain.shape[1], q.shape[1], tile_n)._asdict()}


# (d, N, Q, tile_n, n_easy) of the bf16 kernel's edges (#1), each held bit
# for bit to the f32 chain it mirrors in both layouts: odd d (rows staged by
# the threads) at 16 queries a block, n_easy 1 at 32, d = 777 and n_easy 7
# at 64 (two query windows), a tile of one partial part at 8, d = 2,048 at
# 32 (two windows), tiles of one part (128 rows) at 8 with n_easy 7, d =
# 4,001 at 8 (two windows, the last one partial)
BF16_EDGES = ((385, 5_000, 9, 1024, 4), (384, 20_000, 40, 1024, 1),
              (777, 20_000, 64, 1024, 7), (384, 1_000, 3, 1024, 4),
              (2_048, 5_000, 17, 1024, 4), (384, 300, 5, 128, 7),
              (4_001, 3_000, 5, 1024, 4))


def bf16_edge_phase(ft, dev) -> list:
    """The bf16 kernel (#1) at BF16_EDGES, l2 and dot, both layouts: its
    slots equal `bf16_chain_candidates` bit for bit and hold the stage-1
    contract."""
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = []
    for d, n, n_q, tile_n, n_easy in BF16_EDGES:
        corpus = torch.randn(n, d, device=dev, generator=g)
        corpus /= corpus.norm(dim=1, keepdim=True)
        hi = corpus.bfloat16()
        hi_t = hi.t().contiguous()
        csq = torch.sum(hi.float() ** 2, dim=-1)
        q = torch.randn(n_q, d, device=dev, generator=g)
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        with ft.full_f32():
            ref_dot = q @ hi.float().T
        for metric in ("dot", "l2"):
            cn = csq if metric == "l2" else None
            want = ft.bf16_chain_candidates(q, hi, cn, tile_n, n_easy)
            for layout, c, trans in (("(N, d)", hi, False),
                                     ("(d, N)", hi_t, True)):
                got = ft.extract_candidates_bf16_cuda(q, c, cn, tile_n,
                                                      n_easy, trans)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"bf16 d={d} N={n} Q={n_q} tile {tile_n} n_easy "
                        f"{n_easy} {metric} {layout}: keys differ from the "
                        f"f32 chain at {int((got != want).sum())} of "
                        f"{got.numel()} slots")
            err_f = 2.0 if metric == "l2" else 1.0
            ref = 2.0 * ref_dot - csq[None, :] if cn is not None else ref_dot
            eps = err_f * ft._bf16_matmul_eps(d) * q.norm(dim=1) * float(
                torch.sqrt(csq.max()))
            violation = check_contract(got, ref, eps, tile_n, n_easy, ft)
            if violation > 0:
                raise AssertionError(
                    f"bf16 d={d} N={n} Q={n_q} {metric}: stage-1 contract "
                    f"violated by {violation:.3e}")
            rows.append({"d": d, "N": n, "Q": n_q, "tile_n": tile_n,
                         "n_easy": n_easy, "metric": metric,
                         "same_keys": 1.0, "layouts": 2,
                         "contract_margin": violation,
                         "geometry": ft.bf16_geometry(
                             n_q, n, d, tile_n)._asdict()})
    log("bf16edge " + json.dumps(rows))
    return rows


# -- phase 3c: dense search at widths past a block's shared memory ---------

# widths past what a block holds of its queries in the bf16x2 stage 1
# (928 at 16 queries), the running kernels (1,038) and, at 64 queries, the
# bf16 and int8 stage 1 (608, 576): those kernels stage the queries in
# windows there
WIDTH_D = (1_024, 2_048)
WIDTH_Q = 64
WIDTH_PIN_Q = 16  # the batch on an index pinned to bf16x2
WIDTH_CLUSTER = 10  # rows a cluster: a query's top 10 stand clear of the rest
# the dense kernels' wrappers, by the names the width lines print
DENSE_WRAPPERS = ("extract_candidates_bf16_cuda",
                  "extract_candidates_bf16x2_cuda",
                  "extract_candidates_int8_cuda",
                  "extract_candidates_grouped_cuda",
                  "flat_topk_running_exact_cuda", "flat_topk_running_fast_cuda",
                  "flat_topk_running_insert_cuda",
                  "flat_topk_running_group_cuda",
                  "flat_topk_running_maxonly_cuda")
# flat_topk's regimes, by the functions that serve them
DENSE_REGIMES = (("flat_topk_exact2_stream", "two_stage"),
                 ("flat_topk_running", "running"),
                 ("flat_topk_scan", "scan"), ("flat_topk_ref", "ref"))


def _clustered(n, d, gen):
    """n unit rows in clusters of WIDTH_CLUSTER about unit random centres
    (noise 0.15), at random rows: a query near a row has its top 10 far
    above its 33rd, so the commit probe picks the bf16 stage 1 at any
    width. (Kept in cluster order, the 10 rows of a cluster would share
    one 2,048-row tile, of which the int8 tier's stage 1 keeps 7
    candidates: its design, the JAX package's too.)"""
    centres = torch.randn(n // WIDTH_CLUSTER, d, device=gen.device,
                          generator=gen)
    centres /= centres.norm(dim=1, keepdim=True)
    noise = torch.randn(n, d, device=gen.device, generator=gen)
    rows = centres.repeat_interleave(WIDTH_CLUSTER, 0) + 0.15 * noise / (
        noise.norm(dim=1, keepdim=True))
    rows = rows[torch.randperm(n, device=gen.device, generator=gen)]
    return (rows / rows.norm(dim=1, keepdim=True)).contiguous()


def _truth_ids(truth, ids, tol, what) -> int:
    """Hold served ids to an f64 ranking: each position's row within tol
    of the f64 top-k's row at that position. Returns the rows whose lists
    differ (near-ties)."""
    k = ids.shape[1]
    ref = torch.topk(truth, k, dim=1).indices
    ids = ids.long()
    differ = (ids != ref).any(dim=1)
    gap = (truth.gather(1, ids) - truth.gather(1, ref)).abs()
    if bool((gap > tol).any()):
        raise AssertionError(f"width {what}: ids differ from the f64 ranking "
                             f"by {float(gap.max()):.3e} > {float(tol):.3e}")
    return int(differ.sum())


# #3 at the width phase's widths: (d, tile_n, group, depth), windowed
WIDTH_GROUPED = ((1_024, 2_048, 16, 16), (2_048, 1_024, 16, 2))


def _grouped_width_lines(ft, dev, corpus, q, d) -> list:
    """#3 at d (WIDTH_GROUPED) over bf16 rows (l2) and int8 rows with
    scales, in both layouts: each call launches #3, its geometry is its C
    entry's, its keys equal its chain's (`ft.grouped_chain_candidates`) bit
    for bit and are held to the plain grouped candidates within the key
    tolerance of phase 9b's #3 rows (twice the bf16 proof bound plus 2^-10
    of the largest score)."""
    (_, tile_n, group, depth), = [w for w in WIDTH_GROUPED if w[0] == d]
    n_easy = 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows16 = corpus.bfloat16()
    csq = torch.sum(rows16.float() ** 2, dim=-1)
    s8 = (corpus.abs().amax(dim=1) / 127.0).float()
    rows8 = torch.round(corpus / s8[:, None]).clamp(-127, 127).to(torch.int8)
    lines = []
    for kind, rows, cn, scale, norm in (
            ("bf16 l2", rows16, csq, None, float(rows16.float().norm(
                dim=1).max())),
            ("int8", rows8, None, s8, float((rows8.float() * s8[:, None])
                                            .norm(dim=1).max()))):
        want = ft.flat_topk_candidates_plain(q, rows, cn, tile_n, n_easy,
                                             corpus_scale=scale, group=group,
                                             depth=depth)
        chain = ft.grouped_chain_candidates(q, rows, cn, scale, tile_n,
                                            n_easy, group, depth)
        geo = _grouped_geometry_checked(ft, q.shape[0], rows.shape[0], d,
                                        tile_n, group, depth, rows, sms)
        dp = _decode(want, ft)
        eps = (2.0 if cn is not None else 1.0) * ft._bf16_matmul_eps(d) * (
            float(q.norm(dim=1).max()) * norm)
        for layout in ("(N, d)", "(d, N)"):
            trans = layout == "(d, N)"
            src = rows.t().contiguous() if trans else rows
            ft.extract_candidates_grouped_cuda.launches = 0
            got = ft.extract_candidates_grouped_cuda(
                q, src, cn, scale, tile_n, n_easy, group, depth, trans)
            torch.cuda.synchronize()
            launches = ft.extract_candidates_grouped_cuda.launches
            del src
            live = (got != ft._INT_MIN) | (want != ft._INT_MIN)
            max_err = float((_decode(got, ft) - dp).abs()[live].max())
            tol = float(2 * eps + 2.0 ** -10 * dp[live].abs().max())
            same = float((got == want).float().mean())
            if launches != 1 or not max_err <= tol or not torch.equal(
                    got, chain):
                raise AssertionError(
                    f"#3 d={d} {kind} {layout}: {launches} launches, kernel "
                    f"vs plain {max_err:.3e} > {tol:.3e}, or keys differ "
                    f"from its chain's ({float((got != chain).float().mean())}"
                    " differ)")
            line = {"d": d, "tier": "grouped", "kind": kind,
                    "layout": layout, "Q": int(q.shape[0]), "tile_n": tile_n,
                    "group": group, "depth": depth,
                    "launches": {"extract_candidates_grouped_cuda":
                                 launches},
                    "max_abs_err": max_err, "tol": tol, "same_keys": same,
                    "chain_equal": True, "geometry": geo._asdict()}
            lines.append(line)
            log("width " + json.dumps(line))
    return lines


def _grouped_geometry_checked(ft, n_q, n, d, tile_n, group, depth, rows,
                              sms):
    """#3's launch (`ft.grouped_geometry`) for rows of rows' type, held to
    its C entry's report of the same block (`prt_grouped_geometry`)."""
    import ctypes

    from persian_rag_tpu_torch.ops import _build

    geo = ft.grouped_geometry(n_q, n, d, tile_n, group, depth,
                              rows.element_size(), sms)
    c_geo = (ctypes.c_int * 2)()
    err = _build.load().prt_grouped_geometry(
        d, tile_n, group, depth, int(rows.dtype == torch.int8), geo.queries,
        c_geo)
    if err != 0 or (geo.window, geo.smem) != tuple(c_geo):
        raise AssertionError(f"#3 d={d}: grouped_geometry {geo} differs from "
                             f"its C entry's {list(c_geo)} ({err})")
    return geo


# #3 past the query window: d, rows, tile_n, group, depth
WIDE_GROUPED = (4_000, 20_000, 1_024, 16, 2)


def wide_grouped_lines(ft, dev) -> list:
    """#3 at d = 4,000 (WIDE_GROUPED) over seeded unit rows, bf16 (l2) and
    int8 with scales, both layouts: its queries staged in windows, keys
    bit-equal to its chain's (`ft.grouped_chain_candidates`) and within the
    key tolerance of plain."""
    d, n, tile_n, group, depth = WIDE_GROUPED
    g = torch.Generator(device=dev).manual_seed(SEED + d)
    corpus = torch.randn(n, d, device=dev, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    q = _queries_near(corpus, WIDTH_Q, g)
    rows16 = corpus.bfloat16()
    csq = torch.sum(rows16.float() ** 2, dim=-1)
    s8 = (corpus.abs().amax(dim=1) / 127.0).float()
    rows8 = torch.round(corpus / s8[:, None]).clamp(-127, 127).to(torch.int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines = []
    for kind, rows, cn, scale in (("bf16 l2", rows16, csq, None),
                                  ("int8", rows8, None, s8)):
        geo = _grouped_geometry_checked(ft, WIDTH_Q, n, d, tile_n, group,
                                        depth, rows, sms)
        if geo.windows < 2:
            raise AssertionError(f"#3 d={d} {kind}: {geo} is not windowed")
        chain = ft.grouped_chain_candidates(q, rows, cn, scale, tile_n, 4,
                                            group, depth)
        want = ft.flat_topk_candidates_plain(q, rows, cn, tile_n, 4,
                                             corpus_scale=scale, group=group,
                                             depth=depth)
        dp = _decode(want, ft)
        live = (chain != ft._INT_MIN) | (want != ft._INT_MIN)
        err = float((_decode(chain, ft) - dp).abs()[live].max())
        tol = float(2.0 ** -10 * dp[live].abs().max())
        for trans in (False, True):
            src = rows.t().contiguous() if trans else rows
            ft.extract_candidates_grouped_cuda.launches = 0
            got = ft.extract_candidates_grouped_cuda(
                q, src, cn, scale, tile_n, 4, group, depth, trans)
            torch.cuda.synchronize()
            launches = ft.extract_candidates_grouped_cuda.launches
            del src
            if launches != 1 or not torch.equal(got, chain) or not err <= tol:
                raise AssertionError(
                    f"#3 d={d} {kind} trans={trans}: {launches} launches, "
                    f"keys vs its chain's equal {torch.equal(got, chain)}, "
                    f"chain vs plain {err:.3e} > {tol:.3e}")
            line = {"d": d, "tier": "grouped", "kind": kind,
                    "layout": "(d, N)" if trans else "(N, d)", "N": n,
                    "Q": WIDTH_Q, "tile_n": tile_n, "group": group,
                    "depth": depth, "launches": {
                        "extract_candidates_grouped_cuda": launches},
                    "chain_equal": True, "chain_vs_plain": err, "tol": tol,
                    "geometry": geo._asdict()}
            lines.append(line)
            log("width " + json.dumps(line))
    return lines


def width_phase(ft, dev, DenseIndex) -> dict:
    """DenseIndex on the card at d in WIDTH_D over N_CORPUS seeded unit rows
    in clusters (`_clustered`): f32 storage (its commit probe as served:
    the bf16 stage 1), bf16 storage (l2), raw int8 and int8 + f32 refine
    (ip), WIDTH_Q queries near rows, top_k 10; an f32 index pinned to
    bf16x2 at WIDTH_PIN_Q queries, and f32 at search_mode "fasti" and
    "fastg" (the running segment kernels, their lists equal to mode
    fast's, #6, bit for bit); then maxonly over the f32 rows, #3 over them
    in bf16 and int8 (`_grouped_width_lines`), and #3 at d = 4,000
    (`wide_grouped_lines`).
    Each call prints the regime that served it and the kernels it launched,
    and must launch a dense kernel. Its ids are held to an f64 ranking over
    the tier's own operands (f32: the rows; bf16: the stored rows; raw int8:
    bf16-rounded queries times the int8 rows and their scales; int8 +
    refine: the f32 rows): where a position differs, the two rows within
    f32 rounding (2^-11 relative for fasti / fastg, which rank by 21-bit
    keys), at most 1% of the exact modes' lists differing. No call may
    raise."""
    taken = []
    originals = {}
    for attr, regime in DENSE_REGIMES:
        originals[attr] = getattr(ft, attr)

        def rec(*a, _orig=originals[attr], _regime=regime, **kw):
            taken.append(_regime)
            return _orig(*a, **kw)

        setattr(ft, attr, rec)
    lines, n_rows, n_differ = [], 0, 0
    try:
        for d in WIDTH_D:
            g = torch.Generator(device=dev).manual_seed(SEED + d)
            corpus = _clustered(N_CORPUS, d, g)
            host = corpus.cpu().numpy()
            q = _queries_near(corpus, WIDTH_Q, g)
            c64 = corpus.double()
            cases = [("f32", "l2", {}, None, WIDTH_Q),
                     ("f32", "l2", {}, "bf16x2", WIDTH_PIN_Q),
                     ("f32", "l2", {"search_mode": "fasti"}, None, WIDTH_Q),
                     ("f32", "l2", {"search_mode": "fastg"}, None, WIDTH_Q),
                     ("bf16", "l2", {"storage_dtype": torch.bfloat16}, None,
                      WIDTH_Q),
                     ("int8", "ip", {"storage_dtype": torch.int8,
                                     "refine_dtype": None}, None, WIDTH_Q),
                     ("int8_refine", "ip", {"storage_dtype": torch.int8},
                      None, WIDTH_Q)]
            for tier, metric, kw, pin, n_q in cases:
                t0 = time.perf_counter()
                index = DenseIndex(d, metric=metric, device=dev,
                                   quality_floor=None, **kw)
                index.add(host)
                index.commit()
                commit_s = time.perf_counter() - t0
                if pin is not None:
                    index._set_stage1_mode(pin)
                qq = q[:n_q]
                for name in DENSE_WRAPPERS:
                    getattr(ft, name).launches = 0
                taken.clear()
                scores, ids = index.search_device(qq, 10)
                torch.cuda.synchronize()
                launches = {name: getattr(ft, name).launches
                            for name in DENSE_WRAPPERS
                            if getattr(ft, name).launches}
                if not launches:
                    raise AssertionError(f"width d={d} {tier} {kw}: no dense "
                                         f"kernel launched ({taken})")
                args = index.fused_args()
                q64 = qq.double()
                if tier == "int8":
                    # the kernels' score: bf16(q) . c8 times the row scale
                    rows64 = args.corpus.double() * args.corpus_scale.double(
                        )[:, None]
                    truth = qq.bfloat16().double() @ rows64.T
                    tol = _f32_sum_tol(qq.bfloat16().float(), float(
                        rows64.norm(dim=1).max()), d)
                elif tier == "int8_refine":
                    truth = q64 @ c64.T
                    tol = _f32_sum_tol(qq, 1.0, d)
                else:
                    rows64 = args.corpus.double()
                    truth = 2 * q64 @ rows64.T - (rows64 ** 2).sum(1)[None, :]
                    tol = 2 * _f32_sum_tol(qq, float(rows64.norm(dim=1).max()),
                                           d) + (d + 2) * 2.0 ** -24
                    if "search_mode" in kw:  # 21-bit keys
                        tol = tol + 2.0 ** -11 * float(truth.abs().max())
                rows = _truth_ids(truth, ids, tol, f"d={d} {tier} {kw}")
                if "search_mode" in kw:  # #7 / #8: #6's lists, bit for bit
                    fs, fi = ft.flat_topk_running(
                        qq, args.corpus, 10, metric="l2",
                        corpus_sqnorm=args.corpus_sqnorm,
                        compute_dtype=index.compute_dtype, mode="fast")
                    if not (torch.equal(scores, fs) and torch.equal(ids, fi)):
                        raise AssertionError(f"width d={d} {kw}: lists differ "
                                             "from #6's")
                if not bool(torch.isfinite(scores).all()):
                    raise AssertionError(f"width d={d} {tier}: a score is "
                                         "not finite")
                del truth
                if "search_mode" not in kw:  # the fast modes' ties: keys
                    n_rows += n_q
                    n_differ += rows
                line = {"d": d, "tier": tier, "Q": n_q, "pinned": pin,
                        "search_mode": kw.get("search_mode", "exact"),
                        "stage1_mode": index._stage1_mode,
                        "regimes": list(taken), "launches": launches,
                        "rows_differing": rows, "tol": float(tol),
                        "commit_s": commit_s}
                lines.append(line)
                log("width " + json.dumps(line))
                del index, args
            # maxonly over the f32 rows: each query's best score
            ft.flat_topk_running_maxonly_cuda.launches = 0
            best, _ = ft.flat_topk_running(q, corpus, 1, metric="dot",
                                           mode="maxonly")
            torch.cuda.synchronize()
            true_best = (q.double() @ c64.T).max(dim=1).values
            err = float((best[:, 0].double() - true_best).abs().max())
            tol = _f32_sum_tol(q, 1.0, d)
            if err > tol or ft.flat_topk_running_maxonly_cuda.launches != 1:
                raise AssertionError(f"width d={d} maxonly: err {err:.3e} > "
                                     f"{tol:.3e} or no launch")
            line = {"d": d, "tier": "f32", "Q": WIDTH_Q, "mode": "maxonly",
                    "max_abs_err": err, "tol": tol, "geometry":
                        ft.maxonly_geometry(WIDTH_Q, N_CORPUS, d, 4, torch.cuda
                                            .get_device_properties(dev)
                                            .multi_processor_count)._asdict()}
            lines.append(line)
            log("width " + json.dumps(line))
            lines += _grouped_width_lines(ft, dev, corpus, q, d)
            del corpus, host, c64
            torch.cuda.empty_cache()
        lines += wide_grouped_lines(ft, dev)
    finally:
        for attr, orig in originals.items():
            setattr(ft, attr, orig)
    if n_differ > 0.01 * n_rows:
        raise AssertionError(f"width: {n_differ} of {n_rows} id lists differ "
                             "from the f64 ranking")
    served = {name: sum(l.get("launches", {}).get(name, 0) for l in lines)
              for name in DENSE_WRAPPERS}
    served["flat_topk_running_maxonly_cuda"] = len(WIDTH_D)
    missing = [name for name, n in served.items()
               if n == 0 and name != "flat_topk_running_fast_cuda"]
    if missing:
        raise AssertionError(f"no wide call reached {missing}")
    f32 = [l for l in lines if l["tier"] == "f32" and l.get("pinned") is None
           and l.get("search_mode") == "exact"]
    if any(l["stage1_mode"] != "bf16" for l in f32):
        raise AssertionError("the commit probe did not pick the bf16 stage 1 "
                             "on the clustered rows")
    return {"lines": lines, "rows": n_rows, "rows_differing": n_differ,
            "launches": served}


# -- phase 4: the served main path ------------------------------------------


def make_chunks(n: int, rng: np.random.Generator) -> list:
    words = np.asarray(WORDS)
    lengths = rng.integers(16, 49, size=n)
    picks = rng.integers(0, len(words), size=int(lengths.sum()))
    chunks, at = [], 0
    for i, length in enumerate(lengths):
        body = " ".join(words[picks[at : at + length]])
        at += length
        chunks.append({
            "id": f"chunk_{i}",
            "text": f"بخش {i} {body}",
            "chunk_type": "seeded",
        })
    return chunks


def make_queries(sizes, rng: np.random.Generator) -> list:
    words = np.asarray(WORDS)
    out, serial = [], 0
    for size in sizes:
        batch = []
        for _ in range(size):
            n_words = int(rng.integers(3, 11))
            body = " ".join(words[rng.integers(0, len(words), n_words)])
            batch.append(f"پرسش {serial} {body}")
            serial += 1
        out.append(batch)
    return out


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def near_tie_rows(queries, corpus, ids, ref_ids) -> tuple:
    """Hold served l2 ids to the f32 scan's ids for the same queries.

    The served refine and the scan are two f32 evaluations of
    ||q||^2 - (2 q.c - ||c||^2) in different summation orders; each errs
    by at most (d+3) 2^-24 (||q|| + max ||c||)^2. So where the id lists
    differ, each position's two rows must lie within twice that of each
    other in f64 distance, and must be distinct vectors (equal vectors tie
    exactly in f32 and go to the lower id in both). Returns (rows of
    queries whose lists differ, the largest f64 gap among them, the
    smallest tolerance among them)."""
    rows = (ids != ref_ids).any(dim=1).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0.0, float("inf")
    got, ref = ids[rows], ref_ids[rows]
    q = queries[rows].double()
    dist = lambda i: ((corpus[i].double() - q[:, None, :]) ** 2).sum(-1)
    gap = (dist(got) - dist(ref)).abs()
    cmax = corpus.norm(dim=1).max().double()
    tol = 2 * (corpus.shape[1] + 3) * 2.0 ** -24 * (q.norm(dim=1) + cmax) ** 2
    if bool((gap > tol[:, None]).any()):
        raise AssertionError(
            f"served ids differ from the f32 scan by more than f32 "
            f"rounding: gap {float(gap.max()):.3e}, tol {float(tol.min()):.3e}"
        )
    if bool(((corpus[got] == corpus[ref]).all(-1) & (got != ref)).any()):
        raise AssertionError("served ids break the lower-id tie order")
    return int(rows.numel()), float(gap.max()), float(tol.min())


def _nearest_rows(queries, seen) -> list:
    """The recorded search row of each query embedding: the nearest
    recorded embedding, by exact differences in f64. (cdist's matmul form,
    |a|^2 + |b|^2 - 2 a.b, cancels to f32 noise on embeddings in a tight
    cone, where two different queries can stand closer than that noise.)"""
    return torch.cdist(queries.double(), seen.double(),
                       compute_mode="donot_use_mm_for_euclid_dist").argmin(
                           dim=1).tolist()


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _client(url: str, jobs) -> list:
    """One closed-loop HTTP client (run in a pool process, so that its
    JSON work does not share the server's interpreter): POST each
    (queries, top_k) to /search in turn. Returns [(response, seconds)]."""
    out = []
    for queries, top_k in jobs:
        t = time.perf_counter()
        resp = _post(url + "/search", {"queries": queries, "top_k": top_k})
        out.append((resp, time.perf_counter() - t))
    return out


def serve_phase(enc, chunks, rng, ft, RetrievalSystem, RetrievalServer,
                pool, embeddings=None, stage1=None, model_path=None,
                n_seq=SEQ_REQUESTS, per_client=PER_CLIENT):
    """Index the chunks, serve /health, /search and /rag, and check every
    served id list against an exact f32 scan of the same embeddings.

    The /search load: a warm-up request of each size, then n_seq back to
    back from one client, then CLIENTS closed-loop clients sending
    per_client requests each; every client is a process of `pool`. Sizes
    are drawn from REQUEST_SIZES, top_k from (5, 10). With `model_path`
    the system loads its encoder from that sentence-transformers directory
    (`enc` is then ignored). Returns (summary, the RetrievalSystem)."""
    t0 = time.perf_counter()
    if model_path is not None:
        rs = RetrievalSystem(method="dense", model_path=model_path,
                             dense_metric="l2")
        enc = rs.embedding_model
    else:
        rs = RetrievalSystem(method="dense", encoder=enc, dense_metric="l2")
    load_s = time.perf_counter() - t0
    if not rs.load_chunks_and_index(chunks, embeddings=embeddings):
        raise AssertionError("load_chunks_and_index failed")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = rs.dense_index
    probed = index._stage1_mode
    if stage1 is not None:
        index._set_stage1_mode(stage1)
    mode = index._stage1_mode

    # record what the search actually saw, to check ids against a scan of
    # the very same query embeddings
    seen, searches = [], [0]
    search_device = index.search_device

    def recording_search(queries, k):
        searches[0] += 1
        scores, ids = search_device(queries, k)
        seen.append((queries.detach().clone(), ids.detach().clone(), k))
        return scores, ids

    index.search_device = recording_search
    # and the proof verdict of every two-stage dispatch, with the dispatch
    # at which a fail streak demoted the index to the f32 scan
    verdicts, demoted_at = [], []
    note_verdict = index._note_proof_verdict

    def recording_note(ok):
        before = index._stage1_mode
        if ok is not None:
            verdicts.append(ok.clone())
        note_verdict(ok)
        if before != "scan" and index._stage1_mode == "scan":
            demoted_at.append(searches[0])

    index._note_proof_verdict = recording_note
    rs.retrieve_batch(["گرم کردن", "پرسش آغازین دارو"], 10)  # warm-up

    n_conc = CLIENTS * per_client
    sizes = [int(v) for v in rng.choice(
        REQUEST_SIZES, size=n_seq + n_conc)]
    top_ks = [int(v) for v in rng.choice((5, 10), size=len(sizes))]
    batches = make_queries(sizes, rng)
    warmups = make_queries(REQUEST_SIZES, rng)
    jobs = list(zip(batches, top_ks))
    ft.extract_candidates_bf16_cuda.launches = 0
    ft.extract_candidates_bf16x2_cuda.launches = 0
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        health = json.loads(
            urllib.request.urlopen(server.url + "/health", timeout=60).read()
        )
        if health.get("status") != "ok":
            raise AssertionError(f"/health answered {health}")
        for batch in warmups:
            _post(server.url + "/search", {"queries": batch, "top_k": 10})
        seen.clear()
        verdicts.clear()
        responses, latencies, conc_s, (dispatches_seq, dispatches_conc) = \
            _drive(server, jobs, pool, n_seq)
        rag = _post(server.url + "/rag", {"question": batches[0][0], "top_k": 5})
    launches = {
        "bf16": ft.extract_candidates_bf16_cuda.launches,
        "bf16x2": ft.extract_candidates_bf16x2_cuda.launches,
    }
    served_ok = torch.cat(verdicts) if verdicts else torch.zeros(0)

    if not rag.get("contexts") or rag.get("answer") is not None:
        raise AssertionError(f"/rag answered {rag}")
    # ids the exact f32 scan gives for every embedding the search saw
    row_of = {c["id"]: i for i, c in enumerate(chunks)}
    corpus = index._device_corpus
    near_ties, near_tie_gap, near_tie_tol = 0, 0.0, float("inf")
    for queries, ids, k in seen:
        _, i_ref = ft.flat_topk_ref(queries, corpus, k, metric="l2")
        rows, gap, tol = near_tie_rows(queries, corpus, ids, i_ref)
        near_ties += rows
        near_tie_gap = max(near_tie_gap, gap)
        near_tie_tol = min(near_tie_tol, tol)
    n_searched = sum(q.shape[0] for q, _, _ in seen)
    if near_ties > 0.01 * n_searched:
        raise AssertionError(
            f"{near_ties} of {n_searched} served id lists differ from the "
            "f32 scan: too many for rounding-level near-ties"
        )
    # match each served query to the embedding the search saw for it
    # (nearest recorded row to its standalone embedding)
    seen_emb = torch.cat([q for q, _, _ in seen])
    seen_ids = [list(r) for _, i, _ in seen for r in i.cpu().numpy()]
    if seen_emb.shape[0] != sum(sizes) + 1:  # + /rag
        raise AssertionError("searched rows != served queries")
    n_checked = 0
    for batch, k, resp in zip(batches, top_ks, responses):
        if resp is None or len(resp["results"]) != len(batch):
            raise AssertionError(f"bad /search response {resp}")
        alone = enc.encode_device(batch)
        nearest = _nearest_rows(alone, seen_emb)
        for text, hits, j in zip(batch, resp["results"], nearest):
            got = [row_of[h["id"]] for h in hits]
            if len(got) != k or not all(np.isfinite(h["score"]) for h in hits):
                raise AssertionError(f"bad hits {hits}")
            if got != seen_ids[j][:k]:
                raise AssertionError(
                    f"served ids differ from the f32 scan: {text!r} served "
                    f"{got}, searched {seen_ids[j][:k]}")
            n_checked += 1
    n_conc_queries = sum(sizes[n_seq:])
    breakdown = _breakdown(rs, rng)
    index.search_device = search_device
    index._note_proof_verdict = note_verdict
    out = {
        "stage1_probed": probed,
        "stage1_mode": mode,
        # after the served requests and the breakdown's searches: a run
        # of majority-failed proofs demotes the index to "scan"
        "stage1_mode_after": index._stage1_mode,
        # the search that demoted it, counting from 1 at the first
        # warm-up: then the served dispatches, then the breakdown's
        "demoted_at_search": demoted_at[0] if demoted_at else None,
        "searches": searches[0],
        "served_proof_ok": float(served_ok.float().mean()),
        "encoder_load_s": load_s if model_path is not None else None,
        "index_build_s": build_s,
        **_load_stats(latencies, sizes, n_seq, conc_s),
        "seq_dispatches": dispatches_seq,
        "conc_clients": CLIENTS,
        "conc_requests_per_s": n_conc / conc_s,
        "conc_dispatches": dispatches_conc,
        "conc_queries_per_dispatch": n_conc_queries / max(dispatches_conc, 1),
        "queries_checked": n_checked,
        "near_tie_rows": near_ties,
        "near_tie_max_gap": near_tie_gap,
        "near_tie_min_tol": near_tie_tol if near_ties else None,
        "launches": launches,
        "embeddings": "given" if embeddings is not None else "encoded",
        "fail_streak": index._fail_streak,
        "breakdown_ms": breakdown,
    }
    log("serve " + json.dumps(out))
    return out, rs


def _breakdown(rs, rng) -> dict:
    """Host-clock medians over 15 batches (ms, each stage ending in a
    synchronise) of one in-process retrieve_batch, split into its stages,
    at batch 1 and 16."""
    enc, index = rs.embedding_model, rs.dense_index
    out = {}
    for size in (1, 16):
        stages = {"tokenize": [], "encode": [], "search": [], "total": []}
        for texts in make_queries([size] * 15, rng):
            t0 = time.perf_counter()
            ids, mask = enc.tokenizer.encode_batch(texts, enc.max_seq_len)
            t1 = time.perf_counter()
            emb = enc.forward_tokens(ids, mask)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            scores, found = index.search_device(emb, 10)
            scores.cpu(), found.cpu()
            t3 = time.perf_counter()
            rs.retrieve_batch(texts, 10)
            t4 = time.perf_counter()
            for name, dt in (("tokenize", t1 - t0), ("encode", t2 - t1),
                             ("search", t3 - t2), ("total", t4 - t3)):
                stages[name].append(1e3 * dt)
        out[f"batch{size}"] = {
            k: statistics.median(v) for k, v in stages.items()
        }
    return out


# -- phases 5-8: lexical and hybrid retrieval -------------------------------

LEX_SYNTH = 50_000  # synthetic Persian-letter word forms beside WORDS
LEX_ZIPF = 1.1
LEX_CHUNK_WORDS = 150  # config.yaml word_chunk_size
LEX_TAIL_SHARE = 0.15  # document-end tails of 10-149 words
LEX_BATCHES = (1, 16, 64, 512)  # kernel-vs-plain query batches
LEX_EDGE_B = 13  # #11's edge request: not a multiple of its query block
UNION_BATCHES = (128, 512)  # in-process batches past the union gate
# TF-IDF's in-process corpus: a twentieth of C. Its Python builder (uni- and
# bigrams) is the longest step of the lexical phase over all 100,000; cut,
# with FILES_CHUNKS and the /search load, so that the script keeps within
# its time with the phases added after it (20,000 until the evaluate
# phase, which builds TF-IDF over P3's chunks too)
TFIDF_CHUNKS = 5_000
# D's corpus: C's first chunks, encoded once by the full-width encoder (all
# 100,000 until the train phase needed the time, 50,000 until the parallel
# phase did; still past TWO_STAGE_MIN_N = 32,768, so its dense channel
# launches a stage-1 kernel)
HYBRID_CHUNKS = 33_000
# top_k past one corpus tile of the sparse kernels (128 documents): a BM25
# request, and a hybrid one that over-retrieves 2 x 100 from each channel
LEX_BIG_TOP_K = 200
HYBRID_BIG_TOP_K = 100
BIG_QUERIES = 4
LETTERS = "ابپتثجچحخدذرزژسشصضطظعغفقکگلمنوهی"
# BM25 ties often: 85% of chunks share one length, so two chunks that
# match the same multiset of (term, count) score the same in f64 and, when
# the terms fill other query slots, one f32 rounding apart. A sanity cap
# on such near-tie rows; each one is still held to the f32 bound.
NEAR_TIE_SHARE = 0.10


def lexical_vocab(rng: np.random.Generator) -> np.ndarray:
    """WORDS plus LEX_SYNTH distinct seeded 3-8 letter forms, in a seeded
    Zipf rank order."""
    forms, seen = [], set(WORDS)
    while len(forms) < LEX_SYNTH:
        lens = rng.integers(3, 9, LEX_SYNTH)
        picks = rng.integers(0, len(LETTERS), (LEX_SYNTH, 8))
        for length, row in zip(lens, picks):
            w = "".join(LETTERS[i] for i in row[:length])
            if w not in seen:
                seen.add(w)
                forms.append(w)
    vocab = np.asarray(list(WORDS) + forms[:LEX_SYNTH])
    return vocab[rng.permutation(len(vocab))]


def _zipf_words(vocab, n, rng):
    p = np.arange(1, len(vocab) + 1, dtype=np.float64) ** -LEX_ZIPF
    return vocab[rng.choice(len(vocab), size=n, p=p / p.sum())]


def lexical_chunks(n: int, vocab, rng) -> list:
    """n chunks: 85% of LEX_CHUNK_WORDS words, 15% tails of 10-149, words
    drawn Zipf over `vocab`."""
    lengths = np.where(rng.random(n) < 1 - LEX_TAIL_SHARE, LEX_CHUNK_WORDS,
                       rng.integers(10, LEX_CHUNK_WORDS, n))
    words = _zipf_words(vocab, int(lengths.sum()), rng)
    chunks, at = [], 0
    for i, length in enumerate(lengths):
        chunks.append({"id": f"chunk_{i}",
                       "text": " ".join(words[at:at + length]),
                       "chunk_type": "word_based"})
        at += length
    return chunks


def lexical_queries(sizes, vocab, rng) -> list:
    """Batches of queries of 3-10 Zipf words."""
    return [[" ".join(_zipf_words(vocab, int(rng.integers(3, 11)), rng))
             for _ in range(size)] for size in sizes]


def f64_matrix(index):
    """The index's own ELL as a float64 scipy CSR (N, V)."""
    import scipy.sparse as sp

    parts = ([(index.doc_ids, index.doc_vals, np.arange(index.ntotal))]
             if index._buckets is None
             else [(b.ids, b.vals, b.gids) for b in index._buckets])
    rows, cols, vals = [], [], []
    for ids, vs, gids in parts:
        live = ids >= 0
        rows.append(np.broadcast_to(np.asarray(gids)[:, None], ids.shape)[live])
        cols.append(ids[live])
        vals.append(vs[live].astype(np.float64))
    x = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(index.ntotal, max(len(index.vocab), 1)))
    return x, float(np.abs(x.data).max(initial=0.0))


def check_lexical(index, x, vmax, terms_list, ids, scores) -> dict:
    """Hold top-k id lists of the queries `terms_list` to an f64 scorer
    of the same ELL. A served score may differ from the f64 score by the
    f32 bound of its sum, tol = 2 (T+1) 2^-24 sum_t |w_t| max |v|; where
    a served id differs from the f64 order (score descending, lower id
    first), the two rows' f64 scores must lie within 2 tol (a near-tie).
    Returns counts (`f64_tie_rows`: near-tie rows whose differing rows
    score exactly equal in f64, their f32 order set by summation order);
    raises on any other difference."""
    import scipy.sparse as sp

    n_rows = near = f64_ties = 0
    worst_err = worst_gap = 0.0
    for start in range(0, len(terms_list), 256):
        batch = terms_list[start:start + 256]
        r, c, v = [], [], []
        for qi, terms in enumerate(batch):
            for tid, w in terms:
                r.append(tid)
                c.append(qi)
                v.append(float(np.float32(w)))
        q = sp.csr_matrix((v, (r, c)), shape=(x.shape[1], len(batch)))
        s64 = (x @ q).toarray()
        for qi, terms in enumerate(batch):
            got = np.asarray(ids[start + qi])
            k = len(got)
            col = s64[:, qi]
            kth = np.partition(col, len(col) - k)[len(col) - k]
            cand = np.nonzero(col >= kth)[0]
            ref = cand[np.lexsort((cand, -col[cand]))][:k]
            tol = 2 * (len(terms) + 1) * 2.0 ** -24 * vmax * sum(
                abs(w) for _, w in terms)
            err = np.abs(np.asarray(scores[start + qi], np.float64) - col[got])
            worst_err = max(worst_err, float(err.max(initial=0.0)))
            if bool((err > tol + 1e-30).any()):
                raise AssertionError(
                    f"lexical score off by {float(err.max()):.3e} > {tol:.3e}")
            # equal served scores must keep the lower id first
            served = np.asarray(scores[start + qi], np.float32)
            if bool(((served[1:] == served[:-1]) & (got[1:] < got[:-1])).any()):
                raise AssertionError(
                    f"lexical ids break the lower-id tie order: ids "
                    f"{got.tolist()}, scores {served.tolist()}")
            if not np.array_equal(got, ref):
                gap = np.abs(col[got] - col[ref])
                worst_gap = max(worst_gap, float(gap.max()))
                if bool((gap > 2 * tol + 1e-30).any()):
                    raise AssertionError(
                        f"lexical ids differ from the f64 order by "
                        f"{float(gap.max()):.3e} > 2 x {tol:.3e}")
                near += 1
                f64_ties += int(not gap.any())
            n_rows += 1
    return {"rows": n_rows, "near_tie_rows": near, "f64_tie_rows": f64_ties,
            "max_score_err": worst_err, "near_tie_max_gap": worst_gap}


def lexical_kernel_phase(index, vocab, rng) -> dict:
    """Each sparse kernel against its plain version on the card, at the
    BM25 index's own bucket shapes (#10, #12: the largest flat bucket;
    #11, #13: the largest hashed one), B in LEX_BATCHES, k = 10."""
    from persian_rag_tpu_torch.ops import sparse_scores as ss

    flat = [b for b in index._buckets if b.dev_ids.dim() == 2]
    hashed = [b for b in index._buckets if b.dev_ids.dim() == 3]
    if not flat or not hashed:
        raise AssertionError("the lexical corpus lacks a flat or hashed bucket")
    big_flat = max(flat, key=lambda b: b.n_actual)
    big_hashed = max(hashed, key=lambda b: b.n_actual)
    docs = {
        "sparse_topk": (big_flat.dev_ids, big_flat.dev_vals),
        "sparse_topk_union": (big_flat.dev_ids, big_flat.dev_vals),
        "sparse_topk_hashed": (big_hashed.dev_ids, big_hashed.dev_vals),
        "sparse_topk_union_hashed": (big_hashed.dev_ids, big_hashed.dev_vals),
    }
    vmax = max(float(b.vals.max()) for b in index._buckets)
    out = {name: [] for name in ss.KERNELS}
    # per bucket: a CSR copy (docs x vocabulary) for the library yardstick,
    # one sparse product (scores only, no top-k), and the bucket's document
    # frequencies, to count the multiply-adds a batch needs
    n_vocab = max(len(index.vocab), 1)
    csr, doc_freq = {}, {}
    for b_ in (big_flat, big_hashed):
        ids2 = b_.dev_ids.reshape(b_.dev_ids.shape[0], -1)
        vals2 = b_.dev_vals.reshape(ids2.shape)
        live = ids2 >= 0
        rows_ = torch.arange(ids2.shape[0], device=ids2.device)[:, None]
        csr[id(b_)] = torch.sparse_coo_tensor(
            torch.stack([rows_.expand_as(ids2)[live], ids2[live].long()]),
            vals2[live], (ids2.shape[0], n_vocab)).coalesce().to_sparse_csr()
        doc_freq[id(b_)] = torch.bincount(ids2[live].long(), minlength=n_vocab)
    bucket_of = {"sparse_topk": big_flat, "sparse_topk_union": big_flat,
                 "sparse_topk_hashed": big_hashed,
                 "sparse_topk_union_hashed": big_hashed}
    for b in LEX_BATCHES:
        texts = lexical_queries([b], vocab, rng)[0]
        terms = [index._query_terms(q) for q in texts]
        qids_np, qvals_np = index._encode_queries(terms)
        qids = torch.from_numpy(qids_np).cuda()
        qvals = torch.from_numpy(qvals_np).cuda()
        t = qids.shape[1]
        tol = 2 * (t + 1) * 2.0 ** -24 * vmax * float(
            np.abs(qvals_np).sum(axis=1).max())
        for name, kernel in ss.KERNELS.items():
            d_ids, d_vals = docs[name]
            plain = ss.PLAIN[name]

            def launch():
                return kernel(d_ids, d_vals, qids, qvals, 10)

            def run_plain():
                return plain(d_ids, d_vals, qids, qvals, 10)

            s_k, i_k = launch()
            torch.cuda.synchronize()
            s_p, i_p = run_plain()
            err = float((s_k - s_p).abs().max())
            same = float((i_k == i_p).float().mean())
            exact = name in ("sparse_topk", "sparse_topk_hashed")
            if exact and (err != 0.0 or same != 1.0):
                raise AssertionError(
                    f"{name} B={b}: kernel differs from plain (err {err}, "
                    f"same ids {same})")
            if not exact:
                if err > tol:
                    raise AssertionError(
                        f"{name} B={b}: |kernel - plain| {err:.3e} > {tol:.3e}")
                # ids may differ only where plain's neighbours (the 11th
                # included, from a top-11) are near-tied
                s11 = plain(d_ids, d_vals, qids, qvals, 11)[0].cpu().numpy()
                d = np.abs(np.diff(s11, axis=1))
                gap = np.minimum(np.concatenate([d[:, :1] * 0 + np.inf, d],
                                                axis=1)[:, :10], d[:, :10])
                bad = (i_k != i_p).cpu().numpy() & (gap > 2 * tol)
                if bool(bad.any()):
                    raise AssertionError(f"{name} B={b}: ids differ off ties")
            runs = 15 if b <= 64 else 7
            bucket = bucket_of[name]
            # the multiply-adds this batch needs: one per (query term, doc
            # holding it); the ELL, the queries and the results move once
            live_q = qids >= 0
            matches = float(doc_freq[id(bucket)][qids[live_q].long()].sum())
            q_dense = torch.zeros((n_vocab, b), device=qids.device)
            q_dense.index_put_(
                (qids[live_q].long(),
                 torch.arange(b, device=qids.device)[:, None].expand_as(
                     qids)[live_q]), qvals[live_q], accumulate=True)
            x_csr = csr[id(bucket)]
            row = {"kernel": name, "B": b, "T": t,
                   "N": int(d_ids.shape[0]), "shape": list(d_ids.shape),
                   "max_abs_err": err, "tol": 0.0 if exact else tol,
                   "same_ids": same, "ms": cuda_median_ms(launch, runs=runs),
                   "host_ms": host_median_ms(launch, runs=runs),
                   "plain_ms": cuda_median_ms(run_plain, runs=runs),
                   **roofline(_nbytes(d_ids, d_vals, qids, qvals, s_k, i_k),
                              2.0 * matches, "f32"),
                   "library_ms": cuda_median_ms(
                       lambda: torch.sparse.mm(x_csr, q_dense), runs=runs)}
            if name == "sparse_topk_hashed":
                row["geometry"] = ss.sparse_topk_hashed_geometry(b, t)._asdict()
            elif name in ("sparse_topk", "sparse_topk_union"):
                geometry = (ss.sparse_topk_geometry if name == "sparse_topk"
                            else ss.sparse_topk_union_geometry)
                row["geometry"] = geometry(b, t, int(d_ids.shape[0]))._asdict()
            out[name].append(row)
            log("lexkernel " + json.dumps(row))
    out["sparse_topk_hashed"].append(
        hashed_edge_request(index, vocab, rng, big_hashed, ss))
    out["sparse_topk"].append(flat_edge_request(index, vocab, rng, big_flat,
                                                ss))
    return out


# the wide query of #10's edge request: T + L past 3,376, the earlier #10's
# shared-memory limit (8 queries' slots, 8 warps' doc rows, 256 keys each)
FLAT_EDGE_T = 3_400
FLAT_EDGE_OLD_LIMIT = 3_376


def flat_edge_request(index, vocab, rng, bucket, ss) -> dict:
    """One request to #10 at the edges of its query table, on the card and
    bit-equal to plain at k = 10 and past a tile (k = 300): B = 13 (not a
    multiple of a query block), a term twice in one query and one shared by
    two queries, an all-pad row, and one query of FLAT_EDGE_T distinct terms
    (T + L past what the earlier #10 admitted)."""
    texts = lexical_queries([LEX_EDGE_B], vocab, rng)[0]
    qids_np, qvals_np = index._encode_queries(
        [index._query_terms(q) for q in texts])
    n, el = bucket.dev_ids.shape
    if FLAT_EDGE_T + el <= FLAT_EDGE_OLD_LIMIT:
        raise AssertionError(f"T={FLAT_EDGE_T} with rows of {el} slots is "
                             "inside the earlier limit")
    ids = np.full((LEX_EDGE_B, FLAT_EDGE_T), -1, np.int32)
    vals = np.zeros((LEX_EDGE_B, FLAT_EDGE_T), np.float32)
    ids[:, :qids_np.shape[1]] = qids_np
    vals[:, :qids_np.shape[1]] = qvals_np
    ids[0] = rng.choice(len(index.vocab), FLAT_EDGE_T, replace=False)
    vals[0] = rng.random(FLAT_EDGE_T, dtype=np.float32) + 0.5
    ids[1], vals[1] = -1, 0.0  # an all-pad row
    for row, tid in ((2, ids[2, 0]), (3, ids[2, 0])):
        free = int((ids[row] >= 0).sum())  # a term twice in row 2, and
        ids[row, free] = tid               # row 2's first term in row 3
        vals[row, free] = 0.5
    qids = torch.from_numpy(ids).cuda()
    qvals = torch.from_numpy(vals).cuda()
    d_ids, d_vals = bucket.dev_ids, bucket.dev_vals
    for k in (10, 300):
        s_k, i_k = ss.KERNELS["sparse_topk"](d_ids, d_vals, qids, qvals, k)
        torch.cuda.synchronize()
        s_p, i_p = ss.PLAIN["sparse_topk"](d_ids, d_vals, qids, qvals, k)
        if not (torch.equal(s_k, s_p) and torch.equal(i_k, i_p)):
            raise AssertionError(
                f"sparse_topk edge request k={k}: kernel differs from plain "
                f"(err {float((s_k - s_p).abs().max())}, same ids "
                f"{float((i_k == i_p).float().mean())})")
    row = {"kernel": "sparse_topk", "B": LEX_EDGE_B, "T": FLAT_EDGE_T,
           "N": int(n), "shape": [int(n), int(el)], "k": [10, 300],
           "max_abs_err": 0.0, "same_ids": 1.0,
           "geometry": ss.sparse_topk_geometry(LEX_EDGE_B, FLAT_EDGE_T,
                                               int(n))._asdict()}
    log("lexedge " + json.dumps(row))
    return row


def hashed_edge_request(index, vocab, rng, bucket, ss) -> dict:
    """One request to #11 at the edges of its query table, on the card and
    bit-equal to plain at k = 10 and past a tile (k = 300): B = 13 (not a
    multiple of a query block), T >= 64 (a query of 120 words), a term twice
    in one query and one shared by two queries, an all-pad row."""
    texts = lexical_queries([LEX_EDGE_B], vocab, rng)[0]
    texts[0] = " ".join(_zipf_words(vocab, 120, rng))
    qids_np, qvals_np = index._encode_queries(
        [index._query_terms(q) for q in texts])
    t = qids_np.shape[1]
    if t < 64:
        raise AssertionError(f"the edge request's T is {t} (< 64)")
    qids_np[1], qvals_np[1] = -1, 0.0  # an all-pad row
    for row, tid in ((2, qids_np[2, 0]), (3, qids_np[2, 0])):
        free = int((qids_np[row] >= 0).sum())  # a term twice in row 2, and
        qids_np[row, free] = tid               # row 2's first term in row 3
        qvals_np[row, free] = 0.5
    qids = torch.from_numpy(qids_np).cuda()
    qvals = torch.from_numpy(qvals_np).cuda()
    d_ids, d_vals = bucket.dev_ids, bucket.dev_vals
    for k in (10, 300):
        s_k, i_k = ss.KERNELS["sparse_topk_hashed"](d_ids, d_vals, qids,
                                                    qvals, k)
        torch.cuda.synchronize()
        s_p, i_p = ss.PLAIN["sparse_topk_hashed"](d_ids, d_vals, qids, qvals,
                                                  k)
        if not (torch.equal(s_k, s_p) and torch.equal(i_k, i_p)):
            raise AssertionError(
                f"sparse_topk_hashed edge request k={k}: kernel differs from "
                f"plain (err {float((s_k - s_p).abs().max())}, same ids "
                f"{float((i_k == i_p).float().mean())})")
    row = {"kernel": "sparse_topk_hashed", "B": LEX_EDGE_B, "T": t,
           "N": int(d_ids.shape[0]), "shape": list(d_ids.shape),
           "k": [10, 300], "max_abs_err": 0.0, "same_ids": 1.0,
           "geometry": ss.sparse_topk_hashed_geometry(LEX_EDGE_B,
                                                      t)._asdict()}
    log("lexedge " + json.dumps(row))
    return row


def _record(obj, attr, log_list):
    """Wrap obj.attr so each call's args and result are appended to
    log_list; returns the original for restoring."""
    orig = getattr(obj, attr)

    def wrapped(*a, **k):
        res = orig(*a, **k)
        log_list.append((a, k, res))
        return res

    setattr(obj, attr, wrapped)
    return orig


def _drive(server, jobs, pool, n_seq) -> tuple:
    """The /search load: jobs[:n_seq] from one client, then the rest from
    CLIENTS closed-loop clients (pool processes; client c sends jobs
    n_seq + c, + c + CLIENTS, ...). Returns (responses in job order,
    latencies (s), concurrent wall seconds, (sequential dispatches,
    concurrent dispatches))."""
    d0 = server.batches_served
    served = pool.apply(_client, (server.url, jobs[:n_seq]))
    d_seq = server.batches_served - d0
    rest = jobs[n_seq:]
    t0 = time.perf_counter()
    per_client = pool.starmap(_client, [
        (server.url, rest[c::CLIENTS]) for c in range(CLIENTS)])
    conc_s = time.perf_counter() - t0
    by_job = [None] * len(rest)
    for c in range(CLIENTS):
        for j, item in enumerate(per_client[c]):
            by_job[c + j * CLIENTS] = item
    served += by_job
    return ([r for r, _ in served], [t for _, t in served], conc_s,
            (d_seq, server.batches_served - d0 - d_seq))


def _load_stats(latencies, sizes, n_seq, conc_s) -> dict:
    seq_ms = [1e3 * t for t in latencies[:n_seq]]
    conc_ms = [1e3 * t for t in latencies[n_seq:]]
    return {
        "seq_requests": n_seq, "seq_p50_ms": _percentile(seq_ms, 50),
        "seq_p90_ms": _percentile(seq_ms, 90),
        "conc_requests": len(conc_ms), "conc_p50_ms": _percentile(conc_ms, 50),
        "conc_p90_ms": _percentile(conc_ms, 90),
        "conc_qps": sum(sizes[n_seq:]) / conc_s,
    }


def _counts(ss) -> dict:
    return {name: fn.launches for name, fn in ss.KERNELS.items()}


def _reset(ss) -> None:
    for fn in ss.KERNELS.values():
        fn.launches = 0


def _served_prefixes(batches, top_ks, responses, rows_by_text, row_of):
    """Every served id list must be a prefix of the list the retrieval
    system returned for that query text in some dispatch."""
    n = 0
    for batch, k, resp in zip(batches, top_ks, responses):
        if resp is None or len(resp["results"]) != len(batch):
            raise AssertionError(f"bad /search response {resp}")
        for text, hits in zip(batch, resp["results"]):
            got = [row_of[h["id"]] for h in hits]
            if not all(np.isfinite(h["score"]) for h in hits):
                raise AssertionError(f"non-finite score in {hits}")
            if not any(r[:len(got)] == got for r in rows_by_text[text]):
                raise AssertionError("a served id list is not what the "
                                     "retrieval system returned")
            n += 1
    return n


# a query past the slots one block of the walk holds (T ~6,200): #10-#13
# walk it in passes; LONG_LIVE live slots padded to it take passes too,
# the same rows at their live width one pass
UNION_LONG_T = 6_400
LONG_LIVE = 3_000


def _union_tol(qvals_np, t, vmax) -> float:
    """Two f32 evaluations of a lexical score in different orders: 2 (T +
    1) 2^-24 max contribution x the largest query weight sum."""
    return 2 * (t + 1) * 2.0 ** -24 * vmax * float(
        np.abs(qvals_np).sum(axis=1).max())


def union_edge_batch(index, vocab, rng) -> tuple:
    """The union edge request, (qids, qvals) as numpy arrays: LEX_EDGE_B
    queries, the first of 120 words, an all-pad row, a term twice in row 2
    and row 2's first term shared by row 3."""
    texts = lexical_queries([LEX_EDGE_B], vocab, rng)[0]
    texts[0] = " ".join(_zipf_words(vocab, 120, rng))
    qids_np, qvals_np = index._encode_queries(
        [index._query_terms(q) for q in texts])
    qids_np[1], qvals_np[1] = -1, 0.0  # an all-pad row
    for row, tid in ((2, qids_np[2, 0]), (3, qids_np[2, 0])):
        free = int((qids_np[row] >= 0).sum())  # a term twice in row 2, and
        qids_np[row, free] = tid               # row 2's first term in row 3
        qvals_np[row, free] = 0.5
    return qids_np, qvals_np


def union_hashed_phase(index, vocab, rng, ss) -> dict:
    """#13 on the card, over the BM25 index's largest hashed bucket: its
    walk held to the plain version at the union batches (B in
    UNION_BATCHES, drawn as lexical_serve_phase draws them) and at the
    union edge request (hashed_edge_request's: B = 13, a query of 120
    words, a term twice in a query and one shared, an all-pad row), at
    k = 10 and LEX_BIG_TOP_K, with a hash of its scores and ids (lex_ab
    holds them to another tree's bit for bit); the walk and #11 timed on the
    same queries (k = 10). Then, through each of the four entries (the flat
    ones over the bucket's rows as a flat ELL), one request of
    UNION_LONG_T live slots, walked in passes, held to the plain version,
    and one of LONG_LIVE live slots padded to UNION_LONG_T (passes), bit-
    equal to the same rows at their live width (one pass)."""
    hashed = [b for b in index._buckets if b.dev_ids.dim() == 3]
    bucket = max(hashed, key=lambda b: b.n_actual)
    d_ids, d_vals = bucket.dev_ids, bucket.dev_vals
    vmax = max(float(b.vals.max()) for b in index._buckets)
    walk = ss.sparse_topk_union_hashed_cuda
    per_term = ss.sparse_topk_hashed_cuda
    batches = []
    for b in UNION_BATCHES:
        texts = lexical_queries([b], vocab, rng)[0]
        batches.append((f"union{b}", index._encode_queries(
            [index._query_terms(q) for q in texts])))
    batches.append(("edge", union_edge_batch(index, vocab, rng)))
    rows = []
    for what, (qids_np, qvals_np) in batches:
        qids = torch.from_numpy(qids_np).cuda()
        qvals = torch.from_numpy(qvals_np).cuda()
        b, t = qids.shape
        tol = _union_tol(qvals_np, t, vmax)
        err, digest = 0.0, hashlib.sha256()
        for k in (10, LEX_BIG_TOP_K):
            s_w, i_w = walk(d_ids, d_vals, qids, qvals, k)
            torch.cuda.synchronize()
            digest.update(s_w.cpu().numpy().tobytes())
            digest.update(i_w.cpu().numpy().tobytes())
            s_p, _ = ss.PLAIN["sparse_topk_union_hashed"](d_ids, d_vals, qids,
                                                          qvals, k)
            err = max(err, float((s_w - s_p).abs().max()))
            if err > tol:
                raise AssertionError(f"#13 {what} k={k}: |walk - plain| "
                                     f"{err:.3e} > {tol:.3e}")
        n_union = len(np.unique(qids_np[qids_np >= 0]))
        row = {"batch": what, "B": b, "T": t, "U": n_union,
               "shape": list(d_ids.shape), "k": [10, LEX_BIG_TOP_K],
               "sha256": digest.hexdigest()[:16], "max_abs_err": err,
               "tol": tol, "geometry": ss.sparse_topk_union_hashed_geometry(
                   b, t)._asdict()}
        if what != "edge":
            for name, fn in (("walk", walk), ("hashed_per_term", per_term)):
                row[f"{name}_ms"] = cuda_median_ms(
                    lambda: fn(d_ids, d_vals, qids, qvals, 10), runs=7)
        rows.append(row)
        log("union13 " + json.dumps(row))
    # past one block's query slots: each entry walks in passes
    n_vocab = len(index.vocab)
    ids = np.full((2, UNION_LONG_T), -1, np.int32)
    vals = np.zeros((2, UNION_LONG_T), np.float32)
    ids[0, :UNION_LONG_T - 100] = rng.choice(n_vocab, UNION_LONG_T - 100,
                                             replace=False)
    ids[0, UNION_LONG_T - 100:] = ids[0, :100]  # terms twice in the query
    ids[1] = rng.choice(n_vocab, UNION_LONG_T, replace=True)
    vals[ids >= 0] = rng.random(int((ids >= 0).sum()), dtype=np.float32) + 0.5
    padded_ids = np.full_like(ids, -1)
    padded_vals = np.zeros_like(vals)
    padded_ids[:, :LONG_LIVE] = ids[:, :LONG_LIVE]
    padded_ids[0, LONG_LIVE - 50:LONG_LIVE] = ids[0, :50]  # held twice
    padded_vals[:, :LONG_LIVE] = vals[:, :LONG_LIVE]
    n_docs = d_ids.shape[0]
    flat = (d_ids.reshape(n_docs, -1), d_vals.reshape(n_docs, -1))
    docs = {"sparse_topk": flat, "sparse_topk_union": flat,
            "sparse_topk_hashed": (d_ids, d_vals),
            "sparse_topk_union_hashed": (d_ids, d_vals)}
    geometry = {"sparse_topk": ss.sparse_topk_geometry,
                "sparse_topk_union": ss.sparse_topk_union_geometry,
                "sparse_topk_hashed": ss.sparse_topk_hashed_geometry,
                "sparse_topk_union_hashed":
                    ss.sparse_topk_union_hashed_geometry}
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    tol = _union_tol(vals, UNION_LONG_T, vmax)
    long_rows = {}
    for name, fn in ss.KERNELS.items():
        extra = (n_docs,) if "hashed" not in name else ()
        slots = {t: geometry[name](2, t, *extra).slots
                 for t in (UNION_LONG_T, LONG_LIVE)}
        if not (slots[UNION_LONG_T] < UNION_LONG_T
                and slots[LONG_LIVE] == LONG_LIVE):
            raise AssertionError(f"{name}: slots a pass {slots}, not passes "
                                 f"at T={UNION_LONG_T} and one at "
                                 f"T={LONG_LIVE}")
        before = _counts(ss)
        s_k, i_k = getattr(ss, name)(*docs[name], cuda(ids), cuda(vals), 10)
        s_pad, i_pad = fn(*docs[name], cuda(padded_ids), cuda(padded_vals),
                          10)
        s_one, i_one = fn(*docs[name], cuda(padded_ids[:, :LONG_LIVE]),
                          cuda(padded_vals[:, :LONG_LIVE]), 10)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts(ss).items()
                    if v != before[k]}
        if launched != {name: 3}:
            raise AssertionError(f"{name} at T={UNION_LONG_T} launched "
                                 f"{launched}, not its own kernel")
        if not (torch.equal(s_pad, s_one) and torch.equal(i_pad, i_one)):
            raise AssertionError(f"{name}: {LONG_LIVE} slots walked in "
                                 "passes differ from one pass")
        s_p, _ = ss.PLAIN[name](*docs[name], cuda(ids), cuda(vals), 10)
        err = float((s_k - s_p).abs().max())
        if err > tol:
            raise AssertionError(f"{name} at T={UNION_LONG_T}: |kernel - "
                                 f"plain| {err:.3e} > {tol:.3e}")
        long_rows[name] = {"slots_a_pass": slots[UNION_LONG_T],
                           "passes_bit_equal_to_one": 1.0,
                           "max_abs_err": err}
    long_line = {"B": 2, "T": UNION_LONG_T, "live_padded": LONG_LIVE,
                 "shape": list(d_ids.shape), "tol": tol,
                 "entries": long_rows}
    log("unionlong " + json.dumps(long_line))
    return {"rows": rows, "long": long_line}


# -- the native builder, two-pass union serving, the prefilter, the CLI ------

# two-pass batches (k_scan 32 stays a selection; k at and under the gate's
# _TWOPASS_MAX_K) and the sentence-length deployment whose single flat
# bucket takes #12's stage 1 (no hashed copy under 24 slots)
TWOPASS_K = (10, 16)
SHORT_WORDS = 16
PREFILTER_B = (128, 512)
CLI_REQUESTS = 100
CLI_SEQ = 50


def _index_arrays(index) -> list:
    if index._buckets is None:
        return [(index.doc_ids, index.doc_vals, np.arange(index.ntotal))]
    return [(b.ids, b.vals, b.gids) for b in index._buckets]


NATIVE_CHUNKS = 12_500  # C's first chunks, built by both builders (all
                        # 100,000 until the evaluate phase needed the time,
                        # 25,000 until the parallel phase did)


def native_phase(chunks) -> dict:
    """The BM25 index of C's first NATIVE_CHUNKS chunks by the native
    builder (use_native=True) and by the Python builder in the same call:
    vocabulary, idf, avgdl and every bucket's arrays bit-equal. Both build
    times. (Until the evaluate phase needed the time, both built all of C
    and the native index was also held to the served deployment's.)"""
    from persian_rag_tpu_torch.index.lexical import BM25Index

    texts = [c["text"] for c in chunks[:NATIVE_CHUNKS]]
    out = {"chunks": len(texts)}
    built = {}
    for name, flag in (("native", True), ("python", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built[name] = BM25Index(device="cuda").build(texts, use_native=flag)
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
    nat, other = built["native"], built["python"]
    if nat.vocab != other.vocab or list(nat.idf) != list(other.idf):
        raise AssertionError("native vocabulary differs")
    if any(np.float64(v).tobytes() != np.float64(other.idf[t]).tobytes()
           for t, v in nat.idf.items()):
        raise AssertionError("native idf differs from the Python "
                             "builder's")
    if np.float64(nat._avgdl).tobytes() != np.float64(
            other._avgdl).tobytes():
        raise AssertionError("native avgdl differs")
    a, b = _index_arrays(nat), _index_arrays(other)
    if len(a) != len(b) or not all(
            np.array_equal(x[0], y[0]) and np.array_equal(
                x[1].view(np.uint32), y[1].view(np.uint32))
            and np.array_equal(x[2], y[2]) for x, y in zip(a, b)):
        raise AssertionError("native arrays differ")
    out.update({"buckets": len(_index_arrays(built["native"])),
                "entries": int(sum((x[0] >= 0).sum()
                                   for x in _index_arrays(built["native"]))),
                "vocab": len(built["native"].vocab), "bit_equal": True})
    log("native " + json.dumps(out))
    return out


def _stage1_counts(ss) -> dict:
    return {"sparse_topk_union": ss.sparse_topk_union_cuda.stage1_launches,
            "sparse_topk_union_hashed":
                ss.sparse_topk_union_hashed_cuda.stage1_launches}


def _stage1_reset(ss) -> None:
    ss.sparse_topk_union_cuda.stage1_launches = 0
    ss.sparse_topk_union_hashed_cuda.stage1_launches = 0


def _stage1_held(tag, s_k, i_k, s_p, i_p, u, t, ss) -> dict:
    """A stage-1 kernel's top k (s_k, i_k) held to its plain version's top
    k + 1 (s_p, i_p) on the same bf16 operands, within the proof's stage-1
    term: each lies within ss.stage1_rel_error(u, t) of the exact sum of its
    products (the kernel on the tensor cores, plain in one f32 chain), so
    every score within twice that of plain's at its rank; ids equal but
    where one of plain's neighbouring scores (the cut at k + 1 included)
    lies within that of it; where plain scores exactly 0 (no shared term)
    the kernel scores exactly 0 at the same id (zero ties lowest id
    first). Raises on any other difference."""
    k = s_k.shape[1]
    rel = 2.0 * ss.stage1_rel_error(u, t)
    sp = s_p[:, :k]
    tol = rel * sp.abs()
    err = (s_k - sp).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{tag}: a score lies "
                             f"{float((err / sp.abs()).max())} of plain's "
                             f"from it, past the bound {rel}")
    gaps = (s_p[:, 1:] - s_p[:, :-1]).abs()  # (B, k): to the next, the cut
    inf = torch.full_like(gaps[:, :1], float("inf"))
    near = torch.minimum(torch.cat([inf, gaps[:, :-1]], dim=1), gaps)
    differ = i_k != i_p[:, :k]
    if bool((differ & (near > 2 * tol)).any()):
        raise AssertionError(f"{tag}: ids differ from plain's past a "
                             "near-tie")
    zero = sp == 0
    if not (bool((s_k[zero] == 0).all())
            and torch.equal(i_k[zero], i_p[:, :k][zero])):
        raise AssertionError(f"{tag}: a document sharing no term is not "
                             "at exactly 0, lowest id first")
    pos = sp > 0
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err[pos] / sp[pos]).max()) if bool(
                pos.any()) else 0.0,
            "bound": rel, "ids_differ_near_tie": int(differ.sum())}


def _stage1_rows(name, docs, index, vocab, rng, ss, n_vocab) -> list:
    """#12's (flat docs) or #13's (hashed docs) stage 1 against its plain
    version on the card at the union batches, k = 32, within the proof's
    stage-1 term (`_stage1_held`); both modes timed, the plain version and
    one sparse product of the bf16-rounded operands (scores only) beside
    them."""
    d_ids, d_vals = docs
    kernel = ss.KERNELS[name]
    plain = ss.PLAIN[name]
    ids2 = d_ids.reshape(d_ids.shape[0], -1)
    vals2 = d_vals.reshape(ids2.shape)
    live = ids2 >= 0
    r16 = lambda x: x.bfloat16().float()
    rows_ = torch.arange(ids2.shape[0], device=ids2.device)[:, None]
    csr = torch.sparse_coo_tensor(
        torch.stack([rows_.expand_as(ids2)[live], ids2[live].long()]),
        r16(vals2[live]), (ids2.shape[0], n_vocab)).coalesce().to_sparse_csr()
    doc_freq = torch.bincount(ids2[live].long(), minlength=n_vocab)
    out = []
    for b in UNION_BATCHES:
        texts = lexical_queries([b], vocab, rng)[0]
        qids_np, qvals_np = index._encode_queries(
            [index._query_terms(q) for q in texts])
        qids = torch.from_numpy(qids_np).cuda()
        qvals = torch.from_numpy(qvals_np).cuda()
        k = 32
        u = len(np.unique(qids_np[qids_np >= 0]))
        s_k, i_k = kernel(d_ids, d_vals, qids, qvals, k, stage1=True)
        torch.cuda.synchronize()
        s_p, i_p = plain(d_ids, d_vals, qids, qvals, k + 1, stage1=True)
        held = _stage1_held(f"{name} stage 1 B={b}", s_k, i_k, s_p, i_p, u,
                            int(qids.shape[1]), ss)
        live_q = qids >= 0
        matches = float(doc_freq[qids[live_q].long()].sum())
        q_dense = torch.zeros((n_vocab, b), device=qids.device)
        q_dense.index_put_(
            (qids[live_q].long(), torch.arange(b, device=qids.device)[
                :, None].expand_as(qids)[live_q]), qvals[live_q],
            accumulate=True)
        q_dense = r16(q_dense)
        row = {"kernel": name + "_stage1", "B": b, "T": int(qids.shape[1]),
               "U": u, "shape": list(d_ids.shape), "k": k, **held,
               "ms": cuda_median_ms(lambda: kernel(d_ids, d_vals, qids,
                                                   qvals, k, stage1=True),
                                    runs=7),
               "exact_ms": cuda_median_ms(lambda: kernel(d_ids, d_vals, qids,
                                                         qvals, k), runs=7),
               "plain_ms": cuda_median_ms(lambda: plain(d_ids, d_vals, qids,
                                                        qvals, k,
                                                        stage1=True),
                                          runs=3, warmup=1),
               **roofline(_nbytes(d_ids, d_vals, qids, qvals, s_k, i_k),
                          2.0 * matches, "bf16"),
               "library_ms": cuda_median_ms(
                   lambda: torch.sparse.mm(csr, q_dense), runs=7)}
        out.append(row)
        log("stage1 " + json.dumps(row))
    return out


def _adversarial_stage1(rng, dev) -> tuple:
    """A flat (N, L) corpus and a batch built so that the tensor cores'
    f32 accumulation loses what it can: per query one weight near 2^10 and
    T - 1 small ones over 2^-10..2^-2, documents that hold most of the
    query terms (the large one always) with values over 2^+-10, and in
    every fourth slot a value that puts its product just under 2^-23 of the
    large one (below the cut of a group that the large product leads). A
    query's ids are consecutive, so that in the flat union's id order its
    large and small terms share k-steps; the batch's 3,072 cells take two
    passes."""
    n, el, b, t = 4096, 48, 64, 48
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    ids = np.full((n, el), -1, np.int32)
    vals = np.zeros((n, el), np.float32)
    bf = lambda x: np.asarray(torch.from_numpy(np.asarray(
        x, np.float32)).bfloat16().float())
    for q in range(b):
        qids[q] = q * t + np.arange(t)
        qvals[q] = bf(np.concatenate([[2.0 ** 10 * rng.uniform(1, 2)],
                                      2.0 ** rng.uniform(-10, -2, t - 1)]))
    for d in range(n):
        q = d % b
        held = np.concatenate([[0], np.sort(rng.choice(np.arange(1, t), 39,
                                                       replace=False))])
        v = bf(2.0 ** rng.uniform(-10, 10, len(held)))
        big = qvals[q, 0] * v[0]
        for j in range(4, len(held), 4):
            v[j] = bf(big * 2.0 ** -23 * 0.99 / qvals[q, held[j]])
        ids[d, :len(held)] = qids[q, held]
        vals[d, :len(held)] = v
    return ids, vals, qids, qvals


def _long_rows(n_vocab, rng, b=4, t=5000) -> tuple:
    """b query rows of t slots, past the 4,096 whose keys the kernel's
    first step sorts in shared memory (longer rows sort in the scratch):
    2,400 distinct terms a row, each at two random slots with its own
    value, the other slots pads."""
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    for q in range(b):
        terms = rng.choice(n_vocab, 2400, replace=False).astype(np.int32)
        slots = rng.permutation(t)[:4800]
        qids[q, slots] = np.concatenate([terms, terms])
        qvals[q, slots] = rng.uniform(0.1, 3.0, 4800)
    return qids, qvals


def stage1_edges(index, sidx, big_hashed, vocab, rng, ss) -> dict:
    """Stage 1 past each size a block of the kernel holds, and the
    adversarial batch, each held to plain (at k + 1) by `_stage1_held`:

    * "pass": 8 queries of ~1,200 Zipf words (~500 terms each), more query
      cells than a pass holds (2,048), over C16's ELL and C's largest
      hashed bucket, k = 32;
    * "chunk": 64 queries of 30 words, a block's union past its chunk (128
      terms) and its resident weights (256) in one pass, the same corpora,
      k = 32;
    * "sort": the same at k = 200, past the 32 entries of a running list
      (the kernel's sort mode: 256-doc tiles, each sorted, their top k
      merged);
    * "long": `_long_rows`, rows of 5,000 slots with every term twice (the
      rows' keys sorted in the scratch), k = 32;
    * "adversarial" (`_adversarial_stage1`), flat and hashed (S = 8): the
      largest relative error against the exact sum of the bf16 products
      (f64 on the host), printed beside stage1_rel_error(U, T), which it
      must not pass."""
    dev = torch.device("cuda", 0)
    out = {}
    corpora = (("C16", "sparse_topk_union", sidx,
                (sidx._dev_ids, sidx._dev_vals)),
               ("C", "sparse_topk_union_hashed", index,
                (big_hashed.dev_ids, big_hashed.dev_vals)))
    # the later cases draw from their own generator, so that the served
    # checks' batches stay those of the first two
    more = np.random.default_rng(SEED + 25)
    for case, b, words, k in (("pass", 8, 1200, 32), ("chunk", 64, 30, 32),
                              ("sort", 64, 30, 200), ("long", 4, 0, 32)):
        r = rng if case in ("pass", "chunk") else more
        texts = [" ".join(_zipf_words(vocab, words, r)) for _ in range(b)]
        for corpus, name, idx, docs in corpora:
            if case == "long":
                qn, vn = _long_rows(max(len(idx.vocab), 1), more)
            else:
                qn, vn = idx._encode_queries(
                    [idx._query_terms(x) for x in texts])
            qids = torch.from_numpy(qn).to(dev)
            qvals = torch.from_numpy(vn).to(dev)
            s_k, i_k = ss.KERNELS[name](*docs, qids, qvals, k, stage1=True)
            s_p, i_p = ss.PLAIN[name](*docs, qids, qvals, k + 1, stage1=True)
            u = len(np.unique(qn[qn >= 0]))
            geo = ss.sparse_stage1_geometry(
                b, int(qn.shape[1]), int(docs[0].shape[0]), k,
                1 if docs[0].dim() == 2 else int(docs[0].shape[1]))
            out[f"{case} {corpus}"] = {
                "B": b, "T": int(qn.shape[1]), "U": u, "k": k,
                "tile": geo.tile, "lists": geo.lists,
                "passes": -(-min(geo.queries, b) * int(qn.shape[1])
                            // geo.cells),
                **_stage1_held(f"{name} stage 1 {case}", s_k, i_k, s_p, i_p,
                               u, int(qn.shape[1]), ss)}
    ids, vals, qn, vn = _adversarial_stage1(rng, dev)
    qids = torch.from_numpy(qn).to(dev)
    qvals = torch.from_numpy(vn).to(dev)
    u, t = len(np.unique(qn[qn >= 0])), int(qn.shape[1])
    w64 = {(q, int(tid)): float(v) for q in range(qn.shape[0])
           for tid, v in zip(qn[q], vn[q]) if tid >= 0}
    for layout, s_n in (("flat", 1), ("hashed", 8)):
        if s_n == 1:
            docs = (torch.from_numpy(ids).to(dev),
                    torch.from_numpy(vals).to(dev))
            name = "sparse_topk_union"
        else:
            i3, v3 = ss.hash_segments(ids, vals, s_n)
            docs = (torch.from_numpy(i3).to(dev), torch.from_numpy(v3).to(dev))
            name = "sparse_topk_union_hashed"
        s_k, i_k = ss.KERNELS[name](*docs, qids, qvals, 32, stage1=True)
        s_p, i_p = ss.PLAIN[name](*docs, qids, qvals, 33, stage1=True)
        held = _stage1_held(f"{name} stage 1 adversarial", s_k, i_k, s_p,
                            i_p, u, t, ss)
        worst = 0.0
        for q, (row_s, row_i) in enumerate(zip(s_k.cpu().numpy(),
                                               i_k.cpu().numpy())):
            for score, doc in zip(row_s, row_i):
                exact = math.fsum(w64[(q, int(tid))] * float(v)
                                  for tid, v in zip(ids[doc], vals[doc])
                                  if (q, int(tid)) in w64)
                if exact > 0:
                    worst = max(worst, abs(float(score) - exact) / exact)
        bound = ss.stage1_rel_error(u, t)
        if not worst <= bound:
            raise AssertionError(f"stage 1 adversarial {layout}: relative "
                                 f"error {worst} past the bound {bound}")
        out[f"adversarial {layout}"] = {"B": int(qn.shape[0]), "T": t,
                                        "U": u, **held,
                                        "max_rel_err_exact": worst,
                                        "bound_exact": bound}
    log("stage1edges " + json.dumps(out))
    return out


def _short_chunks(chunks) -> list:
    return [{"id": c["id"], "text": " ".join(c["text"].split()[:SHORT_WORDS]),
             "chunk_type": "sentence_length"} for c in chunks]


def twopass_phase(rs, chunks, vocab, rng, ss, RetrievalSystem) -> dict:
    """Stage 1 of #12 and #13 and two-pass union serving on the card.

    Kernels: #13's stage 1 over C's largest hashed bucket, #12's over C's
    largest flat bucket and over C16's ELL (C's chunks cut to their first
    SHORT_WORDS words: one flat bucket of 100,000 rows, too narrow for a
    hashed copy), each held to its plain version within the proof's
    stage-1 term at B = 128 and 512 (`_stage1_held`), timed beside its
    exact mode; then past each size a block holds and on the adversarial
    batch (`stage1_edges`). Serving: C and C16 with two_pass="auto",
    union batches of 128 and 512 queries at k = 10 and 16 through
    RetrievalSystem.retrieve_batch: every list held to the f64 scorer and
    to the exact kernels' (two_pass="off") list of the same batch, near-ties
    counted as check_lexical counts them; the proof pass rate, the batches
    that fell back to the exact kernel, and the stage-1 launches (both
    must be above 0)."""
    index = rs.bm25_index
    n_vocab = max(len(index.vocab), 1)
    flat = [b for b in index._buckets if b.dev_ids.dim() == 2]
    hashed = [b for b in index._buckets if b.dev_ids.dim() == 3]
    big_flat = max(flat, key=lambda b: b.n_actual)
    big_hashed = max(hashed, key=lambda b: b.n_actual)
    t0 = time.perf_counter()
    short = RetrievalSystem(method="bm25", device="cuda")
    short.load_chunks_and_index(_short_chunks(chunks))
    short_build_s = time.perf_counter() - t0
    sidx = short.bm25_index
    if sidx._buckets is not None or sidx._dev_ids3 is not None or \
            sidx.ntotal < 65_536:
        raise AssertionError("C16 is not one flat bucket without a hashed "
                             "copy")
    kernels = {
        "sparse_topk_union_hashed": _stage1_rows(
            "sparse_topk_union_hashed", (big_hashed.dev_ids,
                                         big_hashed.dev_vals),
            index, vocab, rng, ss, n_vocab),
        "sparse_topk_union": _stage1_rows(
            "sparse_topk_union", (big_flat.dev_ids, big_flat.dev_vals),
            index, vocab, rng, ss, n_vocab)
        + _stage1_rows("sparse_topk_union", (sidx._dev_ids, sidx._dev_vals),
                       sidx, vocab, rng, ss, max(len(sidx.vocab), 1)),
    }
    edges = stage1_edges(index, sidx, big_hashed, vocab, rng, ss)
    served = {}
    verdicts = []
    _stage1_reset(ss)
    for name, system in (("C", rs), ("C16", short)):
        idx = system.bm25_index
        x, vmax = f64_matrix(idx)
        orig = _record(idx, "_note_twopass_verdict", verdicts)
        n0 = len(verdicts)
        terms, ids, scores, differ = [], [], [], 0
        for b in UNION_BATCHES:
            texts = lexical_queries([b], vocab, rng)[0]
            for k in TWOPASS_K:
                idx.two_pass = "off"
                want = system.retrieve_batch(texts, k)
                idx.two_pass = "auto"
                got = system.retrieve_batch(texts, k)
                for text, g, w in zip(texts, got, want):
                    terms.append(idx._query_terms(text))
                    ids.append([int(c["id"].split("_")[1]) for c, _ in g])
                    scores.append([s for _, s in g])
                    differ += [c["id"] for c, _ in g] != [
                        c["id"] for c, _ in w]
        setattr(idx, "_note_twopass_verdict", orig)
        idx.two_pass = "off"
        if idx._twopass_demoted:
            raise AssertionError(f"{name}: two-pass was demoted")
        oks = [np.asarray(a[0]) for a, _, _ in verdicts[n0:]]
        if len(oks) != len(UNION_BATCHES) * len(TWOPASS_K):
            raise AssertionError(f"{name}: {len(oks)} two-pass dispatches")
        check = check_lexical(idx, x, vmax, terms, ids, scores)
        if check["near_tie_rows"] > NEAR_TIE_SHARE * check["rows"]:
            raise AssertionError(f"{name}: too many near-tie rows: {check}")
        if differ > NEAR_TIE_SHARE * check["rows"]:
            raise AssertionError(f"{name}: {differ} lists differ from the "
                                 "exact kernels'")
        served[name] = {
            "rows": check["rows"], "near_tie_rows": check["near_tie_rows"],
            "max_score_err": check["max_score_err"],
            "differ_from_exact": differ,
            "proof_pass_rate": float(np.mean(np.concatenate(oks))),
            "proof_pass_rate_by_batch": {
                f"B={b} k={k}": float(np.mean(o)) for (b, k), o in zip(
                    [(b, k) for b in UNION_BATCHES for k in TWOPASS_K],
                    oks)},
            "exact_fallbacks": int(sum(not o.all() for o in oks)),
            "dispatches": len(oks)}
    launches = _stage1_counts(ss)
    if min(launches.values()) == 0:
        raise AssertionError(f"two-pass serving launched stage 1 "
                             f"{launches}")
    out = {"kernels": kernels, "edges": edges, "served": served,
           "stage1_launches": launches,
           "C16_build_s": short_build_s,
           "C16_shape": list(sidx._dev_ids.shape)}
    log("twopass " + json.dumps({k: v for k, v in out.items()
                                 if k not in ("kernels", "edges")}))
    short.cleanup()
    return out


def prefilter_phase(rs, vocab, rng, ft) -> dict:
    """The hashed-UB prefilter over C (1,024 buckets, k_scan 256): its
    build; "verified" at B = 128 and 512, k = 10, ids equal to the exact
    per-term scan's; "fast" Recall@10 against it; the proof pass rate; #1's
    launches (its stage 1 at d = 1,024), which must be above 0."""
    index = rs.bm25_index
    t0 = time.perf_counter()
    if not index.build_prefilter():
        raise AssertionError("build_prefilter refused C")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pf = index._prefilter
    from persian_rag_tpu_torch.ops import lexical_prefilter as lp

    rows, launches = [], 0
    for b in PREFILTER_B:
        texts = lexical_queries([b], vocab, rng)[0]
        terms = [index._query_terms(q) for q in texts]
        exact_s, exact_i = index._search_device(terms, 10, allow_union=False)
        exact_i = exact_i.cpu()
        ft.extract_candidates_bf16_cuda.launches = 0
        for mode in ("verified", "fast"):
            index.prefilter = mode
            index._search_device(terms, 10)  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            s, i = index._search_device(terms, 10)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            if mode == "verified":
                verified_ms = ms
                if not torch.equal(i.cpu(), exact_i):
                    raise AssertionError(f"verified B={b}: ids differ from "
                                         "the exact scan")
            else:
                fast_ms = ms
                recall = float(np.mean([
                    len(set(a.tolist()) & set(e.tolist())) / 10
                    for a, e in zip(i.cpu(), exact_i)]))
        index.prefilter = None
        launches += ft.extract_candidates_bf16_cuda.launches
        qids_np, qvals_np = index._encode_queries(terms)
        qh = lp.hash_queries(qids_np, qvals_np, pf.term_map, pf.n_buckets)
        _, _, ok = lp.prefilter_topk(
            torch.from_numpy(qh).cuda(), pf.w16, pf.row_norm_max, pf.uids,
            pf.uvals, torch.from_numpy(qids_np).cuda(),
            torch.from_numpy(qvals_np).cuda(), 10, k_scan=pf.k_scan,
            return_ok=True, fallback=False)
        row = {"B": b, "verified_equal": True, "fast_recall_at_10": recall,
               "proof_pass_rate": float(ok.float().mean()),
               "verified_ms": verified_ms, "fast_ms": fast_ms,
               "exact_ms": None}
        torch.cuda.synchronize()
        t = time.perf_counter()
        index._search_device(terms, 10, allow_union=False)
        torch.cuda.synchronize()
        row["exact_ms"] = 1e3 * (time.perf_counter() - t)
        rows.append(row)
        log("prefilter " + json.dumps(row))
    if launches == 0:
        raise AssertionError("the prefilter launched no stage-1 kernel")
    out = {"build_s": build_s, "image": list(pf.w16.shape),
           "unified_ell": list(pf.uids.shape), "rows": rows,
           "candidates_launches": launches}
    index._prefilter = None
    del pf
    torch.cuda.empty_cache()
    log("prefilterphase " + json.dumps({k: v for k, v in out.items()
                                        if k != "rows"}))
    return out


def _smi(*query: str) -> list:
    out = subprocess.run(["nvidia-smi", *query, "--format=csv,noheader,"
                          "nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _card_mib() -> int:
    """The first card's used memory (MiB), as nvidia-smi reads it."""
    return int(_smi("--query-gpu=memory.used")[0].split(",")[0])


# the least rise of the card's used memory that a process holding a CUDA
# context and C's BM25 index makes (MiB)
CLI_MIN_RISE_MIB = 256


def cli_phase(rs, chunks, vocab, rng, pool) -> dict:
    """`python -m persian_rag_tpu_torch serve --config ... --port ...` in a
    subprocess, with no --device (so on the card), over C's chunks written
    as drugs_word_chunks.csv under a temporary processed_dir, with a
    config.yaml naming it and a port FakeLlamaServer. /health, then
    CLI_REQUESTS /search requests (CLI_SEQ from one client, the rest from
    CLIENTS processes): every served list equals the in-process C system's
    for the same request, or parts from it at a near-tie of the f64
    scorer. The subprocess must run on the card: its pid among nvidia-smi's
    compute apps, or, where nvidia-smi lists the card's processes under
    other pids (a machine whose container proxies them: one "pid 1"), the
    card's used memory up by at least CLI_MIN_RISE_MIB while it serves and
    down again after it exits. Then `status --config ...` exits 0 and
    reports the fake server."""
    from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as tmp, FakeLlamaServer() as llm:
        processed = os.path.join(tmp, "processed")
        os.makedirs(processed)
        with open(os.path.join(processed, "drugs_word_chunks.csv"), "w",
                  encoding="utf-8", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["id", "text", "chunk_type"])
            for c in chunks:
                writer.writerow([c["id"], c["text"], c["chunk_type"]])
        cfg = os.path.join(tmp, "config.yaml")
        with open(cfg, "w", encoding="utf-8") as f:
            f.write(f"paths:\n  processed_dir: \"{processed}\"\n"
                    f"generation:\n  server_url: \"{llm}\"  # fake LLM\n")
        torch.cuda.synchronize()
        mib_before = _card_mib()
        t0 = time.perf_counter()
        err_path = os.path.join(tmp, "serve.stderr")
        err_file = open(err_path, "w", encoding="utf-8")
        proc = subprocess.Popen(
            [sys.executable, "-m", "persian_rag_tpu_torch", "serve",
             "--config", cfg, "--port", "0"], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=err_file, text=True)
        try:
            line = proc.stdout.readline()
            if "retrieval API at " not in line:
                proc.wait(timeout=60)
                with open(err_path, encoding="utf-8") as f:
                    raise AssertionError(f"serve did not start: {line!r} "
                                         f"{f.read()[-4000:]}")
            url = line.split("retrieval API at ")[1].split()[0]
            ready_s = time.perf_counter() - t0
            health = json.loads(urllib.request.urlopen(
                url + "/health", timeout=60).read())
            if health.get("status") != "ok" or health.get("method") != "bm25":
                raise AssertionError(f"/health answered {health}")
            mib_serving = _card_mib()
            apps = _smi("--query-compute-apps=pid,process_name")
            pid_listed = str(proc.pid) in [a.split(",")[0] for a in apps]
            sizes = [int(v) for v in rng.choice(REQUEST_SIZES,
                                                size=CLI_REQUESTS)]
            top_ks = [int(v) for v in rng.choice((5, 10), size=CLI_REQUESTS)]
            batches = lexical_queries(sizes, vocab, rng)
            jobs = list(zip(batches, top_ks))
            t = time.perf_counter()
            served = pool.apply(_client, (url, jobs[:CLI_SEQ]))
            seq_s = time.perf_counter() - t
            t = time.perf_counter()
            per_client = pool.starmap(_client, [
                (url, jobs[CLI_SEQ:][c::CLIENTS]) for c in range(CLIENTS)])
            conc_s = time.perf_counter() - t
            rest = [None] * (CLI_REQUESTS - CLI_SEQ)
            for c in range(CLIENTS):
                for j, item in enumerate(per_client[c]):
                    rest[c + j * CLIENTS] = item
            served += rest
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            err_file.close()
        time.sleep(2)  # an exited process's card memory is freed late
        mib_after = _card_mib()
        rise = mib_serving - mib_before
        if not pid_listed and not (rise >= CLI_MIN_RISE_MIB
                                   and mib_after < mib_serving):
            raise AssertionError(
                f"serve (pid {proc.pid}) did not show on the card: compute "
                f"apps {apps}, used MiB {mib_before} -> {mib_serving} -> "
                f"{mib_after}")
        status = subprocess.run(
            [sys.executable, "-m", "persian_rag_tpu_torch", "status",
             "--config", cfg], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
    if status.returncode != 0:
        raise AssertionError(f"status exited {status.returncode}: "
                             f"{status.stderr[-2000:]}")
    info = json.loads(status.stdout)
    if info["server"]["status"] != "connected" or info["server"][
            "base_url"] != llm or not info["artifacts"][
                "drugs_word_chunks.csv"]:
        raise AssertionError(f"status printed {info}")
    index = rs.bm25_index
    terms, ids, scores, differ, rows = [], [], [], 0, 0
    for (batch, k), (resp, _) in zip(jobs, served):
        want = rs.retrieve_batch(batch, k)
        for text, hits, row in zip(batch, resp["results"], want):
            got = [int(h["id"].split("_")[1]) for h in hits]
            rows += 1
            if got != [int(c["id"].split("_")[1]) for c, _ in row]:
                differ += 1
                terms.append(index._query_terms(text))
                ids.append(got)
                scores.append([h["score"] for h in hits])
    if differ:  # each differing list must be a near-tie of the f64 scorer
        check_lexical(index, *f64_matrix(index), terms, ids, scores)
    if differ > NEAR_TIE_SHARE * rows:
        raise AssertionError(f"{differ} of {rows} served lists differ")
    out = {"ready_s": ready_s, "requests": len(served), "rows": rows,
           "differ_near_tie": differ, "pid": proc.pid,
           "pid_listed": pid_listed, "compute_apps": apps,
           "card_mib": [mib_before, mib_serving, mib_after],
           "seq_s": seq_s, "conc_s": conc_s,
           "status_server": info["server"]["status"]}
    log("cli " + json.dumps(out))
    return out


def lexical_serve_phase(chunks, vocab, rng, pool, RetrievalSystem,
                        RetrievalServer, ss) -> dict:
    """BM25 as a lexical `serve` deployment: RetrievalSystem(method=
    "bm25") on the card behind RetrievalServer, the 176-request load and
    one request at top_k LEX_BIG_TOP_K (past a sparse kernel's tile; its
    launches counted apart), then in-process batches past the union gate.
    Every id list the system returned is held to the f64 scorer
    (check_lexical)."""
    t0 = time.perf_counter()
    rs = RetrievalSystem(method="bm25", device="cuda")
    if not rs.load_chunks_and_index(chunks):
        raise AssertionError("load_chunks_and_index failed")
    build_s = time.perf_counter() - t0
    index = rs.bm25_index
    layout = [[list(b.dev_ids.shape),
               None if b.dev_ids3 is None else list(b.dev_ids3.shape)]
              for b in index._buckets]
    log("bm25 " + json.dumps({"build_s": build_s, "buckets": layout,
                              "vocab": len(index.vocab)}))
    kernels = lexical_kernel_phase(index, vocab, rng)

    calls = []
    orig = _record(rs, "retrieve_batch", calls)
    rs.retrieve_batch(lexical_queries([2], vocab, rng)[0], 10)  # warm-up
    n_jobs = SEQ_REQUESTS + CLIENTS * PER_CLIENT
    sizes = [int(v) for v in rng.choice(REQUEST_SIZES, size=n_jobs)]
    top_ks = [int(v) for v in rng.choice((5, 10), size=n_jobs)]
    batches = lexical_queries(sizes, vocab, rng)
    calls.clear()
    _reset(ss)
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        health = json.loads(
            urllib.request.urlopen(server.url + "/health", timeout=60).read())
        if health.get("status") != "ok" or health.get("method") != "bm25":
            raise AssertionError(f"/health answered {health}")
        responses, latencies, conc_s, dispatches = _drive(
            server, list(zip(batches, top_ks)), pool, SEQ_REQUESTS)
        rag = _post(server.url + "/rag", {"question": batches[0][0],
                                          "top_k": 5})
        served_launches = _counts(ss)
        _reset(ss)
        big_batch = lexical_queries([BIG_QUERIES], vocab, rng)[0]
        big = _post(server.url + "/search",
                    {"queries": big_batch, "top_k": LEX_BIG_TOP_K})
        big_launches = _counts(ss)
    if not rag.get("contexts") or rag.get("answer") is not None:
        raise AssertionError(f"/rag answered {rag}")
    if sum(big_launches.values()) == 0:
        raise AssertionError("the top_k 200 request launched no sparse kernel")
    if [len(r) for r in big.get("results", [])] != [LEX_BIG_TOP_K] * len(
            big_batch):
        raise AssertionError(f"top_k {LEX_BIG_TOP_K} answered "
                             f"{[len(r) for r in big.get('results', [])]}")
    batches.append(big_batch)
    top_ks.append(LEX_BIG_TOP_K)
    responses.append(big)
    _reset(ss)
    union_times = {}
    for b in UNION_BATCHES:
        texts = lexical_queries([b], vocab, rng)[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs.retrieve_batch(texts, 10)
        union_times[f"batch{b}_s"] = time.perf_counter() - t
    inproc_launches = _counts(ss)
    # the union edge: one batch past the gate whose union spans several
    # chunks of union_prep, at k = 10 and past a sparse tile
    texts = lexical_queries([UNION_BATCHES[0]], vocab, rng)[0]
    terms = [index._query_terms(q) for q in texts]
    qids_np, _ = index._encode_queries(terms)
    n_union = len(np.unique(qids_np[qids_np >= 0]))
    if not index._union_gate(qids_np) or n_union <= ss.UNION_CHUNK:
        raise AssertionError(f"the union edge batch (U={n_union}) does not "
                             "cross the gate over several chunks")
    for k in (10, LEX_BIG_TOP_K):
        _reset(ss)
        rows = rs.retrieve_batch(texts, k)
        launches = _counts(ss)
        if launches["sparse_topk_union"] == 0 or any(len(r) != k
                                                     for r in rows):
            raise AssertionError(f"the union edge at k={k} launched "
                                 f"{launches} and answered "
                                 f"{sorted({len(r) for r in rows})}")
        for name, count in launches.items():
            inproc_launches[name] += count
        log("unionedge " + json.dumps({
            "B": len(texts), "T": int(qids_np.shape[1]), "U": n_union,
            "chunks": -(-n_union // ss.UNION_CHUNK), "k": k,
            "launches": launches}))
    setattr(rs, "retrieve_batch", orig)

    x, vmax = f64_matrix(index)
    row_of = {c["id"]: i for i, c in enumerate(chunks)}
    terms, ids, scores, rows_by_text = [], [], [], {}
    for (queries, k), _, res in ((c[0], c[1], c[2]) for c in calls):
        for text, row in zip(queries, res):
            terms.append(index._query_terms(text))
            ids.append([row_of[ch["id"]] for ch, _ in row])
            scores.append([s for _, s in row])
            rows_by_text.setdefault(text, []).append(ids[-1])
    check = check_lexical(index, x, vmax, terms, ids, scores)
    if check["near_tie_rows"] > NEAR_TIE_SHARE * check["rows"]:
        raise AssertionError(f"too many near-tie rows: {check}")
    n_checked = _served_prefixes(batches, top_ks, responses, rows_by_text,
                                 row_of)

    # TF-IDF over the first TFIDF_CHUNKS of the same texts, in process
    t0 = time.perf_counter()
    tf = RetrievalSystem(method="tfidf", device="cuda")
    tf.load_chunks_and_index(chunks[:TFIDF_CHUNKS])
    tf_build_s = time.perf_counter() - t0
    _reset(ss)
    tf_texts = lexical_queries([64, 512], vocab, rng)
    tf_rows = [tf.retrieve_batch(texts, 10) for texts in tf_texts]
    tf_launches = _counts(ss)
    tx, tvmax = f64_matrix(tf.tfidf_index)
    tf_terms = [tf.tfidf_index._query_terms(q) for texts in tf_texts
                for q in texts]
    tf_check = check_lexical(
        tf.tfidf_index, tx, tvmax, tf_terms,
        [[row_of[c["id"]] for c, _ in row] for rows in tf_rows for row in rows],
        [[s for _, s in row] for rows in tf_rows for row in rows])
    if tf_check["near_tie_rows"] > NEAR_TIE_SHARE * tf_check["rows"]:
        raise AssertionError(f"too many TF-IDF near-tie rows: {tf_check}")
    out = {
        "build_s": build_s, "dispatches": dispatches,
        "served_checked": n_checked, **_load_stats(latencies, sizes,
                                                   SEQ_REQUESTS, conc_s),
        "check": check, "served_launches": served_launches,
        "big_top_k_launches": big_launches,
        "inproc_launches": inproc_launches, **union_times,
        "tfidf_build_s": tf_build_s, "tfidf_check": tf_check,
        "tfidf_launches": tf_launches,
    }
    log("bm25serve " + json.dumps(out))
    tf.cleanup()
    return out, kernels, rs


def host_fusion(dense_rows, bm25_rows, top_k, dense_weight=0.6,
                bm25_weight=0.4):
    """The host fusion loop of RetrievalSystem.retrieve_hybrid_batch
    (fused=False), applied to given channel results [(chunk id, score)]."""
    combined = {}
    if dense_rows:
        max_d = max(s for _, s in dense_rows)
        for cid, score in dense_rows:
            norm = score / max_d if max_d > 0 else 0.0
            combined[cid] = {"dense": norm * dense_weight, "bm25": 0.0}
    if bm25_rows:
        max_b = max(s for _, s in bm25_rows)
        for cid, score in bm25_rows:
            norm = score / max_b if max_b > 0 else 0.0
            combined.setdefault(cid, {"dense": 0.0, "bm25": 0.0})
            combined[cid]["bm25"] = norm * bm25_weight
    fused = [(cid, e["dense"] + e["bm25"]) for cid, e in combined.items()]
    fused.sort(key=lambda x: x[1], reverse=True)
    return fused[:top_k]


def _match_fused(got, want, what) -> int:
    """Fused lists: scores within 1e-5; ids equal except where the host
    loop's neighbouring scores are within 1e-5 (returns 1 for such a
    near-tie row)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, host {len(want)}")
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    if not np.allclose(gs, ws, rtol=0, atol=1e-5):
        raise AssertionError(f"{what}: fused scores differ by "
                             f"{float(np.abs(gs - ws).max()):.3e}")
    if [c for c, _ in got] == [c for c, _ in want]:
        return 0
    for p, ((gc, _), (wc, _)) in enumerate(zip(got, want)):
        if gc != wc and not any(abs(ws[p] - ws[o]) <= 1e-5
                                for o in (p - 1, p + 1) if 0 <= o < len(ws)):
            raise AssertionError(f"{what}: ids differ off near-ties")
    return 1


def hybrid_phase(enc, chunks, vocab, rng, pool, RetrievalSystem,
                 RetrievalServer, ss, ft) -> dict:
    """Hybrid (dense 0.6 + BM25 0.4) over the lexical chunks, encoded once
    with the full-width encoder: /search served under the same load and one
    request at top_k HYBRID_BIG_TOP_K (its sparse launches counted apart),
    then in-process rerank. Each dispatch's fused lists are held to the host
    fusion loop on the dispatch's own channel outputs; the dense channel to
    the f32 scan, the BM25 channel to the f64 scorer."""
    t0 = time.perf_counter()
    rs = RetrievalSystem(method="hybrid", encoder=enc, dense_metric="l2")
    if not rs.load_chunks_and_index(chunks):
        raise AssertionError("load_chunks_and_index failed")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dense_calls, lex_calls, fused_calls = [], [], []
    orig_d = _record(rs.dense_index, "search_device", dense_calls)
    orig_l = _record(rs.bm25_index, "_search_device", lex_calls)
    orig_f = _record(rs, "_retrieve_hybrid_fused", fused_calls)
    rs.retrieve_batch(lexical_queries([2], vocab, rng)[0], 10)  # warm-up
    n_jobs = SEQ_REQUESTS + CLIENTS * PER_CLIENT
    sizes = [int(v) for v in rng.choice(REQUEST_SIZES, size=n_jobs)]
    top_ks = [int(v) for v in rng.choice((5, 10), size=n_jobs)]
    batches = lexical_queries(sizes, vocab, rng)
    for calls in (dense_calls, lex_calls, fused_calls):
        calls.clear()
    _reset(ss)
    ft.extract_candidates_bf16_cuda.launches = 0
    ft.extract_candidates_bf16x2_cuda.launches = 0
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        responses, latencies, conc_s, dispatches = _drive(
            server, list(zip(batches, top_ks)), pool, SEQ_REQUESTS)
        served_launches = _counts(ss)
        _reset(ss)
        big_batch = lexical_queries([BIG_QUERIES], vocab, rng)[0]
        big = _post(server.url + "/search",
                    {"queries": big_batch, "top_k": HYBRID_BIG_TOP_K})
        big_launches = _counts(ss)
    if sum(big_launches.values()) == 0:
        raise AssertionError("the hybrid top_k 100 request launched no "
                             "sparse kernel")
    if [len(r) for r in big.get("results", [])] != [HYBRID_BIG_TOP_K] * len(
            big_batch):
        raise AssertionError(f"top_k {HYBRID_BIG_TOP_K} answered "
                             f"{[len(r) for r in big.get('results', [])]}")
    batches.append(big_batch)
    top_ks.append(HYBRID_BIG_TOP_K)
    responses.append(big)
    for name, count in big_launches.items():
        served_launches[name] += count
    served_launches["extract_candidates_bf16"] = \
        ft.extract_candidates_bf16_cuda.launches
    served_launches["extract_candidates_bf16x2"] = \
        ft.extract_candidates_bf16x2_cuda.launches
    n_served_dispatches = len(fused_calls)
    rerank_texts = lexical_queries([16, 16], vocab, rng)
    rerank_rows = [rs.retrieve_hybrid_batch(t, 10, rerank=True)
                   for t in rerank_texts]
    for obj, attr, orig in ((rs.dense_index, "search_device", orig_d),
                            (rs.bm25_index, "_search_device", orig_l),
                            (rs, "_retrieve_hybrid_fused", orig_f)):
        setattr(obj, attr, orig)

    if not (len(dense_calls) == len(lex_calls) == len(fused_calls)):
        raise AssertionError("hybrid dispatches did not run both channels")
    row_of = {c["id"]: i for i, c in enumerate(chunks)}
    bm = rs.bm25_index
    corpus = rs.dense_index.fused_args().corpus
    x, vmax = f64_matrix(bm)
    near_fused = dense_near = n_lists = 0
    lex_terms, lex_ids, lex_scores, rows_by_text = [], [], [], {}
    for di, (d_call, l_call, f_call) in enumerate(
            zip(dense_calls, lex_calls, fused_calls)):
        queries, top_k, _, _, rerank = f_call[0]
        d_s, d_i = (t.cpu().numpy() for t in d_call[2])
        l_s, l_i = (t.cpu().numpy() for t in l_call[2])
        # the dense channel against the f32 scan of the same embeddings
        emb, m_d = d_call[0]
        _, i_ref = ft.flat_topk_ref(emb, corpus, m_d, metric="l2")
        dense_near += near_tie_rows(emb, corpus, d_call[2][1], i_ref)[0]
        for qi, text in enumerate(queries):
            lex_terms.append(bm._query_terms(text))
            lex_ids.append(list(l_i[qi]))
            lex_scores.append(list(l_s[qi]))
            dense_rows = [(chunks[i]["id"], 1.0 / (1.0 + float(s)))
                          for s, i in zip(d_s[qi], d_i[qi]) if i >= 0]
            bm_rows = [(chunks[i]["id"], float(s))
                       for s, i in zip(l_s[qi], l_i[qi]) if i >= 0]
            want = host_fusion(dense_rows, bm_rows, top_k)
            if rerank:
                continue
            got = [(c["id"], s) for c, s in f_call[2][qi]]
            near_fused += _match_fused(got, want, f"dispatch {di}")
            rows_by_text.setdefault(text, []).append(
                [row_of[c] for c, _ in got])
            n_lists += 1
    lex_check = check_lexical(bm, x, vmax, lex_terms, lex_ids, lex_scores)
    n_checked = _served_prefixes(batches, top_ks, responses, rows_by_text,
                                 row_of)
    # rerank: the host's exact cosine over the fused candidates' stored rows
    n_rerank = 0
    for texts, rows in zip(rerank_texts, rerank_rows):
        q = enc.encode(texts).astype(np.float64)
        for qi, row in enumerate(rows):
            cand = [row_of[c["id"]] for c, _ in row]
            vec = rs.dense_index.rows(np.asarray(cand)).astype(np.float64)
            sims = vec @ q[qi] / np.maximum(
                np.linalg.norm(vec, axis=1) * np.linalg.norm(q[qi]), 1e-12)
            got = np.array([s for _, s in row])
            if not np.allclose(got, sims, atol=1e-5):
                raise AssertionError("rerank cosine differs from the host's")
            if bool((np.diff(got) > 1e-6).any()):
                raise AssertionError("reranked list is not sorted")
            n_rerank += 1
    if near_fused > NEAR_TIE_SHARE * max(n_lists, 1) or \
            lex_check["near_tie_rows"] > NEAR_TIE_SHARE * lex_check["rows"]:
        raise AssertionError(
            f"too many hybrid near-tie rows: fused {near_fused} of "
            f"{n_lists}, lexical {lex_check}")
    out = {
        "build_s": build_s, "dispatches": dispatches,
        "device_dispatches": n_served_dispatches,
        "served_checked": n_checked, "fused_lists_checked": n_lists,
        "fused_near_tie_rows": near_fused, "dense_near_tie_rows": dense_near,
        "lexical_check": lex_check, "rerank_checked": n_rerank,
        **_load_stats(latencies, sizes, SEQ_REQUESTS, conc_s),
        "served_launches": served_launches,
        "big_top_k_launches": big_launches,
        "stage1_mode": rs.dense_index._stage1_mode,
    }
    log("hybrid " + json.dumps(out))
    return out


# -- phase 9: storage tiers, running top-k, index files ----------------------

TIER_KERNEL_Q = (16, 64, 512)  # query batches of the int8 candidate kernel
RUNNING_Q = 64  # query batch of the running top-k comparisons
# candidate keys that may differ from the plain version's (each by one key
# quantum: the kernel sums in k order, the library product in its own)
KEY_DIFF_SHARE = 0.01


def _f32_sum_tol(q, row_norm_max: float, d: int) -> float:
    """Bound on the difference of two f32 evaluations of q.c that sum in
    different orders: 2 (d + 2) 2^-24 ||q|| max ||c|| (Cauchy-Schwarz on
    the d-term accumulation, one scale or norm step, both sides)."""
    return 2 * (d + 2) * 2.0 ** -24 * float(q.norm(dim=1).max()) * row_norm_max


def check_running(got, plain, true_scores, tol, what, quantum=0.0,
                  l2_qsq=None) -> dict:
    """Hold a running top-k result (scores, ids) to its plain version and
    to `true_scores(ids)`, an f64 evaluation of the claimed ids' scores in
    the kernel's own score space.

    Each claimed score must be its id's true score within tol (plus, for
    the packed-key mode, `quantum` times its size in the maximize space:
    for l2 that is ||q||^2, given as l2_qsq (Q, 1), less the distance), and
    the two sorted
    score lists must agree position by position within the same: together
    they make the kernel's list a top-k up to rounding. Equal neighbouring
    scores must keep the lower id first. Returns the counts."""
    s_k, i_k = got
    s_p, i_p = plain
    if s_k.shape != s_p.shape or i_k.shape != i_p.shape:
        raise AssertionError(f"{what}: shapes differ from the plain version")
    if not bool(torch.isfinite(s_k).all()) or bool((i_k < 0).any()):
        raise AssertionError(f"{what}: non-finite score or missing id")
    size = s_k.double() if l2_qsq is None else l2_qsq - s_k.double()
    slack = tol + quantum * size.abs()
    err_true = (s_k.double() - true_scores(i_k)).abs()
    err_plain = (s_k.double() - s_p.double()).abs()
    if bool((err_true > slack).any()) or bool((err_plain > slack).any()):
        raise AssertionError(
            f"{what}: scores off by {float(err_true.max()):.3e} (own ids) / "
            f"{float(err_plain.max()):.3e} (plain) > {float(slack.min()):.3e}")
    tied = s_k[:, 1:] == s_k[:, :-1]
    if bool((tied & (i_k[:, 1:] < i_k[:, :-1])).any()):
        raise AssertionError(f"{what}: equal scores break the lower-id order")
    return {"max_abs_err": float(err_plain.max()), "tol": float(slack.min()),
            "same_ids": float((i_k == i_p).float().mean()),
            "tied_pairs": int(tied.sum())}


def _queries_near(corpus, n_q, gen, noise=0.3):
    """Unit queries near seeded corpus rows; the first 8 near rows 0-7,
    which the tie tests duplicate."""
    idx = torch.randint(0, corpus.shape[0], (n_q,), device=corpus.device,
                        generator=gen)
    idx[:8] = torch.arange(8, device=corpus.device)[: idx.shape[0]]
    q = corpus[idx] + noise * torch.randn(
        n_q, corpus.shape[1], device=corpus.device, generator=gen
    ) / corpus.shape[1] ** 0.5
    return (q / q.norm(dim=1, keepdim=True)).contiguous()


def tier_kernel_phase(ft, dev) -> dict:
    """Kernels #4, #5 and #6 against their plain versions at the shapes
    the storage tiers give them. Returns the rows per kernel."""
    from persian_rag_tpu_torch.index.dense import _quantize_int8

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    corpus = torch.randn(N_CORPUS, DIM, device=dev, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    # duplicate rows far apart: exact ties across tiles
    corpus[N_CORPUS // 2 : N_CORPUS // 2 + 256] = corpus[:256]
    center, scales, values = _quantize_int8(corpus.cpu().numpy())
    c8 = torch.from_numpy(values).to(dev)
    scale = torch.from_numpy(scales).to(dev)
    deq = c8.double() * scale.double()[:, None]  # the centered int8 image
    deq_norm = float(deq.norm(dim=1).max())
    out = {"int8_candidates": [], "running_exact": [], "running_fast": []}

    # #4: the int8 tier's candidate generation
    tile_n, n_easy = ft.SCALED_TILE_N, ft.SCALED_N_EASY
    for n_q in TIER_KERNEL_Q:
        q = _queries_near(corpus, n_q, g)

        def launch():
            return ft.extract_candidates_int8_cuda(q, c8, scale, tile_n, n_easy)

        def plain():
            return ft.flat_topk_candidates_plain(
                q, c8, None, tile_n, n_easy, None, scale)

        got = launch()
        torch.cuda.synchronize()
        # the kernel's chain, mirrored: its keys bit for bit
        if not torch.equal(got, ft.int8_chain_candidates(q, c8, scale, tile_n,
                                                         n_easy)):
            raise AssertionError(f"int8 candidates Q={n_q}: kernel keys differ "
                                 "from int8_chain_candidates")
        want = plain()
        live = (got != ft._INT_MIN) | (want != ft._INT_MIN)
        dk, dp = _decode(got, ft), _decode(want, ft)
        max_err = float((dk - dp).abs()[live].max())
        tol = _f32_sum_tol(q, deq_norm, DIM) + 2.0 ** -11 * float(
            dp[live].abs().max())
        same = float((got == want)[live].float().mean())
        if not max_err <= tol or same < 1 - KEY_DIFF_SHARE:
            raise AssertionError(
                f"int8 candidates Q={n_q}: kernel vs plain {max_err:.3e} > "
                f"{tol:.3e}, or only {same:.5f} of the keys equal")
        # the selection on top of it: candidate ids hold the true top-10
        # of the dequantised scores in all but a rounding share of rows
        cand = ft.flat_topk_scaled_candidates(q, c8, scale, 100)
        true10 = ft.flat_topk_ref(
            q.bfloat16().float(), deq.float(), 10)[1]
        held = float((cand[:, :, None] == true10[:, None, :]).any(1)
                     .float().mean())
        if held < 0.99:
            raise AssertionError(
                f"int8 candidates Q={n_q}: only {held:.4f} of the true "
                "top-10 among 100 candidates")
        row = {"kernel": "int8_candidates", "Q": n_q, "max_abs_err": max_err,
               "tol": tol, "same_keys": same, "chain_equal": True,
               "top10_held": held,
               "geometry": ft.int8_geometry(n_q, N_CORPUS, DIM,
                                            tile_n)._asdict(),
               "ms": cuda_median_ms(launch), "plain_ms": cuda_median_ms(plain),
               **roofline(_nbytes(q, c8, scale, got),
                          2.0 * n_q * N_CORPUS * DIM, "bf16"),
               "library_ms": None}
        out["int8_candidates"].append(row)
        log("tierkernel " + json.dumps(row))

    # #5 / #6: the running top-k at its regimes
    q = _queries_near(corpus, RUNNING_Q, g)
    small = corpus[:20_000].contiguous()
    small[10_000:10_128] = small[:128]  # exact ties inside the small corpus
    small16 = small.bfloat16()
    many = _queries_near(corpus, 2_304, g)
    past = corpus[:30_000].contiguous()
    c8_t = c8.t().contiguous()
    int8_kw = dict(corpus_scale=scale, compute_dtype=torch.bfloat16)
    cases = [  # (name, queries, rows, kwargs, score space of the rows, peak)
        (f"int8 100k k={k}", q, c8, dict(k=k, **int8_kw), ("bf16q", deq),
         "bf16")
        for k in (10, 100, 128)
    ] + [
        (f"int8 100k k=10 Q={n_q}", q[:n_q], c8, dict(k=10, **int8_kw),
         ("bf16q", deq), "bf16")
        for n_q in (1, 16)
    ] + [
        ("int8 100k k=10 (d, N)", q, c8_t,
         dict(k=10, corpus_transposed=True, **int8_kw), ("bf16q", deq),
         "bf16"),
    ] + [
        (f"f32 20k {metric}", q, small, dict(k=10, metric=metric),
         (metric, small.double()), "f32")
        for metric in ("dot", "l2")
    ] + [
        ("bf16 20k l2", q, small16,
         dict(k=10, metric="l2", compute_dtype=torch.bfloat16),
         ("l2q", small16.double()), "bf16"),
        ("f32 2304x30k", many, past, dict(k=10), ("dot", past.double()),
         "f32")]
    for name, qs, rows, kw, (space, rows64), peak in cases:
        q64 = (qs.bfloat16() if space in ("bf16q", "l2q") else qs).double()
        csq64 = (rows64 * rows64).sum(-1)

        def true_scores(ids, q64=q64, rows64=rows64, csq64=csq64,
                        space=space, qsq=(qs.double() ** 2).sum(-1)):
            dots = torch.einsum("qd,qkd->qk", q64, rows64[ids])
            if space not in ("l2", "l2q"):
                return dots
            # the l2 map of the kernel's space, back with the f32 ||q||^2
            return qsq[:, None] - (2.0 * dots - csq64[ids])

        norm = float(rows64.norm(dim=1).max())
        tol = _f32_sum_tol(qs, norm, DIM) * (
            2.0 * (1.0 + norm) if space in ("l2", "l2q") else 1.0)
        modes = ("exact",) if "2304" in name or "k=100" in name else (
            "exact", "fast")
        plain_kw = {x: v for x, v in kw.items() if x != "corpus_transposed"}
        plain_kw["transposed"] = kw.get("corpus_transposed", False)
        for mode in modes:
            def launch():
                return ft.flat_topk_running(qs, rows, mode=mode, **kw)

            def plain():
                return ft.flat_topk_running_plain(qs, rows, mode=mode,
                                                  **plain_kw)

            got = launch()
            torch.cuda.synchronize()
            res = check_running(
                got, plain(), true_scores, tol, f"running {mode} {name}",
                quantum=2.0 ** -11 if mode == "fast" else 0.0,
                l2_qsq=(qs.double() ** 2).sum(-1)[:, None]
                if space in ("l2", "l2q") else None)
            if mode == "exact" and "20k" in name and res["tied_pairs"] == 0:
                raise AssertionError(f"{name}: the duplicate rows never tied")
            if peak == "bf16":  # bf16 compute: the chain, mirrored
                mirror = ft.running_chain_topk(
                    qs, rows, mode=mode,
                    **{x: v for x, v in plain_kw.items()
                       if x != "compute_dtype"})
                if not (torch.equal(got[0], mirror[0])
                        and torch.equal(got[1], mirror[1])):
                    raise AssertionError(f"running {mode} {name}: lists "
                                         "differ from running_chain_topk")
                res["chain_equal"] = True
            runs = 7 if "2304" in name else 15
            geo = ft.running_geometry(
                qs.shape[0], rows.shape[1 if "(d, N)" in name else 0], DIM,
                kw["k"], rows.element_size(),
                torch.cuda.get_device_properties(dev).multi_processor_count)
            row = {"kernel": f"running_{mode}", "case": name,
                   "Q": int(qs.shape[0]),
                   "N": int(rows.shape[1 if "(d, N)" in name else 0]),
                   "k": kw["k"], **res, "geometry": geo._asdict(),
                   "ms": cuda_median_ms(launch, runs=runs),
                   "plain_ms": cuda_median_ms(plain, runs=runs),
                   **roofline(
                       _nbytes(qs, rows, kw.get("corpus_scale"), *got)
                       + (4 * rows.shape[0] if space == "l2" else 0),
                       2.0 * qs.shape[0] * rows.shape[0] * DIM, peak),
                   "library_ms": None}
            if mode == "exact":
                # the materialized scan (one matmul and one stable sort)
                # on the same inputs, the yardstick of the exact kernel
                ref_kw = {x: kw[x] for x in ("metric", "corpus_scale",
                                             "compute_dtype") if x in kw}
                rows_nd = c8 if "(d, N)" in name else rows
                row["library_ms"] = cuda_median_ms(
                    lambda: ft.flat_topk_ref(qs, rows_nd, kw["k"], **ref_kw),
                    runs=runs)
            out[f"running_{mode}"].append(row)
            log("tierkernel " + json.dumps(row))
    return out


# -- phase 9b: kernels #3, #7, #8, #9 and the (d, N) layout ------------------

LANE_N = 1_000_000  # the JAX dispatcher's lane-sliced regime: N >= 150k,
LANE_Q = 2_048      # a batch of 2,048, tile 2,048, 16 slots, depth 3
LANE_CHECK_Q = 256  # queries of the lane slice held to the plain version
EDGE_N = (20_481, 20_482, 20_483)  # 1-3 rows past a 256-row tile


def _mode_counts(ft) -> dict:
    return {
        "extract_candidates_grouped":
            ft.extract_candidates_grouped_cuda.launches,
        "running_insert": ft.flat_topk_running_insert_cuda.launches,
        "running_group": ft.flat_topk_running_group_cuda.launches,
        "running_maxonly": ft.flat_topk_running_maxonly_cuda.launches,
    }


def _mode_reset(ft) -> None:
    for fn in (ft.extract_candidates_grouped_cuda,
               ft.flat_topk_running_insert_cuda,
               ft.flat_topk_running_group_cuda,
               ft.flat_topk_running_maxonly_cuda):
        fn.launches = 0


def _ids_vs_scan(q, corpus, ids, ref_ids, metric) -> int:
    """Rows whose ids differ from the f32 scan's; each differing position
    must be an f32 near tie (l2: `near_tie_rows`; dot: the two rows' f64
    scores within twice the f32 summation bound)."""
    if metric == "l2":
        return near_tie_rows(q, corpus, ids, ref_ids)[0]
    rows = (ids != ref_ids).any(dim=1).nonzero().flatten()
    if rows.numel() == 0:
        return 0
    qd = q[rows].double()
    dots = lambda i: torch.einsum("qd,qkd->qk", qd, corpus[i].double())  # noqa
    gap = float((dots(ids[rows]) - dots(ref_ids[rows])).abs().max())
    tol = 2 * _f32_sum_tol(q, float(corpus.norm(dim=1).max()), q.shape[1])
    if gap > tol:
        raise AssertionError(f"ids differ from the f32 scan by {gap:.3e} > "
                             f"{tol:.3e}")
    return int(rows.numel())


def _grouped_row(ft, q, rows16, cn, ref, eps, tile_n, group, depth,
                 plain_q=None) -> dict:
    """#3 (group, depth) against its plain version (on the first plain_q
    queries when given) and the stage-1 contract, and, on the whole batch
    where plain_q is None, bit for bit against its chain
    (`ft.grouped_chain_candidates`); its time beside #1's."""
    n_easy = 4

    def launch():
        return ft.extract_candidates_grouped_cuda(
            q, rows16, cn, None, tile_n, n_easy, group, depth)

    qp = q if plain_q is None else q[:plain_q]

    def plain():
        return ft.flat_topk_candidates_plain(
            qp, rows16, cn, tile_n, n_easy, group=group, depth=depth)

    got = launch()
    torch.cuda.synchronize()
    got = got[: qp.shape[0]]
    want = plain()
    violation = max(
        check_contract(got, ref, eps[: qp.shape[0]], tile_n, n_easy, ft),
        check_contract(want, ref, eps[: qp.shape[0]], tile_n, n_easy, ft))
    if violation > 0:
        raise AssertionError(f"#3 ({group}, {depth}) Q={q.shape[0]}: stage-1 "
                             f"contract violated by {violation:.3e}")
    dk, dp = _decode(got, ft), _decode(want, ft)
    live = (got != ft._INT_MIN) | (want != ft._INT_MIN)
    max_err = float((dk - dp).abs()[live].max())
    tol = float(2 * eps.max() + 2.0 ** -10 * dp[live].abs().max())
    if not max_err <= tol:
        raise AssertionError(f"#3 ({group}, {depth}) Q={q.shape[0]}: kernel "
                             f"vs plain {max_err:.3e} > {tol:.3e}")
    if plain_q is None and not torch.equal(got, ft.grouped_chain_candidates(
            q, rows16, cn, None, tile_n, n_easy, group, depth)):
        raise AssertionError(f"#3 ({group}, {depth}) Q={q.shape[0]}: keys "
                             "differ from its chain's")
    runs = 5 if rows16.shape[0] > N_CORPUS else 15
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return {"tile_n": tile_n, "group": group, "depth": depth,
            "Q": int(q.shape[0]), "N": int(rows16.shape[0]),
            "checked_Q": int(qp.shape[0]), "contract_margin": violation,
            "max_abs_err": max_err, "tol": tol,
            "same_keys": float((got == want).float().mean()),
            "chain_equal": plain_q is None,
            "geometry": ft.grouped_geometry(
                q.shape[0], rows16.shape[0], rows16.shape[1], tile_n, group,
                depth, 2, sms)._asdict(),
            "ms": cuda_median_ms(launch, runs=runs),
            "queued_ms": cuda_queued_ms(launch, launches=5 if plain_q
                                        else 20),
            "ungrouped_ms": cuda_median_ms(
                lambda: ft.extract_candidates_bf16_cuda(
                    q, rows16, cn, tile_n, n_easy), runs=runs),
            "plain_ms": cuda_median_ms(plain, runs=3, warmup=1),
            **roofline(_nbytes(q, rows16, cn) + 4 * q.shape[0]
                       * (-(-rows16.shape[0] // tile_n)) * (n_easy + 1),
                       2.0 * q.shape[0] * rows16.shape[0] * DIM, "bf16"),
            "library_ms": None}


def _segment_geometry(ft, mode, n_q, rows, k, dev) -> dict:
    """The launch of #7 (fasti) / #8 (fastg) over (N, d) rows."""
    return ft.segment_geometry(
        n_q, rows.shape[0], rows.shape[1], k, rows.element_size(),
        0 if mode == "fasti" else 1,
        torch.cuda.get_device_properties(dev).multi_processor_count
    )._asdict()


def _e2s_pair(ft, q, corpus, rows16, csq, metric, tile_n, check_q, **kw):
    """The two-stage regime with and without a grouped / lane-sliced stage
    1: ms, proof rate, and ids against the f32 scan on check_q queries."""
    out = {}
    for name, extra in (("ungrouped", {}), ("grouped", kw)):
        def e2s(extra=extra):
            return ft.flat_topk_exact2_stream(
                q, corpus, 10, metric, corpus_sqnorm=csq, corpus_bf16=rows16,
                tile_n=tile_n, return_ok=True, **extra)

        _, ids, ok = e2s()
        ref = ft.flat_topk_ref(q[:check_q], corpus, 10, metric)[1]
        out[name] = {
            "ms": cuda_median_ms(e2s, runs=5 if corpus.shape[0] > N_CORPUS
                                 else 10),
            "proof_ok": float(ok.float().mean()),
            "near_tie_rows": _ids_vs_scan(q[:check_q], corpus,
                                          ids[:check_q], ref, metric)}
    return out


def kernel_modes_phase(ft, dev) -> dict:
    """Kernels #3, #7, #8 and #9 and the (d, N) layout. First the entry
    points that reach them, with their launch counts (DenseIndex
    search_mode fasti / fastg, the two-stage regime with a grouped and a
    lane-sliced stage 1, flat_topk mode maxonly); then each kernel against
    its plain version at those shapes, #7 / #8 against #6's output, #9's
    best score against #5's first, and
    every kernel that takes the (d, N) layout against its (N, d) result."""
    from persian_rag_tpu_torch.index.dense import DenseIndex, _quantize_int8

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    corpus = torch.randn(N_CORPUS, DIM, device=dev, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    corpus[N_CORPUS // 2 : N_CORPUS // 2 + 256] = corpus[:256]  # tied rows
    csq = torch.sum(corpus * corpus, dim=-1)
    c16 = corpus.bfloat16()
    center, scales, values = _quantize_int8(corpus.cpu().numpy())
    c8 = torch.from_numpy(values).to(dev)
    scale = torch.from_numpy(scales).to(dev)
    q64 = _queries_near(corpus, 64, g)
    q2k = _queries_near(corpus, 2_048, g)
    big = torch.randn(LANE_N, DIM, device=dev, generator=g)
    big /= big.norm(dim=1, keepdim=True)
    big16 = big.bfloat16()
    qlane = _queries_near(big, LANE_Q, g)
    indexes = {}
    for mode in ("fasti", "fastg"):
        indexes[mode] = DenseIndex(DIM, metric="ip", device=dev,
                                   search_mode=mode)
        indexes[mode].add(corpus.cpu().numpy())
        indexes[mode].commit()
    torch.cuda.synchronize()

    # the main path: every count from 0, read right after
    _mode_reset(ft)
    served = {mode: index.search(q64, 10) for mode, index in indexes.items()}
    ft.flat_topk_exact2_stream(q2k, corpus, 10, "l2", corpus_sqnorm=csq,
                               corpus_bf16=c16, group=16)
    ft.flat_topk_exact2_stream(qlane, big, 10, "dot", corpus_bf16=big16,
                               tile_n=2_048, lane_slots=16, lane_depth=3)
    ft.flat_topk(q64, c8, 10, corpus_scale=scale,
                 compute_dtype=torch.bfloat16, mode="maxonly")
    torch.cuda.synchronize()
    launches = _mode_counts(ft)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the entry points never launched {name}")
    stored = indexes["fasti"].fused_args().corpus
    want = ft.flat_topk_running(q64, stored, 10, mode="fast")
    for mode, (s, i) in served.items():
        if not (torch.equal(s, want[0]) and torch.equal(i, want[1])):
            raise AssertionError(f"DenseIndex(search_mode={mode!r}) lists "
                                 "differ from mode fast's")
    del indexes, stored
    out = {"launches": launches, "grouped": [], "running_insert": [],
           "running_group": [], "running_maxonly": []}

    # #3 over the 100k image: group 16 at tile 1,024
    for q in (q64, q2k):
        with ft.full_f32():
            ref_dot = q @ corpus.T
        for metric in ("dot", "l2"):
            cn = csq if metric == "l2" else None
            ref = 2.0 * ref_dot - csq[None, :] if metric == "l2" else ref_dot
            err_f = 2.0 if metric == "l2" else 1.0
            eps = err_f * ft._bf16_matmul_eps(DIM) * q.norm(dim=1) * \
                torch.sqrt(csq.max())
            row = _grouped_row(ft, q, c16, cn, ref, eps, 1_024, 16, 2)
            by_group = ft.flat_topk_candidates(q, c16, metric, cn, 1_024,
                                               group=16)
            by_lane = ft.flat_topk_candidates(q, c16, metric, cn, 1_024,
                                              lane_slots=16, lane_depth=2)
            if not all(torch.equal(a, b)
                       for a, b in zip(by_group[:2], by_lane[:2])):
                raise AssertionError("group=16 differs from lane (16, 2)")
            row["metric"] = metric
            row["two_stage"] = _e2s_pair(ft, q, corpus, c16, csq, metric,
                                         1_024, 256, group=16)
            out["grouped"].append(row)
            log("modekernel " + json.dumps(row))
        del ref_dot

    # the lane-sliced pick: (16, 3) at tile 2,048 over 1M rows, Q = 2,048
    with ft.full_f32():
        ref = qlane[:LANE_CHECK_Q] @ big.T
    eps = ft._bf16_matmul_eps(DIM) * qlane.norm(dim=1)  # unit rows
    row = _grouped_row(ft, qlane, big16, None, ref, eps, 2_048, 16, 3,
                       plain_q=LANE_CHECK_Q)
    del ref
    row["metric"] = "dot"
    row["two_stage"] = _e2s_pair(ft, qlane, big, big16, None, "dot", 2_048,
                                 LANE_CHECK_Q, lane_slots=16, lane_depth=3)
    out["lane"] = row
    log("modekernel " + json.dumps(row))
    del big, big16, qlane
    torch.cuda.empty_cache()

    # #7 / #8 / #9 at the running top-k's cases, and 1-3 rows past a tile
    deq = c8.double() * scale.double()[:, None]
    small = corpus[:20_000].contiguous()
    small[10_000:10_128] = small[:128]
    cases = [("int8 100k k=10", c8,
              dict(k=10, corpus_scale=scale, compute_dtype=torch.bfloat16),
              ("bf16q", deq), "bf16")]
    cases += [(f"f32 20k {metric}", small, dict(k=10, metric=metric),
               (metric, small.double()), "f32") for metric in ("dot", "l2")]
    cases += [(f"f32 {n} dot", corpus[:n].contiguous(), dict(k=10),
               ("dot", corpus[:n].double()), "f32") for n in EDGE_N]
    for name, rows, kw, (space, rows64), peak in cases:
        q64d = (q64.bfloat16() if space == "bf16q" else q64).double()
        csq64 = (rows64 * rows64).sum(-1)

        def true_scores(ids, rows64=rows64, csq64=csq64, space=space,
                        q64d=q64d):
            dots = torch.einsum("qd,qkd->qk", q64d, rows64[ids])
            if space != "l2":
                return dots
            return (q64d * q64d).sum(-1)[:, None] - (2.0 * dots - csq64[ids])

        norm = float(rows64.norm(dim=1).max())
        tol = _f32_sum_tol(q64, norm, DIM) * (
            2.0 * (1.0 + norm) if space == "l2" else 1.0)
        l2_qsq = (q64d * q64d).sum(-1)[:, None] if space == "l2" else None
        nbytes = _nbytes(q64, rows, kw.get("corpus_scale")) + (
            4 * rows.shape[0] if space == "l2" else 0)
        bound = roofline(nbytes + 12 * 64 * kw["k"],
                         2.0 * 64 * rows.shape[0] * DIM, peak)
        ref_kw = {x: kw[x] for x in ("metric", "corpus_scale",
                                     "compute_dtype") if x in kw}
        runs = {m: (lambda m=m: ft.flat_topk_running(q64, rows, mode=m, **kw))
                for m in ("exact", "fast", "fasti", "fastg", "maxonly")}
        fast = runs["fast"]()
        times = {m: cuda_median_ms(fn) for m, fn in runs.items()}
        library = cuda_median_ms(lambda: ft.flat_topk_ref(q64, rows, kw["k"],
                                                          **ref_kw))
        for mode, key, plain_fn in (
                ("fasti", "running_insert", ft.flat_topk_running_insert_plain),
                ("fastg", "running_group", ft.flat_topk_running_group_plain)):
            got = runs[mode]()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], fast[0])
                    and torch.equal(got[1], fast[1])):
                raise AssertionError(f"{mode} {name}: lists differ from #6's")

            def plain(plain_fn=plain_fn):
                return plain_fn(q64, rows, **kw)

            res = check_running(got, plain(), true_scores, tol,
                                f"running {mode} {name}", quantum=2.0 ** -11,
                                l2_qsq=l2_qsq)
            row = {"kernel": key, "case": name,
                   "N": int(rows.shape[0]), "k": kw["k"], **res,
                   "ms": times[mode], "fast_ms": times["fast"],
                   "queued_ms": cuda_queued_ms(runs[mode], launches=10),
                   "plain_ms": cuda_median_ms(plain, runs=3, warmup=1),
                   **bound, "library_ms": library,
                   "geometry": _segment_geometry(ft, mode, 64, rows, kw["k"],
                                                 dev)}
            out[key].append(row)
            log("modekernel " + json.dumps(row))
        got_s, got_i = runs["maxonly"]()
        torch.cuda.synchronize()
        plain_kw = {x: v for x, v in kw.items() if x != "k"}

        def plain_max():
            return ft.flat_topk_running_maxonly_plain(q64, rows, **plain_kw)

        # the same chain and finish as exact mode: its first score, bit
        # for bit (torch.equal holds -0 and +0 equal)
        if not torch.equal(got_s[:, 0], runs["exact"]()[0][:, 0]):
            raise AssertionError(f"maxonly {name}: differs from the first "
                                 "score of exact mode (#5)")
        best = got_s[:, 0].double()
        want_max = plain_max().double()
        true_max = torch.einsum("qd,nd->qn", q64d, rows64)
        if space == "l2":
            true_max = 2.0 * true_max - csq64[None, :]
        true_max = true_max.max(dim=1).values
        if space == "l2":
            best = l2_qsq[:, 0] - best
        err = float(max((best - want_max).abs().max(),
                        (best - true_max).abs().max()))
        if (bool((got_i != -1).any()) or not err <= tol * 2
                or bool((got_s != got_s[:, :1]).any())):
            raise AssertionError(f"maxonly {name}: off by {err:.3e} > "
                                 f"{2 * tol:.3e}, or ids / columns wrong")
        with ft.full_f32():
            if space == "bf16q":
                qb, cb = q64.bfloat16().float(), rows.float()
                lib_fn = lambda: (qb @ cb.T).mul_(scale).amax(1)  # noqa
            elif space == "l2":
                lib_fn = lambda: (2.0 * (q64 @ rows.T)  # noqa
                                  - (rows * rows).sum(-1)).amax(1)
            else:
                lib_fn = lambda: (q64 @ rows.T).amax(1)  # noqa
            # device time of calls queued back to back, for the kernel and
            # the library alike: a single call's event time would add the
            # wrapper's host path (~0.05 ms) to a 0.1-0.2 ms kernel
            lib_ms = cuda_queued_ms(lib_fn, launches=10)
        row = {"kernel": "running_maxonly", "case": name,
               "N": int(rows.shape[0]), "max_abs_err": err, "tol": 2 * tol,
               "ms": cuda_queued_ms(runs["maxonly"], launches=10),
               "event_ms": times["maxonly"], "exact_ms": times["exact"],
               "fast_ms": times["fast"],
               "plain_ms": cuda_median_ms(plain_max, runs=5),
               **roofline(nbytes + 4 * 64, 2.0 * 64 * rows.shape[0] * DIM,
                          peak),
               "f32_floor_ms": 1e3 * 2.0 * 64 * rows.shape[0] * DIM
               / PEAK_FLOPS["f32"],
               **ft.maxonly_geometry(
                   64, rows.shape[0], DIM, rows.element_size(),
                   torch.cuda.get_device_properties(dev).multi_processor_count
               )._asdict(),
               "library_ms": lib_ms}
        out["running_maxonly"].append(row)
        log("modekernel " + json.dumps(row))

    # #7 / #8 at k = 128: fastg's three lists of 128 keys a query take a
    # 32-query block (3 x 64 x 128 x 8 bytes would be 192 KB)
    bf16 = dict(corpus_scale=scale, compute_dtype=torch.bfloat16)
    fast = ft.flat_topk_running(q64, c8, 128, mode="fast", **bf16)
    q64b = q64.bfloat16().double()
    for mode, key, plain_fn in (
            ("fasti", "running_insert", ft.flat_topk_running_insert_plain),
            ("fastg", "running_group", ft.flat_topk_running_group_plain)):
        def run(mode=mode):
            return ft.flat_topk_running(q64, c8, 128, mode=mode, **bf16)

        got = run()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], fast[0]) and torch.equal(got[1], fast[1])):
            raise AssertionError(f"{mode} int8 100k k=128: lists differ from "
                                 "#6's")
        res = check_running(
            got, plain_fn(q64, c8, 128, **bf16),
            lambda ids: torch.einsum("qd,qkd->qk", q64b, deq[ids]),
            _f32_sum_tol(q64, float(deq.norm(dim=1).max()), DIM),
            f"running {mode} int8 100k k=128", quantum=2.0 ** -11)
        row = {"kernel": key, "case": "int8 100k k=128", "N": N_CORPUS,
               "k": 128, **res, "ms": cuda_median_ms(run),
               "queued_ms": cuda_queued_ms(run, launches=10),
               "geometry": _segment_geometry(ft, mode, 64, c8, 128, dev)}
        out[key].append(row)
        log("modekernel " + json.dumps(row))

    # the (d, N) layout: every kernel that takes it, bit for bit
    same = {}
    c16t, c8t, smallt = (x.t().contiguous() for x in (c16, c8, small))
    for metric in ("dot", "l2"):
        cn = csq if metric == "l2" else None
        same[f"#1 {metric}"] = torch.equal(
            ft.extract_candidates_bf16_cuda(q64, c16, cn, 1_024, 4),
            ft.extract_candidates_bf16_cuda(q64, c16t, cn, 1_024, 4, True))
        same[f"#3 {metric}"] = torch.equal(
            ft.extract_candidates_grouped_cuda(q64, c16, cn, None, 1_024, 4,
                                               16, 2),
            ft.extract_candidates_grouped_cuda(q64, c16t, cn, None, 1_024, 4,
                                               16, 2, True))
    same["#4"] = torch.equal(
        ft.extract_candidates_int8_cuda(q64, c8, scale, 2_048, 7),
        ft.extract_candidates_int8_cuda(q64, c8t, scale, 2_048, 7, True))
    for mode in ("exact", "fast", "fasti", "fastg", "maxonly"):
        for name, rows, rows_t, kw in (
                ("int8", c8, c8t, dict(corpus_scale=scale,
                                       compute_dtype=torch.bfloat16)),
                ("f32 l2", small, smallt, dict(metric="l2"))):
            a = ft.flat_topk_running(q64, rows, 10, mode=mode, **kw)
            b = ft.flat_topk_running(q64, rows_t, 10, mode=mode,
                                     corpus_transposed=True, **kw)
            same[f"{mode} {name}"] = all(map(torch.equal, a, b))
    torch.cuda.synchronize()
    if not all(same.values()):
        raise AssertionError(f"(d, N) layout differs from (N, d): {same}")
    out["layout_equal"] = same
    out["seconds"] = time.perf_counter() - t0
    log("modelayout " + json.dumps({"equal": same,
                                    "seconds": out["seconds"],
                                    "launches": launches}))
    return out


def _tier_counts(ft) -> dict:
    return {
        "extract_candidates_bf16": ft.extract_candidates_bf16_cuda.launches,
        "extract_candidates_bf16x2": ft.extract_candidates_bf16x2_cuda.launches,
        "extract_candidates_int8": ft.extract_candidates_int8_cuda.launches,
        "running_exact": ft.flat_topk_running_exact_cuda.launches,
        "running_fast": ft.flat_topk_running_fast_cuda.launches,
    }


def _tier_reset(ft) -> None:
    for fn in (ft.extract_candidates_bf16_cuda, ft.extract_candidates_bf16x2_cuda,
               ft.extract_candidates_int8_cuda, ft.flat_topk_running_exact_cuda,
               ft.flat_topk_running_fast_cuda):
        fn.launches = 0


def tier_serve_phase(name, index, enc, chunks, rng, ft, RetrievalSystem,
                     RetrievalServer, pool, check) -> dict:
    """Serve `index` (a committed DenseIndex of a storage tier) behind
    RetrievalSystem and RetrievalServer under the 176-request load, and
    hold every dispatch to `check(queries, k, scores, ids) -> dict of
    counts`; every served list must be what the system returned."""
    rs = RetrievalSystem(method="dense", encoder=enc,
                         dense_metric=index.metric)
    rs.chunks, rs.dense_index, rs.is_ready = list(chunks), index, True
    searches, calls = [], []
    orig_s = _record(index, "search_device", searches)
    orig_r = _record(rs, "retrieve_batch", calls)
    rs.retrieve_batch(["گرم کردن", "پرسش آغازین دارو"], 10)  # warm-up
    n_jobs = SEQ_REQUESTS + CLIENTS * PER_CLIENT
    sizes = [int(v) for v in rng.choice(REQUEST_SIZES, size=n_jobs)]
    top_ks = [int(v) for v in rng.choice((5, 10), size=n_jobs)]
    batches = make_queries(sizes, rng)
    searches.clear()
    calls.clear()
    _tier_reset(ft)
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        health = json.loads(
            urllib.request.urlopen(server.url + "/health", timeout=60).read())
        if health.get("status") != "ok":
            raise AssertionError(f"/health answered {health}")
        responses, latencies, conc_s, dispatches = _drive(
            server, list(zip(batches, top_ks)), pool, SEQ_REQUESTS)
        rag = _post(server.url + "/rag", {"question": batches[0][0],
                                          "top_k": 5})
    launches = _tier_counts(ft)
    index.search_device = orig_s
    rs.retrieve_batch = orig_r
    if not rag.get("contexts") or rag.get("answer") is not None:
        raise AssertionError(f"/rag answered {rag}")
    if len(searches) != len(calls):
        raise AssertionError("a dispatch did not search the index once")
    row_of = {c["id"]: i for i, c in enumerate(chunks)}
    rows_by_text, totals = {}, {}
    for (s_args, _, (scores, ids)), (r_args, _, res) in zip(searches, calls):
        queries, k = s_args[0], s_args[1]
        for key, val in check(queries, k, scores, ids).items():
            totals[key] = totals.get(key, 0) + val
        got = ids.cpu().numpy()
        for text, row, want in zip(r_args[0], res, got):
            listed = [row_of[ch["id"]] for ch, _ in row]
            if listed != list(want):
                raise AssertionError(
                    f"{name}: the system's list is not the index's")
            rows_by_text.setdefault(text, []).append(listed)
    n_checked = _served_prefixes(batches[: len(responses)], top_ks, responses,
                                 rows_by_text, row_of)
    out = {"deployment": name, "storage": str(index.storage_dtype),
           "metric": index.metric, "tier_probe": index.tier_probe,
           "dispatches": dispatches, "served_checked": n_checked,
           **_load_stats(latencies, sizes, SEQ_REQUESTS, conc_s),
           "check": totals, "launches": launches}
    log("tierserve " + json.dumps(out))
    return out


def tier_phase(enc, chunks, vectors, rng, ft, RetrievalSystem,
               RetrievalServer, pool, dev) -> dict:
    """Deployments E and F over deployment A's vectors, the in-process
    regimes, and the index files."""
    from persian_rag_tpu_torch.index.dense import DenseIndex, _refine_topk

    def build(metric, rows=vectors, **kw):
        index = DenseIndex(DIM, metric=metric, device=dev, **kw)
        index.add(rows)
        index.commit()
        return index

    out = {}
    # E: int8 candidates + exact refine, cosine
    e_index = build("cosine", storage_dtype=torch.int8)
    normed = e_index.fused_args().refine_corpus  # the normalized f32 rows

    def check_e(queries, k, scores, ids):
        a = e_index.fused_args()
        qn = queries / queries.norm(dim=1, keepdim=True).clamp(min=1e-12)
        # kernel-only faults: the same search through the plain versions
        slots = ft.flat_topk_candidates_plain(
            qn, a.corpus, None, ft.SCALED_TILE_N, ft.SCALED_N_EASY, None,
            a.corpus_scale)
        keys = slots[:, :, : ft.SCALED_N_EASY].reshape(qn.shape[0], -1)
        cand = ft._candidate_ids(
            keys, min(max(10 * k, 100), keys.shape[1]), ft.SCALED_TILE_N,
            ft.SCALED_N_EASY)[1]
        _, plain_ids = _refine_topk(qn, a.refine_corpus, cand, k)
        differ = int((plain_ids != ids).any(dim=1).sum())
        # the refine: every served score is its id's exact f32 score
        exact = torch.einsum("qd,qkd->qk", qn.double(), normed[ids].double())
        err = float((scores.double() - exact).abs().max())
        if err > 1e-5:
            raise AssertionError(f"E: refined score off by {err:.3e}")
        ref = ft.flat_topk_ref(qn, normed, k)[1]
        hits = int((ids[:, :, None] == ref[:, None, :]).any(1).sum())
        return {"rows": int(ids.shape[0]), "rows_differing_from_plain": differ,
                "hits": hits, "wanted": int(ref.numel())}

    e = tier_serve_phase("E int8+refine", e_index, enc, chunks, rng, ft,
                         RetrievalSystem, RetrievalServer, pool, check_e)
    e["recall_at_k"] = e["check"]["hits"] / e["check"]["wanted"]
    if e["recall_at_k"] < 0.99:
        raise AssertionError(f"E: Recall@k {e['recall_at_k']:.4f} < 0.99")
    if e["check"]["rows_differing_from_plain"] > 0.005 * e["check"]["rows"]:
        raise AssertionError(f"E: too many lists differ from plain: {e}")
    if e["launches"]["extract_candidates_int8"] == 0:
        raise AssertionError("E never launched the int8 candidate kernel")
    out["E"] = e

    # F: bf16 storage behind the quality gate, l2
    def serve_f(name, index):
        stored = index._device_corpus

        def check_f(queries, k, scores, ids):
            ref = ft.flat_topk_ref(queries, stored, k, metric="l2")[1]
            rows, _, _ = near_tie_rows(queries, stored.float(), ids, ref)
            return {"rows": int(ids.shape[0]), "near_tie_rows": rows}

        f = tier_serve_phase(name, index, enc, chunks, rng, ft,
                             RetrievalSystem, RetrievalServer, pool, check_f)
        if f["check"]["near_tie_rows"] > 0.01 * f["check"]["rows"]:
            raise AssertionError(f"{name}: too many near-tie rows: {f}")
        return f

    f_index = build("l2", storage_dtype=torch.bfloat16, quality_floor=0.95)
    out["F"] = serve_f("F bf16 (gated)", f_index)
    if f_index.storage_dtype != torch.bfloat16:
        # the gate demoted the tier on this corpus: the bf16 path is still
        # served, with the gate off
        del f_index
        f_index = build("l2", storage_dtype=torch.bfloat16, quality_floor=None)
        out["F_ungated"] = serve_f("F bf16 (gate off)", f_index)
    bf16_served = out.get("F_ungated", out["F"])
    if bf16_served["launches"]["extract_candidates_bf16"] == 0:
        raise AssertionError("F never launched stage 1 on the stored rows")
    del f_index

    # in process: the regimes the running top-k serves
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows_t = torch.from_numpy(vectors).to(dev)
    q = _queries_near(rows_t / rows_t.norm(dim=1, keepdim=True), 64, g)
    _tier_reset(ft)
    raw = build("cosine", storage_dtype=torch.int8, refine_dtype=None,
                quality_floor=None)
    a = raw.fused_args()
    s_raw, i_raw = raw.search(q, 10)
    deq = a.corpus.double() * a.corpus_scale.double()[:, None]
    qn = q / q.norm(dim=1, keepdim=True)
    plain = ft.flat_topk_running_plain(
        qn, a.corpus, 10, corpus_scale=a.corpus_scale,
        compute_dtype=torch.bfloat16)
    shift = (qn.double() @ a.center.double())[:, None]
    res_raw = check_running(
        (s_raw, i_raw), (plain[0] + shift.float(), plain[1]),
        lambda ids: torch.einsum(
            "qd,qkd->qk", qn.bfloat16().double(), deq[ids]) + shift,
        _f32_sum_tol(qn, float(deq.norm(dim=1).max()), DIM) + 1e-6,
        "raw int8 search")
    after_raw = _tier_counts(ft)
    if after_raw["running_exact"] == 0:
        raise AssertionError("raw int8 never launched the running top-k")
    del raw, deq

    small = build("cosine", rows=vectors[:40_000], storage_dtype=torch.int8)
    s_sm, i_sm = small.search(q, 10)
    normed_sm = small.fused_args().refine_corpus
    ref_sm = ft.flat_topk_ref(qn, normed_sm, 10)[1]
    exact_sm = torch.einsum("qd,qkd->qk", qn.double(), normed_sm[i_sm].double())
    recall_sm = float((i_sm[:, :, None] == ref_sm[:, None, :]).any(1)
                      .float().mean())
    err_sm = float((s_sm.double() - exact_sm).abs().max())
    after_small = _tier_counts(ft)
    if (recall_sm < 0.99 or err_sm > 1e-5
            or after_small["running_exact"] <= after_raw["running_exact"]
            or after_small["extract_candidates_int8"] != 0):
        raise AssertionError(
            f"int8 + refine at 40k: recall {recall_sm}, score err {err_sm}, "
            f"launches {after_small}")
    del small

    fast = build("ip", rows=vectors[:20_000], search_mode="fast")
    s_f, i_f = fast.search(q, 10)
    rows64 = fast.fused_args().corpus.double()
    res_fast = check_running(
        (s_f, i_f), ft.flat_topk_ref(q, fast.fused_args().corpus, 10),
        lambda ids: torch.einsum("qd,qkd->qk", q.double(), rows64[ids]),
        _f32_sum_tol(q, float(rows64.norm(dim=1).max()), DIM), "fast search",
        quantum=2.0 ** -11)
    after_fast = _tier_counts(ft)
    if after_fast["running_fast"] == 0:
        raise AssertionError("search_mode='fast' never launched its kernel")
    del fast, rows64
    out["in_process"] = {"raw_int8": res_raw, "int8_refine_40k": {
        "recall_at_10": recall_sm, "max_score_err": err_sm},
        "fast_20k": res_fast, "launches": after_fast}
    log("tierinproc " + json.dumps(out["in_process"]))

    # index files: save -> load, export_faiss -> from_faiss -> the system
    texts = [b[0] for b in make_queries([1] * 32, rng)]
    emb = enc.encode_device(texts)
    src = build("l2")
    want = src.search_device(emb, 10)[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        src.save(os.path.join(tmp, "native"))
        loaded = DenseIndex.load(os.path.join(tmp, "native"), device=dev)
        same_native = bool(torch.equal(loaded.search_device(emb, 10)[1], want))
        del loaded
        faiss_path = os.path.join(tmp, "flat.index")
        src.export_faiss(faiss_path)
        size = os.path.getsize(faiss_path)
        rs = RetrievalSystem(method="dense", encoder=enc)
        if not rs.load_chunks_and_index(chunks, faiss_index_file=faiss_path):
            raise AssertionError("load_chunks_and_index(faiss_index_file=) failed")
        got = rs.retrieve_batch(texts, 10)
        row_of = {c["id"]: i for i, c in enumerate(chunks)}
        same_faiss = [[row_of[c["id"]] for c, _ in r] for r in got] == \
            want.cpu().tolist()
        seconds = time.perf_counter() - t0
    if not (same_native and same_faiss and rs.dense_metric == "l2"
            and rs._rows_match_encoder is False):
        raise AssertionError(
            f"index files: native {same_native}, faiss {same_faiss}")
    rs.cleanup()
    out["files"] = {"queries": len(texts), "faiss_bytes": size,
                    "seconds": seconds}
    log("tierfiles " + json.dumps(out["files"]))
    return out


# -- phase 10: the quantized matmul kernels against their plain version -------

QUANT_B = (1, 8, 64, 256)  # timed activation rows (decode, verify block, prefill)
# rows held against plain: the kernels pick a template by the row count (one
# row, two, up to four, groups of eight; #15 one, two, four or eight n8
# tiles of 8 rows, 64 rows a pass), so both sides of every switch, a partly
# filled group of eight (#15: a partly filled second n8 tile, 9, and a
# partly filled second 64-row pass, 72) are checked; a served group has 2..8
# rows
QUANT_B_CHECK = (1, 2, 3, 4, 5, 7, 8, 9, 64, 72, 256)
# (kernel, K, N, weights stored (N, K)), K the activations' width:
# Llama-3.2-1B's k/v, q/o and gate/up projections, its down projection and its
# tied lm_head in int8; the same layer projections in int4 (packed 1024 x 512,
# 1024 x 2048, 1024 x 8192 and 4096 x 2048); w8a8 at the gate/up and down
# shapes
QUANT_SHAPES = (
    ("w8a16", 2048, 512, False), ("w8a16", 2048, 2048, False),
    ("w8a16", 2048, 8192, False), ("w8a16_splitk", 8192, 2048, False),
    ("w8a16_nt", 2048, 128_256, True),
    ("w4a16", 2048, 512, False), ("w4a16", 2048, 2048, False),
    ("w4a16", 2048, 8192, False), ("w4a16", 8192, 2048, False),
    ("w8a8", 2048, 8192, False), ("w8a8", 8192, 2048, False),
)
L2_BYTES = 50 * 1024 * 1024
QUANT_SOURCE_LINES = {"w8a16": 115, "w8a16_nt": 121, "w8a16_splitk": 239,
                      "w4a16": 417, "w8a8": 132}
# torch._int_mm (cuBLASLt int8) takes more than 16 rows only
INT_MM_MIN_ROWS = 17


# shapes off the served path held like QUANT_SHAPES' (kernel, K, N, rows):
# #15 at a ragged last group of weight rows (N = 1,000), a K that is not a
# multiple of a 64-value step and the least K; #14 and #17 at one chunk and a
# ragged last chunk, #14 also at the least N (one strip) and the least K;
# #14, #17, #18 and #16 at a K that is no multiple of 16 (x padded with
# zeros, the weight rows past K never read); #16 also at one and two
# strips, a ragged last chunk at the down projection's width and more spans
# of K than a cluster holds (the sums in device memory)
QUANT_RAGGED_B = (1, 8, 9, 72, 256)
QUANT_EDGE_SHAPES = (
    ("w8a16_nt", 2048, 1000, (1, 8, 9, 72)),
    ("w8a16_nt", 2000, 1000, (1, 8, 9, 72)), ("w8a16_nt", 16, 77, (1, 9)),
    ("w8a16_splitk", 64, 64, (1, 8, 9)),
    ("w8a16_splitk", 8208, 2048, (1, 8, 9)),
    ("w8a16", 2048, 64, (1, 8, 9, 72)), ("w8a16", 16, 64, (1, 8, 9)),
    ("w8a16", 2064, 512, (1, 8, 9, 256)),
    ("w8a16", 100, 256, QUANT_RAGGED_B), ("w8a16", 2056, 8192, QUANT_RAGGED_B),
    ("w8a16_splitk", 8200, 2048, QUANT_RAGGED_B),
    ("w4a16", 100, 256, QUANT_RAGGED_B), ("w4a16", 2056, 8192, QUANT_RAGGED_B),
    ("w4a16", 8200, 2048, QUANT_RAGGED_B),
    ("w8a8", 2048, 64, QUANT_B_CHECK), ("w8a8", 2048, 128, QUANT_B_CHECK),
    ("w8a8", 100, 256, QUANT_B_CHECK), ("w8a8", 2056, 8192, QUANT_B_CHECK),
    ("w8a8", 8200, 2048, QUANT_B_CHECK), ("w8a8", 20000, 128, (1, 9, 72)),
)
# the public entries at the least ragged K above, on CUDA tensors: they
# reach the kernel (K = 100 raised before any kernel took a ragged K)
QUANT_RAGGED_ENTRY = (100, 256, (1, 9))


def _hold_quant(qm, name, x, w, scale, wd, wd_abs, sc):
    """Kernel `name` at x against plain: within the f32 summation bound of
    the f64 product x @ wd * sc (#16: equal), each of rows 0, B / 2 and B - 1
    alone bit-equal to the row inside the batch, two calls bit-equal.
    Returns (kernel result, plain result, bound)."""
    b, k = x.shape
    n = sc.shape[1]
    got = qm.KERNELS[name](x, w, scale)
    torch.cuda.synchronize()
    want = qm.PLAIN[name](x, w, scale)
    if name == "w8a8":
        tol = torch.zeros(1, device=x.device)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name} {k}x{n} B={b}: kernel differs from plain by "
                f"{float((got - want).abs().max()):.3e} (must be equal)")
    else:
        exact = (x.double() @ wd) * sc
        tol = (k + 2) * 2.0 ** -24 * (x.double().abs() @ wd_abs) * sc
        for what, res in (("kernel", got), ("plain", want)):
            over = float(((res.double() - exact).abs() - tol).max())
            if not over <= 0 or not bool(torch.isfinite(res).all()):
                raise AssertionError(
                    f"{name} {k}x{n} B={b}: {what} is {over:.3e} "
                    "beyond the f32 summation bound")
    for row in sorted({0, b // 2, b - 1}):
        alone = qm.KERNELS[name](x[row:row + 1].contiguous(), w, scale)
        if not torch.equal(alone[0], got[row]):
            raise AssertionError(
                f"{name} {k}x{n} B={b}: row {row} alone differs from the "
                "row inside the batch")
    if not torch.equal(qm.KERNELS[name](x, w, scale), got):
        raise AssertionError(
            f"{name} {k}x{n} B={b}: two calls give different bits")
    return got, want, tol


def quant_kernel_phase(qm, dev) -> dict:
    """Kernels #14, #15, #17, #18 and #16 against their plain versions at
    the Llama-3.2-1B shapes. Every bf16 x int8 or int4 product is exact in
    f32, so #14, #15, #17 and #18 and their plain versions differ only in
    the order of the f32 sum: each must lie within (K + 2) * 2^-24 *
    sum_k |x w| * scale of the f64 result (K - 1 additions and the scale's
    product, each rounding once). #16 sums exactly in int32: it must equal
    plain bit for bit. A row alone and inside a batch must give the same
    bits, and two calls the same bits. These are checked at every row count
    of QUANT_B_CHECK (each kernel also at QUANT_EDGE_SHAPES, and the
    public entries at QUANT_RAGGED_ENTRY); times are
    taken at QUANT_B. Times are medians of CUDA events over weight copies
    that together exceed the L2 cache, so every launch streams its weights
    from device memory as a decode step does; ms, plain_ms and library_ms
    are device times of calls queued back to back (cuda_queued_ms), call_ms
    is one call with its host launch path. library_ms is torch.matmul of x
    with a bf16 (dequantized, for int4) copy of the weights (made outside
    the timed window) times the scale: the float serving path, twice or
    four times the bytes; for #16, torch._int_mm (cuBLASLt int8) times the
    scale where it takes the shape (more than 16 rows), else None."""
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    out = {name: [] for name in qm.KERNELS}
    for name, k, n, nt in QUANT_SHAPES:
        kind = name if name in ("w4a16", "w8a8") else "w8a16"
        shape = (n, k) if nt else ((k // 2, n) if kind == "w4a16" else (k, n))
        copies = max(2, -(-2 * L2_BYTES // (shape[0] * shape[1])) + 1)
        weights = torch.randint(-127, 128, (copies, *shape), dtype=torch.int8,
                                device=dev, generator=g)
        scale = (torch.rand((n, 1) if nt else (1, n), device=dev, generator=g)
                 * 0.01 + 0.001)
        w0 = weights[0]
        if kind == "w4a16":
            w16 = torch.stack([torch.cat(qm.unpack_int4(w)).bfloat16()
                               for w in weights])
            wd = torch.cat(qm.unpack_int4(w0)).double()
        else:
            w16 = weights.bfloat16() if kind == "w8a16" else None
            wd = w0.double().T if nt else w0.double()
        wd_abs = wd.abs()
        sc = scale.double().reshape(1, -1)
        for b in QUANT_B_CHECK:
            route = qm.kernel_route(b, k, n, nt, kind=kind)
            if route != name:
                raise AssertionError(f"({b}, {k}) x ({k}, {n}) routes to {route}")
            if kind == "w8a8":
                x = torch.randint(-127, 128, (b, k), dtype=torch.int8,
                                  device=dev, generator=g)
            else:
                x = torch.randn((b, k), device=dev, generator=g).bfloat16()
            got, want, tol = _hold_quant(qm, name, x, w0, scale, wd, wd_abs,
                                         sc)
            row = {
                "kernel": name, "K": k, "N": n, "B": b,
                "max_abs_err": float((got - want).abs().max()),
                "tol_min": float(tol.min()), "tol_max": float(tol.max()),
            }
            if kind == "w4a16":
                row["geometry"] = qm.w4a16_geometry(k, n)._asdict()
            elif name in ("w8a16", "w8a16_splitk"):
                row["geometry"] = qm.w8a16_splitk_geometry(k, n)._asdict()
            elif name == "w8a16_nt":
                row["geometry"] = qm.w8a16_nt_geometry(b, n, dev)._asdict()
            elif name == "w8a8":
                row["geometry"] = qm.w8a8_geometry(k, n)._asdict()
            if b not in QUANT_B:
                out[name].append(row)
                log("quantkernel " + json.dumps(row))
                continue
            turn = [0]

            def cycle(fn, ws):
                def run():
                    turn[0] = (turn[0] + 1) % copies
                    return fn(ws[turn[0]])
                return run

            library_ms = None
            if nt:
                lib = lambda w: torch.matmul(x, w.T) * scale.reshape(1, -1)
            elif kind == "w8a8":
                lib = lambda w: torch._int_mm(x, w).float() * scale
            else:
                lib = lambda w: torch.matmul(x, w) * scale
            if kind != "w8a8":
                library_ms = cuda_queued_ms(cycle(lib, w16))
            elif b >= INT_MM_MIN_ROWS:
                try:
                    library_ms = cuda_queued_ms(cycle(lib, weights))
                except RuntimeError as e:  # a yardstick the port never calls
                    log(f"quantkernel {name} B={b}: torch._int_mm refused: {e}")
            row.update({
                "ms": cuda_queued_ms(
                    cycle(lambda w: qm.KERNELS[name](x, w, scale), weights)),
                "call_ms": cuda_median_ms(
                    cycle(lambda w: qm.KERNELS[name](x, w, scale), weights)),
                "plain_ms": cuda_queued_ms(
                    cycle(lambda w: qm.PLAIN[name](x, w, scale), weights)),
                "library_ms": library_ms,
                **roofline(_nbytes(x, w0, scale, got), 2.0 * b * k * n,
                           "int8" if kind == "w8a8" else "bf16"),
            })
            row["gb_per_s"] = 1e-6 * w0.numel() / row["ms"]
            out[name].append(row)
            log("quantkernel " + json.dumps(row))
        del weights, w16, w0, wd, wd_abs
    for name, k, n, rows in QUANT_EDGE_SHAPES:
        nt = name == "w8a16_nt"
        shape = (n, k) if nt else ((k // 2, n) if name == "w4a16" else (k, n))
        w = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                          generator=g)
        scale = (torch.rand((n, 1) if nt else (1, n), device=dev, generator=g)
                 * 0.01 + 0.001)
        if name == "w4a16":
            wd = torch.cat(qm.unpack_int4(w)).double()
        else:
            wd = w.double().T if nt else w.double()
        err = 0.0
        for b in rows:
            if name == "w8a8":
                x = torch.randint(-127, 128, (b, k), dtype=torch.int8,
                                  device=dev, generator=g)
            else:
                x = torch.randn((b, k), device=dev, generator=g).bfloat16()
            got, want, _ = _hold_quant(qm, name, x, w, scale, wd, wd.abs(),
                                       scale.double().reshape(1, -1))
            err = max(err, float((got - want).abs().max()))
        edge = {"kernel": name, "K": k, "N": n, "rows": list(rows),
                "max_abs_err": err}
        if name == "w4a16":
            edge["geometry"] = qm.w4a16_geometry(k, n)._asdict()
        elif name == "w8a8":
            edge["geometry"] = qm.w8a8_geometry(k, n)._asdict()
        elif name != "w8a16_nt":
            edge["geometry"] = qm.w8a16_splitk_geometry(k, n)._asdict()
        log("quantedge " + json.dumps(edge))
    log("quantentry " + json.dumps(_quant_ragged_entries(qm, dev, g)))
    for fn in qm.KERNELS.values():
        fn.launches = 0
    return out


def _quant_ragged_entries(qm, dev, g) -> dict:
    """w8a16_matmul, w4a16_matmul and w8a8_matmul on CUDA tensors at a K
    that is no multiple of 16 (QUANT_RAGGED_ENTRY): each routes to its
    kernel, launches it once a call and gives the kernel's bits on the
    inputs it prepares (bf16 x; #16 the rows quantized, the product times
    their scale)."""
    k, n, rows = QUANT_RAGGED_ENTRY
    out = {"K": k, "N": n, "rows": list(rows)}
    for name, entry in (("w8a16", qm.w8a16_matmul),
                        ("w4a16", qm.w4a16_matmul),
                        ("w8a8", qm.w8a8_matmul)):
        shape = (k // 2, n) if name == "w4a16" else (k, n)
        w = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                          generator=g)
        scale = torch.rand((1, n), device=dev, generator=g) * 0.01 + 0.001
        for b in rows:
            x = torch.randn((b, k), device=dev, generator=g)
            if qm.kernel_route(b, k, n, kind=name) != name:
                raise AssertionError(f"{name} ({b}, {k}) x ({k}, {n}) does "
                                     "not route to its kernel")
            before = qm.KERNELS[name].launches
            got = entry(x, w, scale)
            if qm.KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} at K={k} did not launch its "
                                     "kernel")
            if name == "w8a8":
                x_q, x_scale = qm.quantize_rows(x)
                want = qm.KERNELS[name](x_q, w, scale) * x_scale
            else:
                want = qm.KERNELS[name](x.bfloat16(), w, scale)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at K={k}, B={b}: the entry "
                                     "differs from its kernel")
        out[name] = "kernel"
    return out


# -- phase 10b: kernel #19 (the matvec probe's 2-D tile) and the probe ---------

PROBE_BATCHES = (1, 8)  # the probe entry point's runs: a decode step, a batch
PROBE_REPS = 100
# the kernels line: the tile the JAX package routes the down projection to
# (persian_rag_tpu/ops/quant_matmul.py:309-312), at #17's row of it
PROBE_MAIN = (8192, 2048, 2048, 256, 8)  # K, N, block_n, block_k, rows


def matvec_probe_phase(qm, dev) -> dict:
    """(a) Kernel #19 (`w8a16_2d_cuda`) against its plain version
    (`w8a16_2d_plain`) at the probe's four Llama-3.2-1B shapes, for every
    tile the probe runs there, at every row count of QUANT_B_CHECK: kernel
    and plain within the f32 summation bound of the f64 result (as phase
    10), a row alone bit-equal to the row in the batch, the same call twice
    bit-equal (the last-ticket reduction sums in tile order, whatever order
    the blocks finish in), the call again bit-equal after a launch with
    another tile on the same tickets (every launch leaves them 0), and
    tiles of equal block_k bit-equal (a column's sum depends on the K
    tiles alone).
    (b) The probe entry point (`bench_matvec_probe.run`) at batch 1 and 8,
    with #19's launch counter set to 0 before each run and read after it.
    (c) #19 at PROBE_MAIN for the kernels line: device times queued back
    to back over weight copies cycled past the L2 (as phase 10), beside
    the plain version, #17 at the same shape and the bf16 library product
    times the scale."""
    from persian_rag_tpu_torch.scripts import bench_matvec_probe as probe

    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    checks = []
    for name, k, n in probe.SHAPES:
        values = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                               device=dev, generator=g)
        scale = torch.rand((1, n), device=dev, generator=g) * 0.01 + 0.001
        wd = values.double()
        wd_abs = wd.abs()
        sc = scale.double()
        tiles = probe.tiles(k, n)
        for b in QUANT_B_CHECK:
            x = torch.randn((b, k), device=dev, generator=g).bfloat16()
            exact = (x.double() @ wd) * sc
            tol = (k + 2) * 2.0 ** -24 * (x.double().abs() @ wd_abs) * sc
            by_bk = {}  # a column's sum depends on the K tiles alone
            for i, (bn, bk) in enumerate(tiles):
                what_at = f"#19 {name} {k}x{n} bn={bn} bk={bk} B={b}"
                got = qm.w8a16_2d_cuda(x, values, scale, bn, bk)
                torch.cuda.synchronize()
                want = qm.w8a16_2d_plain(x, values, scale, bk)
                for what, res in (("kernel", got), ("plain", want)):
                    over = float(((res.double() - exact).abs() - tol).max())
                    if not over <= 0 or not bool(torch.isfinite(res).all()):
                        raise AssertionError(
                            f"{what_at}: {what} is {over:.3e} beyond the f32 "
                            "summation bound")
                if not torch.equal(qm.w8a16_2d_cuda(x, values, scale, bn, bk),
                                   got):
                    raise AssertionError(f"{what_at}: two calls differ")
                if not torch.equal(by_bk.setdefault(bk, got), got):
                    raise AssertionError(
                        f"{what_at}: differs from another block_n at the "
                        "same block_k")
                for row in sorted({0, b // 2, b - 1}):
                    alone = qm.w8a16_2d_cuda(x[row:row + 1].contiguous(),
                                             values, scale, bn, bk)
                    if not torch.equal(alone[0], got[row]):
                        raise AssertionError(
                            f"{what_at}: row {row} alone differs from the row "
                            "inside the batch")
                if len(tiles) > 1:
                    qm.w8a16_2d_cuda(x, values, scale,
                                     *tiles[(i + 1) % len(tiles)])
                    if not torch.equal(
                            qm.w8a16_2d_cuda(x, values, scale, bn, bk), got):
                        raise AssertionError(
                            f"{what_at}: differs after a launch with another "
                            "tile")
                checks.append({
                    "shape": name, "K": k, "N": n, "B": b, "block_n": bn,
                    "block_k": bk,
                    "max_abs_err": float((got - want).abs().max()),
                    "tol_max": float(tol.max())})
        torch.cuda.synchronize()
        log("probecheck " + json.dumps({
            "shape": name, "tiles": tiles, "rows": list(QUANT_B_CHECK),
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["shape"] == name)}))
        del values, wd, wd_abs, exact, tol

    # (b) the entry point, counted
    runs, launches = {}, 0
    for b in PROBE_BATCHES:
        qm.w8a16_2d_cuda.launches = 0
        runs[b] = probe.run(batch=b, reps=PROBE_REPS, device=dev)
        count = qm.w8a16_2d_cuda.launches
        if count == 0:
            raise AssertionError(f"the probe at batch {b} never launched #19")
        launches += count
        for name, _, _ in probe.SHAPES:
            log("matvecprobe " + json.dumps({
                "batch": b, "shape": name, "us": {
                    r["arm"]: round(r["us"], 3) for r in runs[b]
                    if r["shape"] == name}}))

    # (c) the kernels line
    k, n, bn, bk, b = PROBE_MAIN
    copies = max(2, -(-2 * L2_BYTES // (k * n)) + 1)
    weights = torch.randint(-127, 128, (copies, k, n), dtype=torch.int8,
                            device=dev, generator=g)
    w16 = weights.bfloat16()
    scale = torch.rand((1, n), device=dev, generator=g) * 0.01 + 0.001
    x = torch.randn((b, k), device=dev, generator=g).bfloat16()
    w0 = weights[0]
    got = qm.w8a16_2d_cuda(x, w0, scale, bn, bk)
    turn = [0]

    def cycle(fn, ws):
        def run():
            turn[0] = (turn[0] + 1) % copies
            return fn(ws[turn[0]])
        return run

    geo = qm.tile2d_geometry(b, k, n, bk)
    main = {
        "K": k, "N": n, "B": b, "block_n": bn, "block_k": bk,
        "blocks": geo.blocks, "strip": qm._TILE2D_STRIP,
        "k_chunk": geo.k_chunk, "run": geo.run,
        "ms": cuda_queued_ms(cycle(
            lambda w: qm.w8a16_2d_cuda(x, w, scale, bn, bk), weights)),
        "plain_ms": cuda_queued_ms(cycle(
            lambda w: qm.w8a16_2d_plain(x, w, scale, bk), weights)),
        "w8a16_splitk_ms": cuda_queued_ms(cycle(
            lambda w: qm.w8a16_splitk_cuda(x, w, scale), weights)),
        "library_ms": cuda_queued_ms(cycle(
            lambda w: torch.matmul(x, w) * scale, w16)),
        **roofline(_nbytes(x, w0, scale, got), 2.0 * b * k * n, "bf16"),
    }
    log("probekernel " + json.dumps(main))
    del weights, w16, w0
    qm._TILE2D_SCRATCH.clear()  # 1 GB after the lm_head at 256 rows
    torch.cuda.empty_cache()
    for fn in list(qm.KERNELS.values()) + [qm.w8a16_2d_cuda]:
        fn.launches = 0
    return {"checks": checks, "runs": runs, "launches": launches,
            "main": main,
            "max_abs_err": max(c["max_abs_err"] for c in checks)}


# -- phase 11: quantized Llama-3.2-1B generation, served -----------------------

GEN_TOKENS = 64          # n_predict of every greedy request
GEN_MAX_LEN = 2048
# sequential requests, then GEN_PER_CLIENT from each of GEN_CLIENTS
# concurrent clients (6 and 2 until the evaluate phase needed the time, 4
# and 1 until the parallel phase did)
GEN_SEQ, GEN_CLIENTS, GEN_PER_CLIENT = 3, 8, 1
# bf16 compute through 16 layers: kernel and plain differ in the order of
# their f32 sums, which flips a bf16 rounding of an activation or of the
# residual stream here and there (one step is 2^-8 of the value), and a
# random-weight network amplifies such a flip from layer to layer. Read on
# the H100 over three weight seeds (--gen-readings 0 1 2), each over
# 9 x 11 x 128,256 logits of standard deviation 1.0: the largest difference
# is 0.058 / 0.061 / 0.061 (mean 0.008) in bf16, and 0.021 / 0.020 / 0.021
# (mean 0.003) with f32 compute, where only the activations entering a
# quantized product are rounded to bf16. Each limit is twice the largest
# reading.
GEN_LOGIT_TOL = 0.12
GEN_LOGIT_TOL_F32 = 0.04
# teacher-forced batches: one row, two, up to four and a partly filled group
# of eight rows each reach another instantiation of the kernels
GEN_CHECK_BATCHES = (1, 2, 3, 5)
GEN_CHECK_STEPS = 8
# Greedy streams of different routes (other row counts in the prefill's
# library products and in attention), and of a served group replayed with the
# plain versions, may part only at a near tie: the token taken instead lies
# less than GEN_NEAR_TIE under the best logit of a forward over the
# reference's tokens so far. Where each parts, and the gap there, is printed.
# The same three readings and a run of the whole script: 22 of 31, 13 of
# 32, 14 of 32 and 22 of 32 compared streams part within their 64 tokens (a
# random model's logits are flat, and a typical difference between routes
# is 0.01); the largest gap is 0.028 / 0.014 / 0.030 / 0.043. GEN_NEAR_TIE
# is twice the largest gap; the allowed share of parting streams lies above
# the largest share read (0.71).
GEN_NEAR_TIE = 0.09
GEN_NEAR_TIE_SHARE = 0.9
GEN_ROUTE_PROMPTS = 2    # prompts whose device and speculative loops are
                         # compared (4 until the evaluate phase, 3 until the
                         # train phase needed the time)
DECODE_STEPS = 16        # timed decode forwards per batch size (32 until
                         # the parallel phase needed the time)
# served groups replayed in process, with kernels and with plain versions:
# the largest group the server formed (2 rows or more). Every group was
# replayed until the evaluate phase needed the time.
GEN_REPLAY_GROUPS = 1


def word_tokenizer():
    """A ByteTokenizer whose decode also shows the ids past the byte range
    (as WORDS): random weights over a 128,256-token vocabulary emit hardly
    any byte id, and an empty text is no answer."""
    from persian_rag_tpu_torch.gen.generator import ByteTokenizer

    class WordTokenizer(ByteTokenizer):
        def decode(self, ids):
            return " ".join(WORDS[i % len(WORDS)] for i in ids if i >= 258)

    return WordTokenizer()


def gen_prompt(rng: np.random.Generator, n_words: int = 40) -> str:
    """A seeded Persian prompt of a few hundred bytes whose second half
    repeats the first (a RAG answer quotes its context)."""
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n_words // 2)]
    return "پرسش: " + " ".join(words + words)


def _gen_client(url: str, jobs) -> list:
    """One closed-loop client of the generation server (a pool process):
    POST each (path, payload) in turn. Returns [(response, seconds)]."""
    out = []
    for path, payload in jobs:
        t = time.perf_counter()
        resp = _post(url + path, payload)
        out.append((resp, time.perf_counter() - t))
    return out


def _stream_frames(url: str, payload: dict) -> list:
    req = urllib.request.Request(
        url + "/completion", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if not resp.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError("a streamed completion is not an event stream")
        body = resp.read()
    return [json.loads(f[6:]) for f in body.split(b"\n\n")
            if f.startswith(b"data: ")]


def _quant_counts(qm) -> dict:
    return {name: fn.launches for name, fn in qm.KERNELS.items()}


def _quant_reset(qm) -> None:
    for fn in qm.KERNELS.values():
        fn.launches = 0


def _teacher_forced(gen, prompts, tokens=None, steps=GEN_CHECK_STEPS):
    """Logits (1 + steps, B, V) of a prefill of B equally long prompts and
    of `steps` decode forwards, and the (steps, B) tokens fed to them:
    `tokens`, or each row's own greedy choice."""
    from persian_rag_tpu_torch.models.decoder import init_cache

    b, length, dev = len(prompts), len(prompts[0]), gen.device
    cache = init_cache(gen.config, b, gen.max_len, dev)
    logits, _ = gen.model(
        gen._ints([list(p) for p in prompts]),
        positions=torch.arange(length, device=dev)[None, :].expand(b, length),
        cache=cache, cache_pos=0, last_positions=gen._ints([length - 1] * b))
    rows, fed = [logits[:, 0].float()], []
    for i in range(steps):
        fed.append(tokens[i] if tokens is not None else rows[-1].argmax(-1))
        logits, _ = gen.model(
            fed[-1][:, None], positions=gen._ints([[length + i]] * b),
            cache=cache, cache_pos=length + i)
        rows.append(logits[:, -1].float())
    return torch.stack(rows), torch.stack(fed)


def _kernels_vs_plain(gen, qm, prompt_ids, tol: float) -> dict:
    """Teacher-forced logits with the kernels and with their plain versions
    in their place, at every batch of GEN_CHECK_BATCHES: the largest
    difference per batch, each within `tol`."""
    out = {}
    for b in GEN_CHECK_BATCHES:
        length = min(len(p) for p in prompt_ids[:b])
        prompts = [p[:length] for p in prompt_ids[:b]]
        with_kernels, fed = _teacher_forced(gen, prompts)
        saved = dict(qm.KERNELS)
        qm.KERNELS.update(qm.PLAIN)
        try:
            with_plain, _ = _teacher_forced(gen, prompts, fed)
        finally:
            qm.KERNELS.update(saved)
        if not bool(torch.isfinite(with_kernels).all()):
            raise AssertionError("non-finite logits")
        want = (1 + GEN_CHECK_STEPS, b, gen.config.vocab_size)
        if with_kernels.shape != want:
            raise AssertionError(f"logits shape {tuple(with_kernels.shape)}")
        diff = (with_kernels - with_plain).abs()
        out[f"batch{b}"] = {
            "max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "same_argmax": float((with_kernels.argmax(-1)
                                  == with_plain.argmax(-1)).float().mean()),
            "logit_std": float(with_kernels.std())}
        if not out[f"batch{b}"]["max_abs_err"] <= tol:
            raise AssertionError(
                f"kernel and plain logits differ by "
                f"{out[f'batch{b}']['max_abs_err']:.3e} (> {tol}) at batch {b}")
    out["max_abs_err"] = max(v["max_abs_err"] for v in out.values())
    out["tol"] = tol
    return out


def _near_tie(gen, prompt_ids, ref, other, limit=None) -> dict:
    """Where `other` leaves `ref`: the step, and how far the token `other`
    took there lies under the best logit of a forward over the prompt and
    ref's tokens so far (`gap`); a near tie when under `limit` (default
    GEN_NEAR_TIE)."""
    limit = GEN_NEAR_TIE if limit is None else limit
    i = next((j for j, (a, b) in enumerate(zip(ref, other)) if a != b), None)
    if i is None:  # one is a prefix of the other: they must be equal
        return {"step": min(len(ref), len(other)), "gap": None, "ok": False}
    ids = torch.tensor([list(prompt_ids) + list(ref[:i])], device=gen.device)
    logits = gen.model(ids, last_positions=torch.tensor(
        [ids.shape[1] - 1], device=gen.device))[0, 0].float()
    gap = float(logits.max() - logits[other[i]])
    return {"step": i, "gap": gap, "ok": gap < limit}


def _same_or_near_tie(gen, prompt_ids, ref, other, what: str, limit=None):
    """"equal", or where `other` leaves `ref` at a near tie; raises when it
    leaves it anywhere else."""
    if other == ref:
        return "equal"
    at = _near_tie(gen, prompt_ids, ref, other, limit)
    if not at.pop("ok"):
        raise AssertionError(
            f"{what}'s greedy stream leaves its reference away from a near "
            f"tie ({at}): {other} vs {ref}")
    return at


# the symbols of the port's quantized matmul kernels, one a kernel (#14,
# #17 and #18 run one body under a symbol each), as the profiler names them
QUANT_KERNEL_SYMBOLS = {"w8a16": "prt_w8a16_kernel",
                        "w8a16_nt": "w8a16_nt_mma_kernel",
                        "w8a16_splitk": "prt_w8a16_splitk_kernel",
                        "w4a16": "prt_w4a16_kernel",
                        "w8a16_2d": "w8a16_tile2d_kernel",
                        "w8a8": "w8a8_mma_kernel"}


def _decode_profile(gen, steps: int = 16):
    """Device time by kernel over `steps` batch-1 decode forwards, from
    torch.profiler; None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    _, cache = gen._prefill(list(range(1, 17)))
    gen._step(5, 16, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            gen._step(5, 17 + i, cache)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    total = sum(ms for _, ms, _ in rows)
    if total <= 0:
        return None
    by_kernel = {name: sum(ms for key, ms, _ in rows if sym in key) / steps
                 for name, sym in QUANT_KERNEL_SYMBOLS.items()}
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": steps, "wall_ms_profiled": wall_ms, "device_ms": total,
        "device_ms_per_step": total / steps,
        "quant_kernel_ms_per_step": sum(by_kernel.values()),
        "quant_kernel_ms_per_step_by_kernel": by_kernel,
        "device_busy_share_profiled": total / wall_ms,
        "top": [{"name": key[:60], "ms_per_step": ms / steps,
                 "calls_per_step": n / steps} for key, ms, n in rows[:8]],
    }


@torch.no_grad()
def gen_phase(qm, dev, pool, RetrievalServer, retriever=None) -> dict:
    """Deployment G: TextGenerator at the full width of Llama-3.2-1B (random
    int8 weights from the seed, bf16 compute, max_len 2048) behind
    LocalGenerationServer(max_batch=8), in process and over HTTP, and /rag
    through LlamaClient on `retriever` (a small BM25 system when None)."""
    from persian_rag_tpu_torch.gen.client import LlamaClient
    from persian_rag_tpu_torch.gen.generator import TextGenerator
    from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig, init_cache, random_quantized_params)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg = DecoderConfig.llama32_1b(compute_dtype=torch.bfloat16,
                                   quantized_weights=True)
    layers = cfg.num_layers
    params = random_quantized_params(cfg, seed=SEED, device=dev)
    gen = TextGenerator(cfg, params=params, tokenizer=word_tokenizer(),
                        max_len=GEN_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(
        t.numel() * t.element_size()
        for t in list(gen.model.parameters()) + list(gen.model.buffers()))
    int8_bytes = sum(t.numel() for t in gen.model.buffers()
                     if t.dtype == torch.int8)
    cache8 = init_cache(cfg, 8, GEN_MAX_LEN, dev)
    cache_bytes = sum(t.numel() * t.element_size()
                      for name in cache8 for t in cache8[name])
    del cache8
    out = {"build_s": time.perf_counter() - t0, "weight_bytes": weight_bytes,
           "int8_weight_bytes": int8_bytes, "cache_bytes_batch8": cache_bytes,
           "step_byte_bound_ms": 1e3 * int8_bytes / HBM_BYTES_PER_S}

    rng = np.random.default_rng(SEED + 4)
    prompts = [gen_prompt(rng, int(n)) for n in rng.integers(24, 48, size=8)]
    prompt_ids = [gen.tokenizer.encode(p) for p in prompts]
    ids0 = prompt_ids[0]
    out["prompt_tokens"] = [len(p) for p in prompt_ids]

    # kernels against plain: logits of a prefill and eight decode steps at
    # every batch of GEN_CHECK_BATCHES, in bf16 and with f32 compute over the
    # same int8 weights
    out["kernel_vs_plain_logits"] = _kernels_vs_plain(
        gen, qm, prompt_ids, GEN_LOGIT_TOL)
    cfg32 = DecoderConfig.llama32_1b(compute_dtype=torch.float32,
                                     quantized_weights=True)
    gen32 = TextGenerator(cfg32, params=params, tokenizer=word_tokenizer(),
                          max_len=GEN_MAX_LEN, device=dev)
    out["kernel_vs_plain_logits_f32"] = _kernels_vs_plain(
        gen32, qm, prompt_ids, GEN_LOGIT_TOL_F32)
    del gen32

    # the greedy routes against the per-step host loop, prompt by prompt
    # (the first GEN_ROUTE_PROMPTS prompts; the batch route runs all eight
    # and its first GEN_ROUTE_PROMPTS rows are compared: the host loop of
    # the other four took 6 s the evaluate phase needed)
    _quant_reset(qm)
    refs = [gen.generate_ids(ids0, max_tokens=GEN_TOKENS)]
    host_launches = _quant_counts(qm)
    refs += [gen.generate_ids(p, max_tokens=GEN_TOKENS)
             for p in prompt_ids[1:GEN_ROUTE_PROMPTS]]
    if any(len(r) != GEN_TOKENS for r in refs):
        raise AssertionError(f"a greedy stream stopped early: {refs}")
    streams = {}
    for i in reversed(range(GEN_ROUTE_PROMPTS)):
        streams[f"device{i}"] = (i, gen.generate_ids_device(
            prompt_ids[i], max_tokens=GEN_TOKENS, speculative=False))
        streams[f"spec{i}"] = (i, gen.generate_ids_spec(
            prompt_ids[i], max_tokens=GEN_TOKENS))
    spec_stats = dict(gen.last_spec_stats)  # of prompt 0, the last run
    spec0 = streams["spec0"][1]
    for i, row in enumerate(gen.generate_batch_device(
            prompt_ids, max_tokens=GEN_TOKENS)[:GEN_ROUTE_PROMPTS]):
        streams[f"batch_row{i}"] = (i, row)
    near = {name: _same_or_near_tie(gen, prompt_ids[i], refs[i], stream,
                                    f"the {name} route")
            for name, (i, stream) in streams.items()}
    out["greedy_routes"] = {k: v for k, v in near.items() if v != "equal"}
    out["route_streams"] = len(near)
    out["spec"] = spec_stats

    # timings in process: prefill, decode forwards at batch 1 and 8, loops
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    _, prefill_s = timed(lambda: gen._prefill(ids0))
    out["prefill_ms"] = {"tokens": len(ids0), "ms": 1e3 * prefill_s}
    for b in (1, 8):
        cache = init_cache(cfg, b, GEN_MAX_LEN, dev)
        tok = torch.full((b, 1), 5, dtype=torch.long, device=dev)

        def forwards(start, n):
            for i in range(n):
                pos = torch.full((b, 1), start + i, dtype=torch.long, device=dev)
                gen.model(tok, positions=pos, cache=cache, cache_pos=start + i)

        forwards(0, 4)
        _quant_reset(qm)
        _, s = timed(lambda: forwards(4, DECODE_STEPS))
        counts = _quant_counts(qm)
        # per layer q, k, v, o, gate, up -> #14 and down -> #17; lm_head -> #15
        if (counts["w8a16"], counts["w8a16_nt"], counts["w8a16_splitk"]) != (
                6 * layers * DECODE_STEPS, DECODE_STEPS, layers * DECODE_STEPS):
            raise AssertionError(f"launches per decode forward: {counts}")
        out[f"decode_forward_ms_batch{b}"] = 1e3 * s / DECODE_STEPS
        del cache
    _, host_s = timed(lambda: gen.generate_ids(ids0, max_tokens=GEN_TOKENS))
    _, spec_s = timed(lambda: gen.generate_ids_spec(ids0, max_tokens=GEN_TOKENS))
    _, batch_s = timed(lambda: gen.generate_batch_device(
        prompt_ids, max_tokens=GEN_TOKENS))
    out["tokens_per_s"] = {
        "host_loop": GEN_TOKENS / host_s, "spec_loop": GEN_TOKENS / spec_s,
        "batch8": 8 * GEN_TOKENS / batch_s}
    try:
        out["decode_profile"] = _decode_profile(gen)
    except Exception as e:  # the profiler is a reading aid, not a check
        out["decode_profile"] = None
        log(f"gen DECODE PROFILE FAILED: {e!r}")
    if out["decode_profile"] is None:
        log("gen DECODE PROFILE MISSING: this run has no device time per "
            "decode step; figures quoted from a profile are another run's")

    # served
    if retriever is None:
        from persian_rag_tpu_torch.retrieval.system import RetrievalSystem

        retriever = RetrievalSystem(method="bm25", device="cuda")
        retriever.load_chunks_and_index(make_chunks(2000, rng))
    completion = lambda p: ("/completion", {
        "prompt": p, "n_predict": GEN_TOKENS, "temperature": 0.0})
    more = [gen_prompt(rng, int(n)) for n in rng.integers(
        24, 48, size=GEN_SEQ + GEN_CLIENTS * GEN_PER_CLIENT)]
    server = LocalGenerationServer(gen, max_batch=8, max_wait_ms=10.0)
    groups = []  # (prompts, options, answers) of the server's greedy groups

    def recording(prompts_ids, **options):
        answers = TextGenerator.generate_batch_device(gen, prompts_ids,
                                                      **options)
        if len(prompts_ids) > 1 and options.get("temperature", 0.0) <= 0.0:
            groups.append(([list(p) for p in prompts_ids], options, answers))
        return answers

    gen.generate_batch_device = recording
    _quant_reset(qm)
    with server as url:
        health = json.loads(urllib.request.urlopen(url + "/health",
                                                   timeout=60).read())
        if health != {"status": "ok"}:
            raise AssertionError(f"/health answered {health}")
        seq = pool.apply(_gen_client, (url, [completion(prompts[0])] + [
            completion(p) for p in more[:GEN_SEQ - 1]]))
        t_conc = time.perf_counter()
        conc = pool.starmap(_gen_client, [
            (url, [completion(p) for p in more[GEN_SEQ - 1 + c::GEN_CLIENTS]
                   ][:GEN_PER_CLIENT]) for c in range(GEN_CLIENTS)])
        conc_s = time.perf_counter() - t_conc
        frames = _stream_frames(url, {**completion(prompts[0])[1],
                                      "stream": True})
        chat = _post(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts[1]}],
            "max_tokens": GEN_TOKENS})
        emb = np.asarray(_post(url + "/embedding",
                               {"content": prompts[2]})["embedding"])
        served_launches = _quant_counts(qm)
        client = LlamaClient(url)
        with RetrievalServer(retriever, llama_client=client) as api:
            t = time.perf_counter()
            rag = _post(api.url + "/rag", {"question": "دارو برای درمان قلب",
                                           "top_k": 5})
            rag_s = time.perf_counter() - t
        info = client.get_server_info()
    del gen.generate_batch_device
    rag_launches = {k: v - served_launches[k]
                    for k, v in _quant_counts(qm).items()}
    if server.errors:
        raise AssertionError("the generation server failed a group:\n"
                             + "\n".join(server.error_log))
    # a lone greedy request takes the speculative loop: the same stream
    # as in process, run after run
    if seq[0][0] != {"content": gen.tokenizer.decode(spec0)}:
        raise AssertionError("the served answer is not the greedy stream")
    answers = [r for r, _ in seq] + [r for rows in conc for r, _ in rows]
    # an early EOS may cut an answer short, a failed group would empty all
    empty = sum(1 for a in answers if not a["content"])
    if not all(isinstance(a.get("content"), str) for a in answers) or (
            empty > 0.1 * len(answers)):
        raise AssertionError(f"{empty} of {len(answers)} answers are empty")
    # a fixed sample of the groups of 2..8 requests the server formed (the
    # largest first): the same call in process repeats its answers, and
    # with the plain versions in the kernels' place each row is equal or
    # parts at a near tie
    replayed = {}
    saved = dict(qm.KERNELS)
    sample = sorted(range(len(groups)), key=lambda g: -len(groups[g][0])
                    )[:GEN_REPLAY_GROUPS]
    t_replay = time.perf_counter()
    for g in sample:
        group, options, served = groups[g]
        if gen.generate_batch_device(group, **options) != served:
            raise AssertionError(f"served group {g} of {len(group)} does not "
                                 "repeat in process")
        qm.KERNELS.update(qm.PLAIN)
        try:
            plain_rows = gen.generate_batch_device(group, **options)
        finally:
            qm.KERNELS.update(saved)
        for r, (ids, ours, plain) in enumerate(zip(group, served, plain_rows)):
            replayed[f"group{g}_of{len(group)}_row{r}"] = _same_or_near_tie(
                gen, ids, ours, plain, f"served group {g} row {r} with plain")
    replay_s = time.perf_counter() - t_replay
    contents = {a["content"] for a in answers}
    if not groups or any(gen.tokenizer.decode(row) not in contents
                         for _, _, served in groups for row in served):
        raise AssertionError(
            "the concurrent clients formed no group, or a group's answer "
            f"reached no client (groups of {[len(g[0]) for g in groups]})")
    near.update(replayed)
    parted = {k: v for k, v in near.items() if v != "equal"}
    if len(parted) > GEN_NEAR_TIE_SHARE * len(near):
        raise AssertionError(
            f"{len(parted)} of {len(near)} compared greedy streams part at a "
            f"near tie (allowed: {GEN_NEAR_TIE_SHARE}): {parted}")
    out["served_groups"] = {
        "sizes": [len(group) for group, _, _ in groups],
        "replayed": sample, "replay_s": replay_s,
        "parted_with_plain": {k: v for k, v in replayed.items()
                              if v != "equal"}}
    out["near_tie_streams"] = {"parted": len(parted), "compared": len(near),
                               "allowed_share": GEN_NEAR_TIE_SHARE}
    streamed = "".join(f["content"] for f in frames)
    if not frames or frames[-1]["stop"] is not True or (
            streamed != seq[0][0]["content"]):
        raise AssertionError("the streamed completion differs from the plain one")
    if not chat["choices"][0]["message"]["content"]:
        raise AssertionError(f"/v1/chat/completions answered {chat}")
    if emb.shape != (cfg.hidden_size,) or abs(np.linalg.norm(emb) - 1) > 1e-3:
        raise AssertionError("/embedding is not a unit vector of hidden size")
    if not rag.get("contexts") or not isinstance(rag.get("answer"), str):
        raise AssertionError(f"/rag answered {rag}")
    if "/completion" not in info["endpoints"]:
        raise AssertionError(f"server info {info}")
    for counts in (served_launches, rag_launches):
        if not (counts["w8a16_splitk"] > 0
                and counts["w8a16"] == 6 * counts["w8a16_splitk"]
                and counts["w8a16_splitk"] % layers == 0
                and counts["w8a16_nt"] >= counts["w8a16_splitk"] // layers):
            raise AssertionError(
                f"served launches are not {6 * layers} : 1 : {layers} per "
                f"forward: {counts}")
    seq_ms = [1e3 * t for _, t in seq]
    conc_ms = [1e3 * t for rows in conc for _, t in rows]
    out.update({
        "served": {
            "seq_requests": len(seq_ms), "seq_p50_ms": _percentile(seq_ms, 50),
            "seq_p90_ms": _percentile(seq_ms, 90),
            "conc_requests": len(conc_ms),
            "conc_p50_ms": _percentile(conc_ms, 50),
            "conc_p90_ms": _percentile(conc_ms, 90),
            "conc_tokens_per_s": GEN_TOKENS * len(conc_ms) / conc_s,
            "stream_frames": len(frames), "rag_s": rag_s,
            "rag_answer_chars": len(rag["answer"]),
            "errors": server.errors},
        "host_loop_launches": host_launches,
        "served_launches": served_launches, "rag_launches": rag_launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() - mem0,
    })
    log("gen " + json.dumps(out))
    out["launches"] = {k: served_launches[k] + rag_launches[k]
                       for k in served_launches}
    return out



# -- phase 12: deployment H, int4 Llama-3.2-1B behind continuous batching ----

H_SEGMENT = 32
# served requests replayed in process, with kernels and with plain versions:
# a fixed sample spread evenly over the served order, first and last
# included. Every request was replayed until the evaluate phase needed the
# time, 4 until the train phase did.
H_REPLAY_REQUESTS = 2
# Limits of H, read as G's are (--gen-readings 0 1 2 on the H100; PERF.md
# section 6). Teacher-forced logits (std 1.0), kernels against plain, differ
# by at most 0.0051 / 0.0083 / 0.0063 in bf16 and 0.0010 / 0.0018 / 0.0019
# with f32 compute over weight seeds 0 / 1 / 2: each limit is twice the
# largest reading. No compared stream parted (0 of 31 per seed), so no gap
# was read: a parting is a near tie only under the logit limit itself (a gap
# the kernels-vs-plain difference can close), and a tenth of the streams
# may part.
H_LOGIT_TOL = 0.017
H_LOGIT_TOL_F32 = 0.004
H_NEAR_TIE = H_LOGIT_TOL
H_NEAR_TIE_SHARE = 0.1
# Llama-3.2-1B: its 16 layers' projections packed int4, its tied embedding
# int8 (the bytes a decode forward must stream at least once)
H_LAYER_BYTES, H_EMBED_BYTES = 486_539_264, 262_668_288


def _batcher_streams(gen, prompts_ids, speculative=False) -> list:
    """Greedy streams of GEN_TOKENS tokens of `prompts_ids`, all submitted
    at once to one ContinuousBatcher of 8 rows."""
    from persian_rag_tpu_torch.gen.continuous import ContinuousBatcher

    cb = ContinuousBatcher(gen, batch=8, segment=H_SEGMENT,
                           speculative=speculative)
    ids = [cb.submit(p, max_tokens=GEN_TOKENS) for p in prompts_ids]
    done = {r.req_id: r.tokens for r in cb.run_until_drained()}
    return [done[i] for i in ids]


def _segment_profile(gen, prompts_ids, forwards: int = 16):
    """Host and device time by operation over one segment of `forwards`
    one-token forwards of a ContinuousBatcher with 8 live rows, from
    torch.profiler; None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from persian_rag_tpu_torch.gen.continuous import ContinuousBatcher

    cb = ContinuousBatcher(gen, batch=8, segment=forwards)
    for p in prompts_ids[:8]:
        cb.submit(p, max_tokens=3 * forwards)
    cb.step()  # admits the 8 rows, then a segment untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cb.step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, us / 1e3, evt.self_cpu_time_total / 1e3,
                     evt.count))
    device = sum(r[1] for r in rows)
    if device <= 0:
        return None

    def top(i):
        return [{"name": key[:60], "ms_per_forward": ms[i - 1] / forwards,
                 "calls_per_forward": n / forwards}
                for key, *ms, n in sorted(rows, key=lambda r: -r[i])[:8]]

    return {"forwards": forwards,
            "wall_ms_per_forward_profiled": wall_ms / forwards,
            "device_ms_per_forward": device / forwards,
            "host_self_ms_per_forward": sum(r[2] for r in rows) / forwards,
            "device_busy_share_profiled": device / wall_ms,
            "top_device": top(1), "top_host": top(2)}


@torch.no_grad()
def h_phase(qm, dev, pool, g_served=None) -> dict:
    """Deployment H: TextGenerator at the full width of Llama-3.2-1B with
    int4 layer weights (random from the seed; the tied embedding and lm_head
    int8 on #15; bf16 compute and cache, max_len 2048) behind
    LocalGenerationServer(continuous=True, max_batch=8, segment=32), under
    G's traffic. `g_served`: G's served numbers from the same call, printed
    beside H's."""
    from persian_rag_tpu_torch.gen.continuous import ContinuousBatcher
    from persian_rag_tpu_torch.gen.generator import TextGenerator
    from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig, init_cache, random_quantized_params)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    def config(dtype):
        return DecoderConfig.llama32_1b(compute_dtype=dtype,
                                        quantized_weights=True,
                                        quantized_bits=4)

    cfg = config(torch.bfloat16)
    layers = cfg.num_layers
    params = random_quantized_params(cfg, seed=SEED, device=dev)
    gen = TextGenerator(cfg, params=params, tokenizer=word_tokenizer(),
                        max_len=GEN_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    layer_bytes = sum(t.numel() for name, t in gen.model.named_buffers()
                      if name.startswith("layers.") and t.dtype == torch.int8)
    embed_bytes = gen.model.embed_tokens.values.numel()
    if (layer_bytes, embed_bytes) != (H_LAYER_BYTES, H_EMBED_BYTES):
        raise AssertionError(f"H streams {layer_bytes} int4 layer bytes and "
                             f"{embed_bytes} int8 embedding bytes")
    out = {"build_s": time.perf_counter() - t0,
           "layer_int4_bytes": layer_bytes, "embed_int8_bytes": embed_bytes,
           "step_byte_bound_ms":
               1e3 * (layer_bytes + embed_bytes) / HBM_BYTES_PER_S}

    rng = np.random.default_rng(SEED + 4)  # G's prompts
    prompts = [gen_prompt(rng, int(n)) for n in rng.integers(24, 48, size=8)]
    prompt_ids = [gen.tokenizer.encode(p) for p in prompts]
    out["prompt_tokens"] = [len(p) for p in prompt_ids]

    # kernels against plain: logits of a prefill and eight decode steps at
    # every batch of GEN_CHECK_BATCHES, bf16 and f32 compute, same weights
    out["kernel_vs_plain_logits"] = _kernels_vs_plain(
        gen, qm, prompt_ids, H_LOGIT_TOL)
    gen32 = TextGenerator(config(torch.float32), params=params,
                          tokenizer=word_tokenizer(), max_len=GEN_MAX_LEN,
                          device=dev)
    out["kernel_vs_plain_logits_f32"] = _kernels_vs_plain(
        gen32, qm, prompt_ids, H_LOGIT_TOL_F32)
    del gen32

    # greedy streams in process: the batcher, plain and speculative, with
    # requests admitted while the first is decoding, against the
    # single-request device loop; the first row's stream must not change
    refs = [gen.generate_ids_device(p, max_tokens=GEN_TOKENS,
                                    speculative=False)
            for p in prompt_ids[:GEN_ROUTE_PROMPTS]]
    if any(len(r) != GEN_TOKENS for r in refs):
        raise AssertionError(f"a greedy stream stopped early: {refs}")
    alone = _batcher_streams(gen, prompt_ids[:1])[0]
    streams = {}
    for speculative in (False, True):
        cb = ContinuousBatcher(gen, batch=8, segment=H_SEGMENT,
                               speculative=speculative)
        first = cb.submit(prompt_ids[0], max_tokens=GEN_TOKENS)
        cb.step()
        # one speculative segment may finish it (up to 16 x 6 tokens)
        running = cb.request(first)
        if not speculative and not (
                running and 0 < len(running.tokens) < GEN_TOKENS):
            raise AssertionError("the first request is not mid-flight")
        rest = [cb.submit(p, max_tokens=GEN_TOKENS)
                for p in prompt_ids[1:GEN_ROUTE_PROMPTS]]
        done = {r.req_id: r.tokens for r in cb.run_until_drained()}
        tag = "spec" if speculative else "batcher"
        for i, rid in enumerate([first] + rest):
            streams[f"{tag}{i}"] = (i, done[rid])
        if speculative:
            stats = dict(cb.spec_stats)
            out["spec"] = {**stats, "tokens_per_forward":
                           stats["tokens"] / max(stats["forwards"], 1),
                           "tokens_per_row_forward":
                           stats["tokens"] / max(stats["row_forwards"], 1)}
    if streams["batcher0"][1] != alone:
        raise AssertionError("admitting requests mid-flight changed the "
                             "running row's stream")
    near = {name: _same_or_near_tie(gen, prompt_ids[i], refs[i], stream,
                                    f"H's {name}", H_NEAR_TIE)
            for name, (i, stream) in streams.items()}
    out["greedy_routes"] = {k: v for k, v in near.items() if v != "equal"}

    # decode forwards at batch 1 and 8: launches 112 : 1 per forward
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    for b in (1, 8):
        cache = init_cache(cfg, b, GEN_MAX_LEN, dev)
        tok = torch.full((b, 1), 5, dtype=torch.long, device=dev)

        def forwards(start, n):
            for i in range(n):
                pos = torch.full((b, 1), start + i, dtype=torch.long, device=dev)
                gen.model(tok, positions=pos, cache=cache, cache_pos=start + i)

        forwards(0, 4)
        _quant_reset(qm)
        _, s = timed(lambda: forwards(4, DECODE_STEPS))
        counts = _quant_counts(qm)
        want = {name: 0 for name in counts}
        want.update(w4a16=7 * layers * DECODE_STEPS, w8a16_nt=DECODE_STEPS)
        if counts != want:
            raise AssertionError(f"launches per decode forward: {counts}")
        out[f"decode_forward_ms_batch{b}"] = 1e3 * s / DECODE_STEPS
        del cache
    _, one_s = timed(lambda: _batcher_streams(gen, prompt_ids[:1]))
    _, eight_s = timed(lambda: _batcher_streams(gen, prompt_ids))
    out["tokens_per_s"] = {"batcher_1_request": GEN_TOKENS / one_s,
                           "batcher_8_requests": 8 * GEN_TOKENS / eight_s}
    try:
        out["segment_profile"] = _segment_profile(gen, prompt_ids)
    except Exception as e:  # the profiler is a reading aid, not a check
        out["segment_profile"] = None
        log(f"genH SEGMENT PROFILE FAILED: {e!r}")
    if out["segment_profile"] is None:
        log("genH SEGMENT PROFILE MISSING: this run has no breakdown of a "
            "batcher forward")

    # served: G's load through the continuous scheduler
    completion = lambda p: ("/completion", {
        "prompt": p, "n_predict": GEN_TOKENS, "temperature": 0.0})
    more = [gen_prompt(rng, int(n)) for n in rng.integers(
        24, 48, size=GEN_SEQ + GEN_CLIENTS * GEN_PER_CLIENT)]
    server = LocalGenerationServer(gen, max_batch=8, continuous=True,
                                   segment=H_SEGMENT)
    batcher = server._batcher
    served_rows = []  # (prompt ids, tokens) of every finished request
    drain = batcher.finished

    def recording():
        done = drain()
        served_rows.extend((list(r.prompt_ids), list(r.tokens)) for r in done)
        return done

    batcher.finished = recording
    _quant_reset(qm)
    with server as url:
        props = json.loads(urllib.request.urlopen(url + "/props",
                                                  timeout=60).read())
        seq = pool.apply(_gen_client, (url, [completion(prompts[0])] + [
            completion(p) for p in more[:GEN_SEQ - 1]]))
        t_conc = time.perf_counter()
        pending = pool.starmap_async(_gen_client, [
            (url, [completion(p) for p in more[GEN_SEQ - 1 + c::GEN_CLIENTS]
                   ][:GEN_PER_CLIENT]) for c in range(GEN_CLIENTS)])
        busiest, polls = 0, 0
        while not pending.ready():
            slots = json.loads(urllib.request.urlopen(url + "/slots",
                                                      timeout=60).read())
            busiest = max(busiest, sum(slot["state"] for slot in slots))
            polls += 1
            time.sleep(0.02)
        conc = pending.get()
        conc_s = time.perf_counter() - t_conc
        frames = _stream_frames(url, {**completion(prompts[0])[1],
                                      "stream": True})
    served_launches = _quant_counts(qm)
    if server.errors or server._batcher is not batcher:
        raise AssertionError("the continuous server failed a segment:\n"
                             + "\n".join(server.error_log))
    if props.get("continuous_batching") is not True:
        raise AssertionError(f"/props answered {props}")
    if busiest < 2:
        raise AssertionError(f"/slots never showed two busy rows ({polls} "
                             "polls during the concurrent load)")
    if seq[0][0] != {"content": gen.tokenizer.decode(alone)}:
        raise AssertionError("the served answer is not the batcher's stream")
    streamed = "".join(f["content"] for f in frames)
    if len(frames) < 2 or frames[-1]["stop"] is not True or (
            streamed != seq[0][0]["content"]):
        raise AssertionError("the streamed completion differs from the plain "
                             f"one ({len(frames)} frames)")
    answers = [r for r, _ in seq] + [r for rows in conc for r, _ in rows]
    empty = sum(1 for a in answers if not a["content"])
    if empty > 0.1 * len(answers):
        raise AssertionError(f"{empty} of {len(answers)} answers are empty")
    if len(served_rows) != len(answers) + 1:
        raise AssertionError(f"{len(served_rows)} requests finished, "
                             f"{len(answers) + 1} were sent")
    per_forward = 7 * layers
    if not (served_launches["w4a16"] > 0
            and served_launches["w4a16"] % per_forward == 0
            and served_launches["w8a16_nt"]
            >= served_launches["w4a16"] // per_forward
            and served_launches["w8a16"] == served_launches["w8a16_splitk"]
            == served_launches["w8a8"] == 0):
        raise AssertionError(f"served launches are not {per_forward} #18 : "
                             f"1 #15 per forward: {served_launches}")
    # a fixed sample of the served requests (H_REPLAY_REQUESTS spread over
    # the served order): the same batcher in process repeats its tokens,
    # and with the plain versions in the kernels' place each is equal or
    # parts at a near tie
    t_replay = time.perf_counter()
    sample = [int(i) for i in np.linspace(0, len(served_rows) - 1,
                                          H_REPLAY_REQUESTS).round()]
    served_rows = [served_rows[i] for i in sample]
    replay_ids = [p for p, _ in served_rows]
    if _batcher_streams(gen, replay_ids) != [t for _, t in served_rows]:
        raise AssertionError("served requests do not repeat in process")
    saved = dict(qm.KERNELS)
    qm.KERNELS.update(qm.PLAIN)
    try:
        plain = _batcher_streams(gen, replay_ids)
    finally:
        qm.KERNELS.update(saved)
    replayed = {
        f"served{sample[r]}": _same_or_near_tie(
            gen, ids, ours, theirs, f"served request {r} with plain",
            H_NEAR_TIE)
        for r, ((ids, ours), theirs) in enumerate(zip(served_rows, plain))}
    near.update(replayed)
    parted = {k: v for k, v in near.items() if v != "equal"}
    if len(parted) > H_NEAR_TIE_SHARE * len(near):
        raise AssertionError(
            f"{len(parted)} of {len(near)} compared greedy streams part at a "
            f"near tie (allowed: {H_NEAR_TIE_SHARE}): {parted}")
    out["parted_with_plain"] = {k: v for k, v in replayed.items()
                                if v != "equal"}
    out["replayed"] = {"requests": sample,
                       "seconds": time.perf_counter() - t_replay}
    out["near_tie_streams"] = {"parted": len(parted), "compared": len(near),
                               "allowed_share": H_NEAR_TIE_SHARE}
    seq_ms = [1e3 * t for _, t in seq]
    conc_ms = [1e3 * t for rows in conc for _, t in rows]
    out["served"] = {
        "seq_requests": len(seq_ms), "seq_p50_ms": _percentile(seq_ms, 50),
        "seq_p90_ms": _percentile(seq_ms, 90),
        "conc_requests": len(conc_ms),
        "conc_p50_ms": _percentile(conc_ms, 50),
        "conc_p90_ms": _percentile(conc_ms, 90),
        "conc_tokens_per_s": GEN_TOKENS * len(conc_ms) / conc_s,
        "busiest_slots": busiest, "slot_polls": polls,
        "stream_frames": len(frames), "errors": server.errors}
    if g_served is not None:
        out["g_served_same_call"] = {
            k: g_served[k] for k in ("seq_p50_ms", "seq_p90_ms",
                                     "conc_p50_ms", "conc_p90_ms",
                                     "conc_tokens_per_s")}
    out["served_launches"] = served_launches
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - mem0
    log("genH " + json.dumps(out))
    out["launches"] = served_launches
    return out


# -- phase 13: real-file deployments ----------------------------------------

# the loaded encoder's /search load (100 and 15 until the evaluate phase
# needed the time)
FILES_SEQ, FILES_PER_CLIENT = 60, 10
FILES_CHUNKS = 33_000  # of A's chunks, tokenized by the Python Unigram
# (50,000 until the evaluate phase needed the time; still past
# TWO_STAGE_MIN_N = 32,768, so the served index launches a stage-1 kernel)
FILES_PROMPTS = 5        # prompts of the logit check (the largest batch of
                         # GEN_CHECK_BATCHES)
FILES_SERVED = 3         # of them served in process and by gen-serve, whose
                         # greedy answers must be equal (8 until the evaluate
                         # phase needed the time)
FILES_EMB_TOL = 1e-5
UNIGRAM_VOCAB = 250_037                 # paraphrase-multilingual-MiniLM-L12-v2
LLAMA3_REGULAR = 128_000                # Llama 3: 128,000 BPE tokens + 256 specials
# Arabic forms to Persian, alef + madda composed, full-width digits: the
# kind of rules an XLM-R precompiled_charsmap holds
CHARSMAP_RULES = {
    "\u064a": "\u06cc", "\u0643": "\u06a9", "\u0627\u0653": "\u0622",
    **{chr(0xFF10 + i): str(i) for i in range(10)},
}
_HF_BERT = {
    "attention.query": "attention.self.query",
    "attention.key": "attention.self.key",
    "attention.value": "attention.self.value",
    "attention.output": "attention.output.dense",
    "attention_norm": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense",
    "ffn_output": "output.dense",
    "output_norm": "output.LayerNorm",
}


def hf_bert_state(state: dict) -> dict:
    """The port encoder's state dict under HF BertModel names."""
    out = {}
    for name, t in state.items():
        if name.startswith("embeddings."):
            out[name.replace("layer_norm", "LayerNorm")] = t
            continue
        _, i, rest = name.split(".", 2)
        module, leaf = rest.rsplit(".", 1)
        out[f"encoder.layer.{i}.{_HF_BERT[module]}.{leaf}"] = t
    return out


def write_safetensors(path: str, tensors: dict) -> None:
    """An F32 .safetensors file: the header length (u64), a JSON header
    with each tensor's shape and data offsets, then the data."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = 4 * t.numel()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().float().contiguous().cpu().numpy().tobytes())


def build_charsmap(rules: dict) -> bytes:
    """A sentencepiece precompiled_charsmap for {key: normalized}: a u32
    trie size, a double array (a block of 256 units per inner node,
    children at base ^ byte, the value unit at base ^ 0) and the
    NUL-ended normalized strings."""
    blob, offsets = b"", {}
    for key, norm in sorted(rules.items()):
        offsets[key] = len(blob)
        blob += norm.encode() + b"\0"
    trie: dict = {}
    for key in rules:
        node = trie
        for b in key.encode():
            node = node.setdefault(b, {})
        node[None] = offsets[key]
    units, blocks = {}, [1]

    def place(node, pos, label):
        base = 256 * blocks[0]
        blocks[0] += 1
        units[pos] = ((pos ^ base) << 10) | (int(None in node) << 8) | label
        if None in node:
            units[base] = (1 << 31) | node[None]
        for c, child in node.items():
            if c is not None:
                place(child, base ^ c, c)

    place(trie, 0, 0)
    arr = [0] * (256 * blocks[0])
    for p, u in units.items():
        arr[p] = u
    body = struct.pack(f"<{len(arr)}I", *arr)
    return struct.pack("<I", len(body)) + body + blob


def unigram_tokenizer_json(chunks) -> dict:
    """An XLM-R-shaped Unigram tokenizer.json of UNIGRAM_VOCAB pieces from
    the corpus: <s> <pad> </s> <unk>, then every word, word prefix and
    suffix and character, scored by log frequency, then pieces holding an
    inner '▁' (never a Metaspace pre-token) to the vocabulary's size."""
    import base64
    from collections import Counter

    words = Counter()
    for c in chunks:
        words.update(c["text"].split())
    words.update(f"{i}" for i in range(N_CORPUS))  # query serials
    words.update(WORDS + ["پرسش"])
    counts = Counter()
    for w, n in words.items():
        counts["▁" + w] += n
        for k in range(1, len(w)):
            counts["▁" + w[:k]] += n
            counts[w[k:]] += n
        for ch in w:
            counts[ch] += n
    counts["▁"] += 1
    total = sum(counts.values())
    pieces = [[p, math.log(n / total)] for p, n in counts.most_common()]
    pieces = pieces[:UNIGRAM_VOCAB - 4]
    floor = min(s for _, s in pieces) - 1.0
    i = 0
    while len(pieces) < UNIGRAM_VOCAB - 4:
        pieces.append([f"▁{i}▁", floor])
        i += 1
    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, t in enumerate(specials)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
                build_charsmap(CHARSMAP_RULES)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [], "special_tokens": {
                t: {"id": t, "ids": [i], "tokens": [t]}
                for t, i in (("<s>", 0), ("</s>", 2))}},
        "decoder": {"type": "Metaspace", "replacement": "▁",
                    "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 3, "byte_fallback": False,
                  "vocab": [[t, 0.0] for t in specials] + pieces},
    }


def write_sentence_transformer(path: str, enc, chunks) -> None:
    """A sentence-transformers directory of `enc` (model_type bert, F32
    safetensors under HF names, mean pooling) with a Unigram
    tokenizer.json."""
    c = enc.config
    os.makedirs(os.path.join(path, "1_Pooling"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "vocab_size": c.vocab_size,
                   "hidden_size": c.hidden_size,
                   "num_hidden_layers": c.num_layers,
                   "num_attention_heads": c.num_heads,
                   "intermediate_size": c.intermediate_size,
                   "max_position_embeddings": c.max_position_embeddings,
                   "type_vocab_size": c.type_vocab_size,
                   "layer_norm_eps": c.layer_norm_eps,
                   "hidden_act": c.hidden_act,
                   "pad_token_id": c.pad_token_id}, f)
    with open(os.path.join(path, "modules.json"), "w") as f:
        json.dump([{"idx": 0, "name": "0", "path": "",
                    "type": "sentence_transformers.models.Transformer"},
                   {"idx": 1, "name": "1", "path": "1_Pooling",
                    "type": "sentence_transformers.models.Pooling"}], f)
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": c.hidden_size,
                   "pooling_mode_mean_tokens": True}, f)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      hf_bert_state(enc.encoder.state_dict()))
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(unigram_tokenizer_json(chunks), f, ensure_ascii=False)


LLAMA3_SPECIALS = (
    ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
     "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
     "<|reserved_special_token_2|>", "<|start_header_id|>",
     "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
    + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])


def bpe_tokenizer_json(rng) -> dict:
    """A Llama-3-shaped byte-level BPE tokenizer.json of 128,256 entries:
    the 256 byte symbols, merges that join the frequent pre-tokens of
    seeded prompts left to right, Persian letter forms to LLAMA3_REGULAR
    entries, then the 256 Llama-3 special tokens."""
    import itertools
    from collections import Counter

    from persian_rag_tpu_torch.models.tokenizer_json import (
        BYTE_TO_CHAR, LLAMA3_PATTERN, llama3_split_re)

    def byte_level(text):
        return "".join(BYTE_TO_CHAR[b] for b in text.encode("utf-8"))

    freq = Counter()
    split = llama3_split_re()
    for _ in range(2_000):
        freq.update(split.findall(gen_prompt(rng, int(rng.integers(8, 48)))))
    vocab = {ch: i for i, ch in enumerate(BYTE_TO_CHAR.values())}
    merges: dict = {}
    for piece, _ in freq.most_common():
        symbols = list(byte_level(piece))
        while len(symbols) > 1:
            merged = symbols[0] + symbols[1]
            merges.setdefault(f"{symbols[0]} {symbols[1]}", None)
            vocab.setdefault(merged, len(vocab))
            symbols = [merged] + symbols[2:]
    forms = ("".join(p) for n in (2, 3, 4)
             for p in itertools.product(LETTERS, repeat=n))
    for form in forms:
        if len(vocab) >= LLAMA3_REGULAR:
            break
        for text in (" " + form, form):
            token = byte_level(text)
            if token not in vocab and len(vocab) < LLAMA3_REGULAR:
                vocab[token] = len(vocab)
    added = [{"id": LLAMA3_REGULAR + i, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, t in enumerate(LLAMA3_SPECIALS)]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<|begin_of_text|>",
                                         "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [], "special_tokens": {"<|begin_of_text|>": {
                "id": "<|begin_of_text|>", "ids": [LLAMA3_REGULAR],
                "tokens": ["<|begin_of_text|>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": list(merges)},
    }


def _start_gen_serve(gguf_path: str, *extra: str):
    """`python -m persian_rag_tpu_torch gen-serve --gguf <file> --port 0
    [extra...]` from this checkout; returns (process, url, seconds to its
    ready line)."""
    import queue
    import subprocess
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "persian_rag_tpu_torch", "gen-serve",
         "--gguf", gguf_path, "--port", "0", *extra],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    errors: list = []
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    threading.Thread(target=lambda: errors.extend(proc.stderr),
                     daemon=True).start()
    try:
        line = lines.get(timeout=300)
    except queue.Empty:
        line = ""
    if not line.startswith("generation server at "):
        proc.kill()
        proc.wait(timeout=60)
        raise AssertionError(f"gen-serve did not start: {line!r} "
                             f"{''.join(errors)[-3000:]}")
    return proc, line.split()[3], time.perf_counter() - t0


def files_phase(enc, chunks, rng, ft, qm, pool, RetrievalSystem,
                RetrievalServer) -> dict:
    """Deployments loaded from files written here (a temporary directory,
    deleted after): deployment A's encoder as a sentence-transformers
    directory with a Unigram tokenizer.json, loaded by
    RetrievalSystem(model_path=) and served over A's chunks; and a Q8_0
    GGUF of Llama-3.2-1B (seeded bf16 weights) with an embedded byte-level
    BPE tokenizer, loaded by TextGenerator.from_gguf in process and served
    by `gen-serve --gguf` in a subprocess."""
    from persian_rag_tpu_torch.gen.generator import TextGenerator
    from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig, cast_params, random_params)
    from persian_rag_tpu_torch.models.gguf import (
        GGUFTokenizer, tokenizer_metadata_from_hf, write_decoder_gguf)

    dev = enc.device
    out = {}
    with tempfile.TemporaryDirectory(prefix="prt_files_") as tmp:
        # the encoder, written and loaded
        st_dir = os.path.join(tmp, "minilm")
        t0 = time.perf_counter()
        write_sentence_transformer(st_dir, enc, chunks)
        out["encoder_write_s"] = time.perf_counter() - t0
        ft.extract_candidates_bf16_cuda.launches = 0
        ft.extract_candidates_bf16x2_cuda.launches = 0
        served, rs = serve_phase(
            None, chunks, rng, ft, RetrievalSystem, RetrievalServer, pool,
            model_path=st_dir, n_seq=FILES_SEQ, per_client=FILES_PER_CLIENT)
        loaded = rs.embedding_model
        texts = [c["text"] for c in chunks[:64]]
        ids, mask = loaded.tokenizer.encode_batch(texts, loaded.max_seq_len)
        err = float((loaded.forward_tokens(ids, mask)
                     - enc.forward_tokens(ids, mask)).abs().max())
        if not err <= FILES_EMB_TOL:
            raise AssertionError(f"the loaded encoder's embeddings differ "
                                 f"from A's by {err:.3e}")
        # the charsmap at work (the ids above are fed to both encoders):
        # Arabic yeh / kaf and full-width digits take the ids of the
        # Persian and ASCII forms, which the vocabulary holds
        ar = loaded.tokenizer.encode(
            "\u064a\u0643 \u0643\u062a\u0627\u0628 \uff11\uff12")
        if ar != loaded.tokenizer.encode(
                "\u06cc\u06a9 \u06a9\u062a\u0627\u0628 12"):
            raise AssertionError(f"the loaded tokenizer's charsmap did not "
                                 f"normalize Arabic forms: {ar}")
        if sum(served["launches"].values()) == 0:
            raise AssertionError("the loaded encoder's /search launched no "
                                 "stage-1 kernel")
        out["encoder"] = {**{k: served[k] for k in (
            "encoder_load_s", "index_build_s", "stage1_mode", "seq_p50_ms",
            "seq_p90_ms", "conc_p50_ms", "conc_p90_ms", "conc_qps",
            "near_tie_rows", "queries_checked", "launches")},
            "tokenize_ms_batch16": served["breakdown_ms"]["batch16"][
                "tokenize"],
            "total_ms_batch16": served["breakdown_ms"]["batch16"]["total"],
            "emb_max_abs_err": err,
            "vocab": loaded.tokenizer.vocab_size}
        rs.cleanup()
        del rs, loaded

        # the decoder: a Q8_0 GGUF with its tokenizer, written and served
        tok_json = os.path.join(tmp, "tokenizer.json")
        with open(tok_json, "w", encoding="utf-8") as f:
            json.dump(bpe_tokenizer_json(np.random.default_rng(SEED + 6)), f,
                      ensure_ascii=False)
        gguf = os.path.join(tmp, "llama32_1b_q8_0.gguf")
        t0 = time.perf_counter()
        cfg = DecoderConfig.llama32_1b()
        params = cast_params(random_params(cfg, seed=SEED, device=dev),
                             torch.bfloat16)
        write_decoder_gguf(gguf, cfg, params, quant="q8_0",
                           name="llama-3.2-1b-seeded",
                           extra_metadata=tokenizer_metadata_from_hf(tok_json))
        del params
        torch.cuda.empty_cache()
        out["gguf_write_s"] = time.perf_counter() - t0
        out["gguf_bytes"] = os.path.getsize(gguf)
        t0 = time.perf_counter()
        gen = TextGenerator.from_gguf(gguf, max_len=GEN_MAX_LEN, device=dev)
        torch.cuda.synchronize()
        out["gguf_load_s"] = time.perf_counter() - t0
        tok = gen.tokenizer
        if not (isinstance(tok, GGUFTokenizer) and gen.config.quantized_weights
                and gen.config.quantized_bits == 8
                and gen.config.vocab_size == LLAMA3_REGULAR + 256):
            raise AssertionError("from_gguf did not serve int8 weights with "
                                 "the file's tokenizer")
        prng = np.random.default_rng(SEED + 7)
        prompts = [gen_prompt(prng, int(n))
                   for n in prng.integers(24, 48, size=FILES_PROMPTS)]
        prompt_ids = [tok.encode(p) for p in prompts]
        for p, ids_ in zip(prompts, prompt_ids):
            if tok.decode(ids_) != p:
                raise AssertionError(f"{p!r} does not round-trip")
        n_bytes = sum(len(p.encode()) for p in prompts)
        out["prompt_bytes_per_token"] = n_bytes / sum(
            len(p) - 1 for p in prompt_ids)
        if out["prompt_bytes_per_token"] < 2.0:
            raise AssertionError("the BPE tokenizer left the prompts near "
                                 "one byte a token")
        out["kernel_vs_plain_logits"] = _kernels_vs_plain(
            gen, qm, prompt_ids, GEN_LOGIT_TOL)
        payloads = [{"prompt": p, "n_predict": GEN_TOKENS,
                     "temperature": 0.0} for p in prompts[:FILES_SERVED]]
        _quant_reset(qm)
        with LocalGenerationServer(gen, max_batch=8) as url:
            local = [_post(url + "/completion", p) for p in payloads]
        out["launches"] = _quant_counts(qm)
        for name in ("w8a16", "w8a16_nt", "w8a16_splitk"):
            if out["launches"][name] == 0:
                raise AssertionError(f"the GGUF model never launched {name}")
        proc, url, ready_s = _start_gen_serve(gguf)
        try:
            remote, lat = [], []
            for p in payloads:
                t = time.perf_counter()
                remote.append(_post(url + "/completion", p))
                lat.append(time.perf_counter() - t)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except Exception:
                proc.kill()
                proc.wait(timeout=60)
        for i, (a, b) in enumerate(zip(local, remote)):
            if a["content"] != b["content"] or not a["content"]:
                raise AssertionError(f"gen-serve answered prompt {i} "
                                     f"{b['content']!r}, in process "
                                     f"{a['content']!r}")
        out["gen_serve"] = {
            "ready_s": ready_s, "prompts": len(remote),
            "completion_p50_ms": _percentile([1e3 * t for t in lat], 50),
            "completion_p90_ms": _percentile([1e3 * t for t in lat], 90)}
        del gen
        torch.cuda.empty_cache()
    log("files " + json.dumps(out))
    return out


# -- phase 14: ingest --------------------------------------------------------

INGEST_SEQ = 24            # IVF /search requests from one client
INGEST_PER_CLIENT = 10     # then from each of CLIENTS clients: 104 in all
                           # (160 until the evaluate phase needed the time)
INGEST_DIFFER_SHARE = 0.01  # served lists off the CPU search (near-ties)
INGEST_RECORDS = 42_000    # synthetic contexts: ~1.3M words in the PDF
INGEST_PAGES = 1_000
INGEST_QUERIES = 32
MINILM = "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2"


def _ivf_near_ties(q, ids, cpu_ids, cpu) -> int:
    """Rows whose IVF lists on the card and on the CPU differ. Each must
    part at an f32 near-tie: of the listed rows' l2 distances (f64, every
    position within twice the f32 evaluation bound (d+3) 2^-24 (||q|| +
    max ||c||)^2), or of the probe (the nprobe-th and next centroid within
    that bound, so the two searches scanned different cells)."""
    rows = (ids != cpu_ids).any(dim=1).nonzero().flatten()
    if rows.numel() == 0:
        return 0
    q64 = q[rows].double()
    dist = lambda i: torch.from_numpy(cpu.rows(i.reshape(-1).numpy())).double(
        ).reshape(*i.shape, -1).sub(q64[:, None, :]).pow(2).sum(-1)
    got, ref = dist(ids[rows]), dist(cpu_ids[rows])
    cmax = float(cpu._cell_sq.max().sqrt())
    tol = 2 * (q.shape[1] + 3) * 2.0 ** -24 * (q64.norm(dim=1) + cmax) ** 2
    cent = ((cpu.centroids.double()[None] - q64[:, None, :]) ** 2).sum(-1)
    cent = cent.sort(dim=1).values
    probe_gap = cent[:, cpu.nprobe] - cent[:, cpu.nprobe - 1]
    tied = ((got - ref).abs().max(dim=1).values <= tol) | (probe_gap <= tol)
    if not bool(tied.all()):
        raise AssertionError(
            f"IVF lists on the card differ from the CPU search past a "
            f"near-tie: {ids[rows][~tied].tolist()} against "
            f"{cpu_ids[rows][~tied].tolist()}")
    return int(rows.numel())


def _ivf_served(enc, chunks, vectors, rng, ft, pool, RetrievalSystem,
                RetrievalServer, tmp, keep_ivf=None) -> dict:
    """IVF at a user's size: RetrievalSystem(dense_index_type="ivf") at its
    defaults (100 cells, nprobe 8) over A's vectors, served /search
    requests held to the same state searched on the CPU, Recall@10
    against the f32 scan, the exported IVF FAISS file served again, then
    calibrate_nprobe(0.95)."""
    from persian_rag_tpu_torch.index.ivf import IVFIndex

    t0 = time.perf_counter()
    rs = RetrievalSystem(method="dense", encoder=enc, dense_metric="l2",
                         dense_index_type="ivf")
    if not rs.load_chunks_and_index(chunks, embeddings=vectors):
        raise AssertionError("load_chunks_and_index failed")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = rs.dense_index
    if not isinstance(index, IVFIndex):
        raise AssertionError(f"dense_index_type='ivf' built {type(index)}")
    placed = {name: getattr(index, name).device.type for name in
              ("centroids", "_cells", "_cell_ids", "_cell_sq")}
    if set(placed.values()) != {"cuda"}:
        raise AssertionError(f"IVF state off the card: {placed}")
    seen = []
    search_device = index.search_device

    def recording(queries, k, *a, **kw):
        scores, ids = search_device(queries, k, *a, **kw)
        seen.append((queries.detach().clone(), ids.detach().clone(), k))
        return scores, ids

    index.search_device = recording
    n_jobs = INGEST_SEQ + CLIENTS * INGEST_PER_CLIENT
    sizes = [int(v) for v in rng.choice(REQUEST_SIZES, size=n_jobs)]
    top_ks = [int(v) for v in rng.choice((5, 10), size=n_jobs)]
    batches = make_queries(sizes, rng)
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        for batch in make_queries(REQUEST_SIZES, rng):
            _post(server.url + "/search", {"queries": batch, "top_k": 10})
        seen.clear()
        responses, latencies, conc_s, dispatches = _drive(
            server, list(zip(batches, top_ks)), pool, INGEST_SEQ)
    index.search_device = search_device
    # each served list is what the card's search returned for that query
    row_of = {c["id"]: i for i, c in enumerate(chunks)}
    seen_emb = torch.cat([q for q, _, _ in seen])
    seen_ids = [list(r) for _, i, _ in seen for r in i.cpu().numpy()]
    if seen_emb.shape[0] != sum(sizes):
        raise AssertionError("searched rows != served queries")
    for batch, k, resp in zip(batches, top_ks, responses):
        if resp is None or len(resp["results"]) != len(batch):
            raise AssertionError(f"bad /search response {resp}")
        nearest = _nearest_rows(enc.encode_device(batch), seen_emb)
        for text, hits, j in zip(batch, resp["results"], nearest):
            got = [row_of[h["id"]] for h in hits]
            if got != seen_ids[j][:k] or not all(
                    np.isfinite(h["score"]) for h in hits):
                raise AssertionError(f"served IVF ids differ from the "
                                     f"search: {text!r} served {got}, "
                                     f"searched {seen_ids[j][:k]}")
    # the same state searched by the port on the CPU
    t1 = time.perf_counter()
    state = os.path.join(tmp, "ivf_state")
    index.save(state)
    cpu = IVFIndex.load(state, device="cpu")
    differ = 0
    for queries, ids, k in seen:
        _, cpu_ids = cpu.search(queries.cpu(), k)
        differ += _ivf_near_ties(queries.cpu(), ids.cpu(), cpu_ids, cpu)
    if differ > INGEST_DIFFER_SHARE * sum(sizes):
        raise AssertionError(f"{differ} of {sum(sizes)} IVF lists on the "
                             "card differ from the CPU search")
    cpu_hold_s = time.perf_counter() - t1
    # Recall@10 against the exact f32 scan, on every served query
    q_all = seen_emb
    corpus = torch.from_numpy(np.ascontiguousarray(vectors)).cuda()
    _, want = ft.flat_topk_ref(q_all, corpus, 10, metric="l2")
    _, got = index.search_device(q_all, 10)
    recall = float(np.mean([
        len(set(g) & set(w)) / 10 for g, w in
        zip(got.cpu().numpy().tolist(), want.cpu().numpy().tolist())]))
    del corpus
    # the exported IVF FAISS file, served by a second system
    path = os.path.join(tmp, "drugs_ivf.index")
    index.export_faiss(path)
    rs_file = RetrievalSystem(method="dense", encoder=enc)
    if not rs_file.load_chunks_and_index(chunks, faiss_index_file=path):
        raise AssertionError("the IVF FAISS file did not load")
    same_cells = bool(torch.equal(rs_file.dense_index._cell_ids,
                                  index._cell_ids))
    _, file_ids = rs_file.dense_index.search_device(q_all, 10)
    file_differ = int((file_ids != got).any(dim=1).sum())
    if not same_cells or file_differ > INGEST_DIFFER_SHARE * q_all.shape[0]:
        raise AssertionError(f"the IVF file's lists differ: cells equal "
                             f"{same_cells}, {file_differ} rows")
    rs_file.cleanup()
    # where a request's time goes: host-clock medians of the encoder and
    # of the IVF search at one and sixteen queries
    breakdown = {}
    for size in (1, 16):
        stages = {"encode": [], "search": []}
        for texts in make_queries([size] * 15, rng):
            t_a = time.perf_counter()
            emb = enc.encode_device(texts)
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            index.search_device(emb, 10)[1].cpu()
            t_c = time.perf_counter()
            stages["encode"].append(1e3 * (t_b - t_a))
            stages["search"].append(1e3 * (t_c - t_b))
        breakdown[f"batch{size}"] = {
            k: statistics.median(v) for k, v in stages.items()}
    t2 = time.perf_counter()
    calibration = index.calibrate_nprobe(0.95, vectors)
    calibrate_s = time.perf_counter() - t2
    out = {
        "build_s": build_s, "cells": index.n_cells,
        "cap": int(index._cells.shape[1]),
        "overflow_rows": 0 if index._overflow is None
        else int(index._overflow.shape[0]),
        **_load_stats(latencies, sizes, INGEST_SEQ, conc_s),
        "dispatches": list(dispatches), "queries": sum(sizes),
        "cpu_differ_rows": differ, "cpu_hold_s": cpu_hold_s,
        "recall_at_10": recall, "file_cells_equal": same_cells,
        "file_differ_rows": file_differ, "breakdown_ms": breakdown,
        "calibration": calibration, "calibrate_s": calibrate_s,
    }
    if keep_ivf is not None:
        keep_ivf.append(index)  # the parallel phase shards this state
    rs.cleanup()
    return out


def ingest_pdf(path: str) -> str:
    """A Flate-compressed PDF of INGEST_PAGES pages of seeded Persian text
    (INGEST_RECORDS contexts of `synthetic_persian_qa`, one Tj line each,
    in UTF-8 literals). Returns the text the pages hold."""
    from persian_rag_tpu_torch.data.loader import synthetic_persian_qa

    contexts = [r["context"] for r in synthetic_persian_qa(
        INGEST_RECORDS, seed=SEED)]
    per_page = -(-len(contexts) // INGEST_PAGES)
    objects = [b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n",
               f"2 0 obj << /Type /Pages /Count {INGEST_PAGES} >> "
               "endobj\n".encode()]
    for page in range(INGEST_PAGES):
        lines = contexts[page * per_page : (page + 1) * per_page]
        content = b"BT /F1 10 Tf 40 800 Td\n" + b"\n".join(
            b"(" + line.encode("utf-8") + b") Tj 0 -12 Td" for line in lines
        ) + b"\nET"
        data = zlib.compress(content)
        objects.append(
            f"{3 + page} 0 obj << /Filter /FlateDecode /Length {len(data)} "
            ">> stream\n".encode() + data + b"\nendstream endobj\n")
    with open(path, "wb") as f:
        f.write(b"%PDF-1.4\n" + b"".join(objects) + b"%%EOF\n")
    return " ".join(contexts)


def _held_to_scan(ids, q, corpus, ref_ids, metric) -> int:
    """Rows of `ids` off the f32 scan's `ref_ids`; each such row must part
    at a near-tie (f64 scores of the two lists within 1e-5 relative)."""
    rows = (ids != ref_ids).any(dim=1).nonzero().flatten()
    if rows.numel() == 0:
        return 0
    q64, c64 = q[rows].double(), corpus.double()
    if metric == "l2":
        score = lambda i: -((c64[i] - q64[:, None, :]) ** 2).sum(-1)
    else:
        score = lambda i: (c64[i] * q64[:, None, :]).sum(-1)
    got, ref = score(ids[rows]), score(ref_ids[rows])
    if bool(((got - ref).abs() > 1e-5 * ref.abs().clamp(min=1.0)).any()):
        raise AssertionError("ids differ from the f32 scan past a near-tie")
    return int(rows.numel())


def ingest_phase(enc, chunks, vectors, rng, ft, pool, RetrievalSystem,
                 RetrievalServer, keep=None, keep_ivf=None) -> dict:
    """Phase 14, the ingest path: IVF over A's vectors (`_ivf_served`);
    `phase3.main` in process at the full width of the MiniLM-L12 preset
    (random weights) over a generated INGEST_PAGES-page PDF, its word and
    sentence indexes held to the f32 scan on INGEST_QUERIES queries and its
    reopened collection to the cosine scan; `create_embeddings.main` over
    the chunk CSVs for MiniLM alone, then with verify (`phase3 --tiny` from
    the command line runs in the train phase's `run-all --tiny`). Returns
    the readings and the stage-1 launches of the
    phase3 and create-embeddings part. `keep`: a directory that receives
    phase3's chunk CSVs under data/processed (the evaluate phase's
    corpus); `keep_ivf`: a list that receives the IVF index."""
    from persian_rag_tpu_torch.core.config import Config
    from persian_rag_tpu_torch.data.loader import DataLoader
    from persian_rag_tpu_torch.index.collections import CollectionStore
    from persian_rag_tpu_torch.index.dense import DenseIndex
    from persian_rag_tpu_torch.pipelines import create_embeddings, phase3
    from persian_rag_tpu_torch.pipelines.common import build_encoder

    dev = torch.device("cuda", 0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="prt_ingest_") as tmp:
        out["ivf"] = _ivf_served(enc, chunks, vectors, rng, ft, pool,
                                 RetrievalSystem, RetrievalServer, tmp,
                                 keep_ivf)
        log("ingestivf " + json.dumps(out["ivf"]))
        torch.cuda.empty_cache()
        config = Config()
        config.models = [MINILM]
        for name in ("data_dir", "raw_dir", "processed_dir", "results_dir",
                     "models_dir", "index_dir", "logs_dir"):
            setattr(config.paths, name, os.path.join(
                tmp, getattr(config.paths, name)))
        os.makedirs(config.paths.raw_dir)
        t0 = time.perf_counter()
        text = ingest_pdf(os.path.join(config.paths.raw_dir, "Drugs.pdf"))
        pdf_s = time.perf_counter() - t0
        ft.extract_candidates_bf16_cuda.launches = 0
        ft.extract_candidates_bf16x2_cuda.launches = 0
        t0 = time.perf_counter()
        results = phase3.main(config, device=dev)
        phase3_s = time.perf_counter() - t0
        steps = results["steps"]
        want_chars = len(DataLoader().preprocess_text(text))
        if not results["success"] or steps["extract"]["chars"] != want_chars:
            raise AssertionError(f"phase3: success {results['success']}, "
                                 f"{steps['extract']['chars']} chars of "
                                 f"{want_chars}")
        for kind in ("word", "sentence"):
            step = steps[f"{kind}_index"]
            if step["encode_failures"] or step["encode_fallback_items"]:
                raise AssertionError(f"{kind} encode fell back: {step}")
            if not steps[f"{kind}_smoke_test"]["success"]:
                raise AssertionError(f"{kind} smoke query failed")
        # the written indexes and the reopened collection against the scans
        qenc = build_encoder(MINILM, config, device=dev)
        texts = make_queries([INGEST_QUERIES], rng)[0]
        q = qenc.encode_device(texts)
        held = {}
        for kind in ("word", "sentence"):
            index = DenseIndex.load(os.path.join(
                config.paths.index_dir, f"drugs_{kind}_chunks"), device=dev)
            _, ids = index.search(q, 10)
            corpus = index._device_corpus
            _, ref = ft.flat_topk_ref(q, corpus, 10, metric="l2")
            held[f"{kind}_index_differ"] = _held_to_scan(
                ids, q, corpus, ref, "l2")
            held[f"{kind}_stage1"] = index._stage1_mode
        store = CollectionStore(path=os.path.join(
            config.paths.index_dir, "collections"), device=dev)
        col = store.get_or_create_collection("drugs_word")
        got = col.query(query_embeddings=q.cpu().numpy(), n_results=10)
        rows = torch.tensor([[int(i.rsplit("_", 1)[1]) for i in r]
                             for r in got["ids"]], device=dev)
        unit = torch.nn.functional.normalize(
            DenseIndex.load(os.path.join(config.paths.index_dir,
                                         "drugs_word_chunks"),
                            device=dev)._device_corpus, dim=1)
        qn = torch.nn.functional.normalize(q, dim=1)
        _, ref = ft.flat_topk_ref(qn, unit, 10, metric="dot")
        held["collection_differ"] = _held_to_scan(rows, qn, unit, ref, "dot")
        if col.count() != steps["chunking"]["word_chunks"]:
            raise AssertionError("the reopened collection lost rows")
        if max(v for k, v in held.items() if k.endswith("differ")) > \
                INGEST_DIFFER_SHARE * INGEST_QUERIES + 1:
            raise AssertionError(f"ingested lists off the scans: {held}")
        # create-embeddings over the chunk CSVs, then --verify
        t0 = time.perf_counter()
        made = create_embeddings.main(config, device=dev)
        create_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify = create_embeddings.main(config, verify=True, device=dev)
        verify_s = time.perf_counter() - t0
        per_model = made["models"][MINILM]
        for kind in ("word", "sentence"):
            if per_model[kind]["skipped"] or per_model[kind][
                    "num_vectors"] != steps[f"{kind}_index"]["num_vectors"]:
                raise AssertionError(f"create-embeddings {kind}: "
                                     f"{per_model[kind]}")
        if len(verify["verify"]) != 4 or not all(
                v["ok"] for v in verify["verify"].values()):
            raise AssertionError(f"verify: {verify}")
        launches = {"bf16": ft.extract_candidates_bf16_cuda.launches,
                    "bf16x2": ft.extract_candidates_bf16x2_cuda.launches}
        del qenc, index, col, store, unit
        if keep is not None:
            import shutil

            os.makedirs(os.path.join(keep, "data", "processed"))
            for kind in ("word", "sentence"):
                shutil.copy(os.path.join(config.paths.processed_dir,
                                         f"drugs_{kind}_chunks.csv"),
                            os.path.join(keep, "data", "processed"))
        torch.cuda.empty_cache()
    out["phase3"] = {
        "pdf_write_s": pdf_s, "phase3_s": phase3_s,
        "extract_s": steps["extract"]["time"],
        "chars": steps["extract"]["chars"],
        "chunking_s": steps["chunking"]["time"],
        "word_chunks": steps["chunking"]["word_chunks"],
        "sentence_chunks": steps["chunking"]["sentence_chunks"],
        "words": steps["chunking"]["word_stats"]["total_words"],
        **{f"{kind}_{key}": steps[f"{kind}_index"][key]
           for kind in ("word", "sentence")
           for key in ("encode_time", "encode_docs_per_sec",
                       "index_build_time")},
        **{f"{kind}_collection_s": steps[f"{kind}_collection"]["time"]
           for kind in ("word", "sentence")},
        **held,
        "create_embeddings_s": create_s, "verify_s": verify_s,
        "create_docs_per_sec": {k: per_model[k]["docs_per_sec"]
                                for k in ("word", "sentence")},
        "launches": launches,
    }
    log("ingest " + json.dumps(out["phase3"]))
    out["launches"] = launches
    return out


# -- phase 15: evaluation, the RAG evaluation pipelines and the UI ----------

DISTILUSE = "sentence-transformers/distiluse-base-multilingual-cased-v2"
E5 = "intfloat/multilingual-e5-base"
EVAL_MODELS = (MINILM, DISTILUSE, E5)
EVAL_METHODS = ("bm25", "tfidf", "dense", "hybrid")
EVAL_ITEMS = 200         # test items: records of P3's generator and seed
EVAL_SAMPLE = 50         # phase4 / phase4-enhanced sample_size (100 until
                         # the train phase needed the time)
EVAL_RAG_QUESTIONS = 2   # evaluate_single_rag through G's server (4 until
                         # the parallel phase needed the time)
EVAL_UI_QUESTIONS = 3
# the key names the JAX package writes (persian_rag_tpu/eval/evaluator.py,
# pipelines/phase2.py, phase4.py, phase4_enhanced.py), in its order
EVAL_RESULT_KEYS = (
    "exact_match", "f1_score", "precision", "recall", "bleu_score",
    "rouge_l", "rouge_1", "context_precision", "context_recall",
    "avg_retrieval_time", "avg_generation_time", "total_time",
    "failed_retrievals", "failed_generations", "success_rate",
    "num_samples")
EVAL_SEMANTIC_KEYS = ("semantic_similarity", "answer_relevancy")
EVAL_RANK_KEYS = tuple(
    f"{m}_at_{k}" for k in (1, 3, 5, 10)
    for m in ("hit", "precision", "recall")) + ("mrr_at_10",
                                                "relevance_queries")
EVAL_METADATA_KEYS = ("timestamp", "models_evaluated", "num_test_questions",
                      "chunk_types", "enhancement")
EVAL_COMPARISON_KEYS = ("best_models", "ranking", "detailed_stats",
                        "performance_summary")
EVAL_PHASE2_KEYS = ("retrieval_accuracy", "cosine_similarity",
                    "evaluation_time", "num_samples")
EVAL_REPORT_HEADINGS = ("# Enhanced RAG Evaluation Report",
                        "## Evaluation Metadata",
                        "## Best Models for Word Chunks",
                        "### Detailed Rankings for Word Chunks",
                        "### Performance Statistics for Word Chunks")


def _keys_are(got, want, what) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{what} keys {list(got)}, want {list(want)}")


def _check_result_keys(res, name, semantic, rank=False) -> None:
    """One model's results: the JAX package's `{name}_{metric}` keys."""
    keys = ((EVAL_RANK_KEYS if rank else ()) + EVAL_RESULT_KEYS
            + (EVAL_SEMANTIC_KEYS if semantic else ()))
    _keys_are(res, [f"{name}_{k}" for k in keys], name)
    if res[f"{name}_failed_retrievals"] != 0:
        raise AssertionError(f"{name}: {res[f'{name}_failed_retrievals']} "
                             "failed retrievals")


def _check_saved(directory, pattern, results, headings) -> str:
    """The one JSON and one markdown report of `pattern` under directory:
    the JSON holds the results' keys, the report its headings."""
    import glob

    saved = glob.glob(os.path.join(directory, pattern + ".json"))
    reports = glob.glob(os.path.join(directory,
                                     pattern.replace("evaluation", "report")
                                     + ".md"))
    if len(saved) != 1 or len(reports) != 1:
        raise AssertionError(f"{pattern}: files {saved} {reports}")
    with open(saved[0], encoding="utf-8") as f:
        _keys_are(json.load(f), [k for k in results if k != "artifacts"],
                  saved[0])
    with open(reports[0], encoding="utf-8") as f:
        report = f.read()
    missing = [h for h in headings if h + "\n" not in report]
    if missing:
        raise AssertionError(f"{reports[0]} lacks {missing}")
    return os.path.basename(saved[0])


def _record_retrievals(RetrievalSystem, calls):
    """Wrap RetrievalSystem.retrieve_batch so that each call appends (the
    system's indexes and encoder, queries, top_k, results) to `calls`;
    returns the original. The references outlive the system's cleanup."""
    import types

    orig = RetrievalSystem.retrieve_batch

    def recording(self, queries, top_k=10):
        res = orig(self, queries, top_k)
        calls.append((types.SimpleNamespace(
            method=self.method, chunks=self.chunks,
            dense_index=self.dense_index, bm25_index=self.bm25_index,
            tfidf_index=self.tfidf_index, encoder=self.embedding_model,
            query_prefix=self.query_prefix,
            row_of={c["id"]: i for i, c in enumerate(self.chunks)}),
            list(queries), top_k, res))
        return res

    RetrievalSystem.retrieve_batch = recording
    return orig


def _check_served(calls, ft) -> dict:
    """Every recorded list held to its exact scorer: dense to the f32 scan
    of the same query embeddings (near-ties within the f32 bound), BM25
    and TF-IDF to the f64 scorer of the index's own ELL, hybrid to the host
    fusion loop on the channels' own outputs (each channel held as the
    dense and BM25 lists are). Counts lists and near-tie rows per
    (method, chunks); near-ties above NEAR_TIE_SHARE raise. A lexical list
    whose rows differ from the f64 order only among rows of exactly equal
    f64 score (P3's templated chunks hold many) counts apart, as an
    `f64_tie`: the scorer itself ties them, and f32 summation order ranks
    them."""
    out, mats = {}, {}

    def f64(index):
        if id(index) not in mats:
            mats[id(index)] = f64_matrix(index)
        return mats[id(index)]

    def dense_near(s, queries, k):
        emb = s.encoder.encode_device([s.query_prefix + q for q in queries])
        corpus = s.dense_index._device_corpus
        d_s, d_i = s.dense_index.search_device(emb, k)
        _, ref = ft.flat_topk_ref(emb, corpus, k, metric="l2")
        return near_tie_rows(emb, corpus, d_i, ref)[0], d_s, d_i, emb

    for s, queries, top_k, res in calls:
        k = min(top_k, len(s.chunks))
        got = [[s.row_of[c["id"]] for c, _ in row] for row in res]
        if [len(r) for r in got] != [k] * len(queries):
            raise AssertionError(f"{s.method}: lists of {[len(r) for r in got]}"
                                 f" at top_k {top_k}")
        entry = out.setdefault(f"{s.method}_{len(s.chunks)}",
                               {"lists": 0, "near_tie": 0, "f64_tie": 0})
        ties = 0
        if s.method in ("bm25", "tfidf"):
            index = s.bm25_index if s.method == "bm25" else s.tfidf_index
            lex = check_lexical(index, *f64(index),
                                [index._query_terms(q) for q in queries],
                                got, [[v for _, v in row] for row in res])
            near = lex["near_tie_rows"] - lex["f64_tie_rows"]
            ties = lex["f64_tie_rows"]
        elif s.method == "dense":
            near, _, d_i, _ = dense_near(s, queries, k)
            if d_i.tolist() != got:
                raise AssertionError("a dense list differs from its search")
        else:
            bm = s.bm25_index
            m_d, m_b = min(2 * top_k, len(s.chunks)), min(2 * top_k,
                                                         bm.ntotal)
            near, d_s, d_i, _ = dense_near(s, queries, m_d)
            terms = [bm._query_terms(q) for q in queries]
            l_s, l_i = bm._search_device(terms, m_b, allow_union=m_b <= 32)
            d_s, d_i, l_s, l_i = (t.cpu().numpy() for t in (d_s, d_i, l_s,
                                                             l_i))
            lex = check_lexical(bm, *f64(bm), terms, l_i.tolist(),
                                l_s.tolist())
            near += lex["near_tie_rows"] - lex["f64_tie_rows"]
            ties = lex["f64_tie_rows"]
            ids = [c["id"] for c in s.chunks]
            for qi, row in enumerate(res):
                want = host_fusion(
                    [(ids[i], 1.0 / (1.0 + float(v)))
                     for v, i in zip(d_s[qi], d_i[qi]) if i >= 0],
                    [(ids[i], float(v)) for v, i in zip(l_s[qi], l_i[qi])
                     if i >= 0], top_k)
                near += _match_fused([(c["id"], v) for c, v in row], want,
                                     f"hybrid list {qi}")
        entry["lists"] += len(queries)
        entry["near_tie"] += near
        entry["f64_tie"] += ties
    for key, entry in out.items():
        if entry["near_tie"] > NEAR_TIE_SHARE * entry["lists"]:
            raise AssertionError(f"{key}: too many near-tie lists {entry}")
    return out


def _eval_counts(ft, ss, qm) -> dict:
    return {"bf16": ft.extract_candidates_bf16_cuda.launches,
            "bf16x2": ft.extract_candidates_bf16x2_cuda.launches,
            **_counts(ss), **_quant_counts(qm)}


def _eval_reset(ft, ss, qm) -> None:
    ft.extract_candidates_bf16_cuda.launches = 0
    ft.extract_candidates_bf16x2_cuda.launches = 0
    _reset(ss)
    _quant_reset(qm)


def evaluate_phase(root, ft, ss, qm, dev) -> dict:
    """Phase 15: the evaluation pipelines at full width over P3's chunk
    CSVs (`root`/data/processed, written by the ingest phase's phase3), with
    EVAL_ITEMS test items drawn from the records that made P3's PDF:
    phase2 `main` over the three configured encoders (random weights at
    their presets); phase4 `main` over both chunk types and EVAL_METHODS,
    and phase4-enhanced `main` over the word chunks and the three encoders,
    both against the extractive FakeLlamaServer; one
    `RAGEvaluator.evaluate_single_rag` of EVAL_RAG_QUESTIONS questions over
    the dense sentence-chunk system through LlamaClient and G's server
    (Llama-3.2-1B, random int8 weights); then the UI (`launch`, method
    dense, MiniLM at full width) with /api/init and EVAL_UI_QUESTIONS
    /api/ask. Every retrieval list is held to its exact scorer
    (`_check_served`), every results file to the JAX package's key names,
    and the launches of #1 / #2, #10-#13 and #14 / #15 / #17 are counted
    per step (the checks' own searches apart). Each configured encoder is
    built once in the phase (`build_encoder` memoised in the pipeline
    modules: its random weights come from one seed, so every build is the
    same model)."""
    import threading

    from persian_rag_tpu_torch.core.config import Config
    from persian_rag_tpu_torch.data.loader import synthetic_persian_qa
    from persian_rag_tpu_torch.eval.evaluator import RAGEvaluator
    from persian_rag_tpu_torch.gen.client import LlamaClient
    from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer
    from persian_rag_tpu_torch.gen.generator import TextGenerator
    from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig, random_quantized_params)
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.pipelines import (
        common, phase2, phase4, phase4_enhanced)
    from persian_rag_tpu_torch.pipelines.common import short_name
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
    from persian_rag_tpu_torch.ui.app import launch

    config = Config()
    config.models = list(EVAL_MODELS)
    for name in ("data_dir", "raw_dir", "processed_dir", "results_dir",
                 "models_dir", "index_dir", "logs_dir"):
        setattr(config.paths, name, os.path.join(
            root, getattr(config.paths, name)))
    records = synthetic_persian_qa(INGEST_RECORDS, seed=SEED)
    pick = np.random.default_rng(SEED + 7).choice(len(records), EVAL_ITEMS,
                                                  replace=False)
    items = [records[i] for i in sorted(pick)]
    results_dir = config.paths.results_dir
    out, launches, steps = {}, {}, {}
    calls = []
    encode_log = {}  # "hidden x layers" -> [docs, seconds] of corpus encodes
    orig_encode = SentenceEncoder.encode

    def timed_encode(self, texts, batch_size=32):
        t = time.perf_counter()
        emb = orig_encode(self, texts, batch_size)
        if len(texts) >= 1_000:
            entry = encode_log.setdefault(
                f"{self.config.hidden_size}x{self.config.num_layers}", [0, 0.0])
            entry[0] += len(texts)
            entry[1] += time.perf_counter() - t
        return emb

    def step(name, fn):
        """fn() with the launches of its kernels counted, then its served
        lists checked; the step's seconds exclude the checks."""
        calls.clear()
        _eval_reset(ft, ss, qm)
        t = time.perf_counter()
        res = fn()
        steps[name] = time.perf_counter() - t
        launches[name] = _eval_counts(ft, ss, qm)
        out[f"{name}_served"] = _check_served(calls, ft)
        torch.cuda.empty_cache()
        return res

    built = {}
    real_build = common.build_encoder

    def build_once(model_name, config=None, mesh=None, tiny=False, seed=0,
                   device=None):
        key = (model_name, tiny, seed, str(device))
        if key not in built:
            built[key] = real_build(model_name, config, mesh=mesh, tiny=tiny,
                                    seed=seed, device=device)
        return built[key]

    builders = (common, phase2, phase4, phase4_enhanced)
    orig_retrieve = _record_retrievals(RetrievalSystem, calls)
    SentenceEncoder.encode = timed_encode
    for module in builders:
        module.build_encoder = build_once
    fake = FakeLlamaServer().start()
    try:
        # 1. phase2 over the three encoders
        res = step("phase2", lambda: phase2.main(config, test_data=items,
                                                  device=dev))
        _keys_are(res["models"], EVAL_MODELS, "phase2 models")
        for model, r in res["models"].items():
            _keys_are(r, EVAL_PHASE2_KEYS, f"phase2 {model}")
            if r["num_samples"] != min(100, len(items)):  # phase2's cap
                raise AssertionError(f"phase2 {model}: {r}")
        for name in ("phase2_evaluation_results.json",
                     "phase2_model_comparison.json"):
            with open(os.path.join(results_dir, name), encoding="utf-8") as f:
                saved = json.load(f)
            _keys_are(saved, EVAL_MODELS if "results" in name else
                      ("rankings", "best_model"), name)
        out["phase2"] = {short_name(m): {k: r[k] for k in (
            "retrieval_accuracy", "cosine_similarity", "evaluation_time")}
            for m, r in res["models"].items()}
        # 2. phase4 over both chunk types and the four methods
        res = step("phase4", lambda: phase4.main(
            config, methods=list(EVAL_METHODS), test_data=items,
            llama_client=LlamaClient(fake.url), sample_size=EVAL_SAMPLE,
            device=dev))
        # phase4's dense sentence-chunk system, for step 4
        dense = next(s for s, *_ in calls if s.method == "dense"
                     and s.chunks[0]["chunk_type"] == "sentence_based")
        sentence = (dense.encoder, dense.chunks, dense.dense_index.vectors())
        del dense
        _keys_are(res, ["evaluation_metadata"] + [
            key for kind in ("word", "sentence") for key in
            [f"{kind}_{m}_results" for m in EVAL_METHODS]
            + [f"{kind}_chunks_comparison"]] + ["artifacts"], "phase4")
        _keys_are(res["evaluation_metadata"],
                  EVAL_METADATA_KEYS + ("llm_connectivity",),
                  "phase4 metadata")
        out["phase4"] = {}
        for kind in ("word", "sentence"):
            _keys_are(res[f"{kind}_chunks_comparison"], EVAL_COMPARISON_KEYS,
                      f"phase4 {kind} comparison")
            for m in EVAL_METHODS:
                r = res[f"{kind}_{m}_results"]
                _check_result_keys(r, m, m in ("dense", "hybrid"))
                if r[f"{m}_num_samples"] != EVAL_SAMPLE:
                    raise AssertionError(f"phase4 {kind} {m}: {r}")
                out["phase4"][f"{kind}_{m}"] = {k: r[f"{m}_{k}"] for k in (
                    "f1_score", "bleu_score", "rouge_l", "context_recall",
                    "success_rate", "avg_retrieval_time")}
        out["phase4_files"] = _check_saved(
            results_dir, "phase4_rag_evaluation_*", res,
            EVAL_REPORT_HEADINGS + ("## Best Models for Sentence Chunks",))
        # 3. phase4-enhanced over the word chunks and the three encoders
        res = step("phase4_enhanced", lambda: phase4_enhanced.main(
            config, test_data=items, llama_client=LlamaClient(fake.url),
            sample_size=EVAL_SAMPLE, device=dev))
        names = [short_name(m) for m in EVAL_MODELS]
        _keys_are(res, ["evaluation_metadata"] + [f"{n}_results"
                                                 for n in names]
                  + ["word_chunks_comparison"], "phase4-enhanced")
        _keys_are(res["evaluation_metadata"], EVAL_METADATA_KEYS,
                  "phase4-enhanced metadata")
        _keys_are(res["word_chunks_comparison"], EVAL_COMPARISON_KEYS,
                  "phase4-enhanced comparison")
        out["phase4_enhanced"] = {}
        for n in names:
            r = res[f"{n}_results"]
            _check_result_keys(r, n, True, rank=True)
            if r[f"{n}_relevance_queries"] == 0:
                raise AssertionError(f"{n}: no relevance queries")
            out["phase4_enhanced"][n] = {k: r[f"{n}_{k}"] for k in (
                "hit_at_1", "hit_at_3", "hit_at_5", "hit_at_10",
                "mrr_at_10", "relevance_queries", "f1_score")}
        out["phase4_enhanced_file"] = _check_saved(
            results_dir, "phase4_enhanced_rag_evaluation_*", res,
            EVAL_REPORT_HEADINGS)
        out["encode_docs_per_s"] = {k: d / s for k, (d, s) in
                                    encode_log.items()}

        # 4. evaluate_single_rag over the dense sentence-chunk system,
        # generation by G behind LocalGenerationServer, through LlamaClient
        class RecordingClient(LlamaClient):
            def _post_json(self, path, payload):
                res = super()._post_json(path, payload)
                self.answers.append((path, res))
                return res

        def rag():
            enc, chunks, vectors = sentence
            rs = RetrievalSystem(method="dense", encoder=enc, device=dev)
            rs.load_chunks_and_index(chunks, embeddings=vectors)
            cfg = DecoderConfig.llama32_1b(compute_dtype=torch.bfloat16,
                                           quantized_weights=True)
            gen = TextGenerator(cfg, params=random_quantized_params(
                cfg, seed=SEED, device=dev), tokenizer=word_tokenizer(),
                max_len=GEN_MAX_LEN, device=dev)
            server = LocalGenerationServer(gen, max_batch=8, max_wait_ms=10.0)
            with server as url:
                client = RecordingClient(url)
                client.answers = []
                res = RAGEvaluator(llama_client=client).evaluate_single_rag(
                    rs, items[:EVAL_RAG_QUESTIONS], model_name="minilm_g")
            if server.errors:
                raise AssertionError("G's server failed a group:\n"
                                     + "\n".join(server.error_log))
            done = [a for p, a in client.answers if p == "/completion"]
            if len(done) < EVAL_RAG_QUESTIONS or not all(
                    isinstance(a, dict) and isinstance(a.get("content"), str)
                    for a in done):
                raise AssertionError(f"G answered {client.answers}")
            rs.cleanup()
            return res, len(done), server.errors

        res, answered, errors = step("rag_g", rag)
        del sentence
        _check_result_keys(res, "minilm_g", True)
        out["rag_g"] = {"answered_over_http": answered, "server_errors": errors,
                        **{k: res[f"minilm_g_{k}"] for k in (
                            "failed_generations", "avg_retrieval_time",
                            "avg_generation_time", "f1_score",
                            "semantic_similarity")}}

        # 5. the UI: dense over the sentence chunks, MiniLM at full width
        def ui():
            ui_config = Config()
            ui_config.models = [MINILM]
            ui_config.paths = config.paths
            ui_config.generation.server_url = fake.url
            server, system = launch(ui_config, port=0, method="dense",
                                    block=False, device=dev)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            try:
                page = urllib.request.urlopen(base + "/", timeout=60).read()
                t = time.perf_counter()
                init = _post(base + "/api/init", {})
                init_s = time.perf_counter() - t
                if not init.get("ok"):
                    raise AssertionError(f"/api/init answered {init}")
                asks = []
                for item in items[-EVAL_UI_QUESTIONS:]:
                    t = time.perf_counter()
                    got = _post(base + "/api/ask",
                                {"question": item["question"], "top_k": 5})
                    asks.append(time.perf_counter() - t)
                    want, _ = system.retriever.get_contexts_for_rag(
                        item["question"], top_k=5, max_context_length=3000)
                    if got.get("contexts") != want or not got.get("answer"):
                        raise AssertionError(f"/api/ask answered {got}")
            finally:
                server.shutdown()
                server.server_close()
            if "سیستم پرسش و پاسخ".encode() not in page:
                raise AssertionError("GET / is not the UI page")
            if system.retriever.chunks[0]["chunk_type"] != "sentence_based":
                raise AssertionError("the UI did not serve the sentence chunks")
            return {"init_s": init_s, "ask_ms": [1e3 * a for a in asks]}

        out["ui"] = step("ui", ui)
    finally:
        fake.stop()
        SentenceEncoder.encode = orig_encode
        RetrievalSystem.retrieve_batch = orig_retrieve
        for module in builders:
            module.build_encoder = real_build
        built.clear()
    out["step_s"] = steps
    out["launches"] = launches
    total = {k: sum(v[k] for v in launches.values())
             for k in launches["phase2"]}
    out["launches_total"] = total
    log("evaluate " + json.dumps(out))
    # the kernels each path reaches: #1 or #2 (the sentence index is past
    # TWO_STAGE_MIN_N; its commit probe picks one), a lexical kernel in
    # phase4, and #14, #15 and #17 under the evaluator
    if launches["phase4"]["bf16"] + launches["phase4"]["bf16x2"] == 0 or (
            launches["ui"]["bf16"] + launches["ui"]["bf16x2"] == 0):
        raise AssertionError(f"no stage-1 candidate kernel launched: "
                             f"{launches}")
    if sum(launches["phase4"][name] for name in ss.KERNELS) == 0:
        raise AssertionError(f"phase4 launched no sparse kernel: {launches}")
    if min(launches["rag_g"][n] for n in ("w8a16", "w8a16_nt",
                                           "w8a16_splitk")) == 0:
        raise AssertionError(f"the evaluator's generation launched no "
                             f"quantized kernel: {launches['rag_g']}")
    return out


# -- 16. train ---------------------------------------------------------------

TRAIN_CHECK_BATCH = 4    # the card-vs-CPU steps (the CPU's share: seconds)
TRAIN_LOSS_TOL = 1e-5    # |loss card - loss CPU| of each step
# largest parameter difference after the zero-rate and the full-rate step:
# one AdamW step at the default rate, which a coordinate whose gradient is
# rounding noise (the key biases: softmax ignores a shift of every score)
# may take either way
TRAIN_PARAM_TOL = 2e-5
TRAIN_BATCH = 16         # config.yaml training.batch_size
TRAIN_STEPS = 60         # 200 until the parallel phase needed the time
TRAIN_LR = 1e-4
TRAIN_WARMUP = 20
TRAIN_WINDOW = 20        # logged losses averaged at each end of the run
TRAIN_RESUME = (6, 4)    # steps of the resumed run, the checkpoint's step
PHASE1_RECORDS = 64      # training.max_train_samples of the phase1 run
PHASE1_KEYS = ["total_qa_pairs", "train_size", "test_size", "models"]
PHASE1_MODEL_KEYS = ["training_examples", "training_time",
                     "samples_per_second", "final_loss", "model_path"]
LORA_RANK, LORA_ALPHA = 32, 32.0  # the JAX defaults, the notebook's r / alpha
LORA_BATCH, LORA_MAX_LEN = 4, 128
LORA_RECORDS, LORA_EPOCHS = 8, 3  # two batches, each seen three times
LORA_LOGIT_RTOL = 1e-5   # merged forward vs the training forward
LORA_TOKENS = 16         # greedy tokens of each served prompt
RUN_ALL_RECORDS = 60


def _cli_start(cwd: str, *args: str):
    """`python -m persian_rag_tpu_torch <args>` from this checkout, started
    in `cwd`, on the card (no --device: the default is the card)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "persian_rag_tpu_torch", *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _cli_wait(started, timeout: int = 600):
    """(stdout, seconds) of a `_cli_start` process; raises on a non-zero
    exit, and kills it past `timeout`."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(proc.args[2:])} exited "
                             f"{proc.returncode}: {stderr[-3000:]}")
    return stdout, time.perf_counter() - t0


def _step_profile(step, steps: int) -> dict:
    """Device time of `steps` calls of `step` from torch.profiler (after
    one unprofiled call), its share of the profiled wall and the largest
    kernels; None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    total = sum(ms for _, ms, _ in rows)
    if total <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": total / steps,
            "device_busy_share_profiled": total / wall_ms,
            "top": [{"name": key[:60], "ms_per_step": ms / steps,
                     "calls_per_step": n / steps} for key, ms, n in rows[:6]]}


def _train_embedding(dev, root) -> dict:
    """EmbeddingTrainer at the full width of MiniLM-L12."""
    from persian_rag_tpu_torch.core.config import Config
    from persian_rag_tpu_torch.data.loader import synthetic_persian_qa
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.pipelines import common
    from persian_rag_tpu_torch.train import EmbeddingTrainer

    out = {}
    cfg = common.PRESETS[MINILM]["config"]()
    host = SentenceEncoder(cfg, max_seq_len=128, device="cpu", seed=SEED)
    enc = SentenceEncoder(cfg, state_dict=host.encoder.state_dict(),
                          head_state_dict=host.head.state_dict(),
                          max_seq_len=128, device=dev)
    card = EmbeddingTrainer(enc, seed=SEED)
    examples = card.prepare_training_data(synthetic_persian_qa(seed=SEED))

    # the same two steps on the card and on the CPU from the same weights
    # and batch: update 0 at rate 0 (the moments take the gradient), update
    # 1 at the full default rate
    lr = Config().training.learning_rate
    batch = examples[:TRAIN_CHECK_BATCH]
    cpu = EmbeddingTrainer(host, seed=SEED)
    opts = [t.make_optimizer(lr, 1, 2) for t in (card, cpu)]
    loss_err = []
    for _ in range(2):
        losses = [float(t.train_step(*o, batch)) for t, o in zip((card, cpu),
                                                                 opts)]
        loss_err.append(abs(losses[0] - losses[1]))
    names = [n for n, _ in enc.encoder.named_parameters()] + [
        "head." + n for n, _ in enc.head.named_parameters()]
    diffs = [float((a.detach().cpu() - b.detach()).abs().max())
             for a, b in zip(card.parameters(), cpu.parameters())]
    worst = int(np.argmax(diffs))
    out["card_vs_cpu"] = {"batch": TRAIN_CHECK_BATCH, "lr": lr,
                          "loss_abs_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
                          "param_max_abs_err": diffs[worst],
                          "param_worst": names[worst],
                          "param_tol": TRAIN_PARAM_TOL}
    del cpu, host, opts
    if max(loss_err) > TRAIN_LOSS_TOL or diffs[worst] > TRAIN_PARAM_TOL:
        raise AssertionError(f"card and CPU steps differ: "
                             f"{out['card_vs_cpu']}")

    # a few hundred steps under the warmup-linear schedule
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    summary = card.fine_tune(
        examples[:TRAIN_STEPS * TRAIN_BATCH], batch_size=TRAIN_BATCH,
        warmup_steps=TRAIN_WARMUP, learning_rate=TRAIN_LR, log_every=1)
    losses = summary["losses"]
    early = float(np.mean(losses[:TRAIN_WINDOW]))
    late = float(np.mean(losses[-TRAIN_WINDOW:]))
    out["fine_tune"] = {
        "steps": len(losses), "batch": TRAIN_BATCH, "seq": 128,
        "ms_a_step": 1e3 * summary["training_time_s"] / len(losses),
        "samples_per_s": summary["samples_per_second"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_early": early, "loss_late": late}
    if not (np.isfinite(losses).all() and late < early):
        raise AssertionError(f"the loss did not fall: {out['fine_tune']}")
    # where a step's time goes: the host's tokenizer alone, and the device
    # time of profiled steps
    tok = enc.tokenizer
    batches = [examples[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
               for i in range(TRAIN_WINDOW)]
    t0 = time.perf_counter()
    for b in batches:
        for side in (0, 1):
            tok.encode_batch([e.texts[side] for e in b], enc.max_seq_len)
    out["fine_tune"]["tokenize_ms_a_step"] = (
        1e3 * (time.perf_counter() - t0) / len(batches))
    opt = card.make_optimizer(TRAIN_LR, 1, 100)
    out["fine_tune"]["profile"] = _step_profile(
        lambda: card.train_step(*opt, batches[0]), 5)
    del opt

    # save_model -> build_encoder: the same encoder, bit for bit
    config = Config()
    config.paths.models_dir = os.path.join(root, "models")
    path = os.path.join(config.paths.models_dir,
                        common.short_name(MINILM) + "_finetuned")
    t0 = time.perf_counter()
    card.save_model(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = common.build_encoder(MINILM, config, device=dev)
    load_s = time.perf_counter() - t0
    texts = [e.texts[i] for e in examples[:32] for i in (0, 1)]
    same = np.array_equal(loaded.encode(texts), enc.encode(texts)) and all(
        torch.equal(a, b) for a, b in zip(
            EmbeddingTrainer(loaded).parameters(), card.parameters()))
    out["files"] = {"save_s": save_s, "load_s": load_s,
                    "bytes": os.path.getsize(os.path.join(
                        path, "params.msgpack")), "bit_equal": same}
    del loaded
    if not same:
        raise AssertionError("the reloaded encoder differs from the trained")

    # a checkpoint at step k, then a resume: the uninterrupted parameters
    steps, at = TRAIN_RESUME
    part = examples[:steps * TRAIN_BATCH]
    kw = dict(batch_size=TRAIN_BATCH, warmup_steps=2, learning_rate=TRAIN_LR,
              checkpoint_dir=os.path.join(root, "ckpt"))
    card.fine_tune(part, checkpoint_every=at, **kw)
    want = [p.detach().clone() for p in card.parameters()]
    t0 = time.perf_counter()
    card.fine_tune(part, resume=True, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(p, w) for p, w in zip(card.parameters(), want))
    out["resume"] = {"steps": steps, "checkpoint_step": at,
                     "resume_s": time.perf_counter() - t0, "bit_equal": exact}
    if not exact:
        raise AssertionError("the resumed run left the uninterrupted one")
    return out


def _phase1_start(root):
    """`phase1` from the command line over the three configured encoders
    at their presets (full width, random weights), started."""
    work = os.path.join(root, "phase1")
    os.makedirs(work)
    with open(os.path.join(work, "config.yaml"), "w", encoding="utf-8") as f:
        f.write("models:\n" + "".join(f'  - "{m}"\n' for m in EVAL_MODELS)
                + f"training:\n  max_train_samples: {PHASE1_RECORDS}\n")
    return work, _cli_start(work, "phase1", "--config", "config.yaml")


def _phase1_check(dev, work, started) -> dict:
    """phase1's results hold the JAX package's keys, and each
    `<name>_finetuned` directory loads through build_encoder at its
    preset's width."""
    from persian_rag_tpu_torch.core.config import Config
    from persian_rag_tpu_torch.pipelines import common

    stdout, seconds = _cli_wait(started)
    result = json.loads(stdout)
    if list(result) != PHASE1_KEYS or list(result["models"]) != list(
            EVAL_MODELS):
        raise AssertionError(f"phase1 results: {result}")
    config = Config()
    config.paths.models_dir = os.path.join(work, "models")
    out = {"seconds": seconds, "records": result["total_qa_pairs"],
           "models": {}}
    for name in EVAL_MODELS:
        row = result["models"][name]
        if list(row) != PHASE1_MODEL_KEYS:
            raise AssertionError(f"phase1 keys of {name}: {list(row)}")
        enc = common.build_encoder(name, config, device=dev)
        vec = enc.encode(["دارو برای درمان سردرد استفاده می شود"])
        if enc.config != common.PRESETS[name]["config"]() or not (
                np.isfinite(vec).all()):
            raise AssertionError(f"{name}_finetuned did not load")
        out["models"][common.short_name(name)] = {
            k: row[k] for k in ("training_examples", "training_time",
                                "samples_per_second", "final_loss")}
        del enc
    return out


def _train_lora(qm, dev) -> dict:
    """LoraTrainer at the full width of Llama-3.2-1B (random f32 base), then
    the merged tree int8-quantized and served through TextGenerator."""
    from persian_rag_tpu_torch.data.loader import synthetic_persian_qa
    from persian_rag_tpu_torch.gen.generator import TextGenerator
    from persian_rag_tpu_torch.models.convert import decoder_params_from_flax
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig, LlamaDecoder, random_params)
    from persian_rag_tpu_torch.ops.flat_topk import full_f32
    from persian_rag_tpu_torch.train.lora import (
        LoraTrainer, _leaves, build_sft_example, pad_batch)

    cfg = DecoderConfig.llama32_1b()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = random_params(cfg, seed=SEED, device=dev)
    trainer = LoraTrainer(cfg, base, rank=LORA_RANK, alpha=LORA_ALPHA,
                          seed=SEED, device=dev)
    out = {"build_s": time.perf_counter() - t0, "rank": LORA_RANK,
           "lora_params": sum(t.numel() for t in _leaves(trainer.lora))}
    # B = 0: the merged tree is the base, bit for bit
    merged = trainer.merged_params()
    targets = [(layer, group, name) for layer, sub in trainer.lora.items()
               for group, mods in sub.items() for name in mods]
    if len(targets) != 7 * cfg.num_layers or not all(
            torch.equal(merged[l][g][n]["kernel"], base[l][g][n]["kernel"])
            for l, g, n in targets):
        raise AssertionError("the merged tree at step 0 is not the base")
    del merged

    records = synthetic_persian_qa(LORA_RECORDS, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = trainer.fit(records, epochs=LORA_EPOCHS, batch_size=LORA_BATCH,
                          max_len=LORA_MAX_LEN, log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = summary["losses"]
    out["fit"] = {"steps": summary["steps"], "losses": losses,
                  "ms_a_step": 1e3 * fit_s / summary["steps"],
                  "tokens_per_s": summary["steps"] * LORA_BATCH
                  * LORA_MAX_LEN / fit_s,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"the LoRA loss did not fall: {losses}")
    out["fit"]["profile"] = _step_profile(
        lambda: trainer.fit(records[:LORA_BATCH], batch_size=LORA_BATCH,
                            max_len=LORA_MAX_LEN), 2)

    # the merged tree's logits against the training forward's
    ids, _, mask = pad_batch([
        build_sft_example(r["question"], r["answer"], trainer.tokenizer,
                          LORA_MAX_LEN) for r in records[:LORA_BATCH]])
    ids, mask = (torch.as_tensor(a, dtype=torch.long, device=dev)
                 for a in (ids, mask))
    with torch.no_grad(), full_f32():
        trained = trainer.logits(trainer.lora, ids, mask)
        merged = trainer.merged_params()
        with torch.device("meta"):
            model = LlamaDecoder(cfg)
        model.load_state_dict(decoder_params_from_flax(merged), assign=True)
        served = model(ids, attention_mask=mask)
    err = float((served - trained).abs().max())
    scale = float(trained.abs().max())
    out["merged_vs_training_logits"] = {"max_abs_err": err,
                                        "max_abs_logit": scale}
    del trained, served, model, trainer, base
    if not err <= LORA_LOGIT_RTOL * scale:
        raise AssertionError(f"merged logits differ by {err} (largest "
                             f"{scale})")

    # the merged tree int8-quantized, served greedy through #14 / #15 / #17
    gcfg = DecoderConfig.llama32_1b(compute_dtype=torch.bfloat16,
                                    quantized_weights=True)
    gen = TextGenerator(gcfg, params=merged, max_len=512, device=dev)
    del merged
    torch.cuda.empty_cache()
    prompt_ids = [gen.tokenizer.encode(f"سوال: {r['question']}\nپاسخ: ")
                  for r in records]
    out["kernel_vs_plain_logits"] = _kernels_vs_plain(
        gen, qm, prompt_ids, GEN_LOGIT_TOL)
    _quant_reset(qm)
    t0 = time.perf_counter()
    streams = [gen.generate_ids(p, max_tokens=LORA_TOKENS)
               for p in prompt_ids[:2]]
    out["served"] = {"tokens": [len(s) for s in streams],
                     "seconds": time.perf_counter() - t0}
    out["launches"] = _quant_counts(qm)
    del gen
    torch.cuda.empty_cache()
    if min(out["launches"][n] for n in ("w8a16", "w8a16_nt",
                                         "w8a16_splitk")) == 0:
        raise AssertionError(f"the served LoRA model launched no quantized "
                             f"kernel: {out['launches']}")
    return out


def _run_all_start(root, llm_url):
    """`run-all --tiny` from the command line against the FakeLlamaServer
    at `llm_url`, started: the four phases chained (their width is checked
    in the ingest and evaluate phases and by phase1 above)."""
    work = os.path.join(root, "runall")
    os.makedirs(work)
    with open(os.path.join(work, "config.yaml"), "w", encoding="utf-8") as f:
        f.write('models:\n  - "tiny-model"\ntraining:\n'
                f"  max_train_samples: {RUN_ALL_RECORDS}\n"
                "evaluation:\n  sample_size: 5\ngeneration:\n"
                f'  server_url: "{llm_url}"\n')
    return work, _cli_start(work, "run-all", "--tiny", "--config",
                            "config.yaml")


def _run_all_check(work, started) -> dict:
    stdout, seconds = _cli_wait(started)
    # the CLI prints the results cut at 4,000 characters, as the JAX CLI
    # does: phase4's part may fall past the cut, its files may not
    missing = [p for p in ("phase1", "phase2", "phase3")
               if f'\n  "{p}": {{' not in stdout]
    results = os.path.join(work, "results")
    files = sorted(os.listdir(results))
    with open(os.path.join(results, "phase3_pdf_processing_results.json"),
              encoding="utf-8") as f:
        phase3_ok = json.load(f)["success"] is True
    if missing or not phase3_ok or "phase1_training_results.json" not in (
            files) or not any(f.startswith("phase4_rag_evaluation_")
                              for f in files):
        raise AssertionError(f"run-all: phases {missing} missing, phase3 "
                             f"success {phase3_ok}; {files}")
    return {"seconds": seconds, "results": files}


def train_phase(qm, dev) -> dict:
    """Phase 16: training. `phase1` from the command line over the three
    configured encoders at full width (PHASE1_RECORDS records) beside
    `run-all --tiny` from the command line; then EmbeddingTrainer at the
    full width of MiniLM-L12 (random weights, HashTokenizer, 128 tokens):
    two steps on the card and on the CPU from the same weights and batch,
    held to TRAIN_LOSS_TOL / TRAIN_PARAM_TOL; TRAIN_STEPS steps of
    TRAIN_BATCH under the warmup-linear schedule (ms a step, samples/s,
    peak memory, the late loss below the early); save_model ->
    build_encoder bit-equal; a checkpoint and a resume equal to the
    uninterrupted run; LoraTrainer at the full width of Llama-3.2-1B (rank
    32, alpha 32, random f32 base; the merged tree is the base at step 0,
    the loss falls, the merged logits are the training forward's), its
    merged tree int8-quantized and served greedy through #14 / #15 / #17
    within G's logit limit of plain."""
    from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer

    out = {}
    steps = {}
    root = tempfile.mkdtemp(prefix="prt_train_")
    fake = FakeLlamaServer().start()
    started = []
    try:
        # the two command-line runs side by side (each is mostly host
        # work: process start, encoder inits, files), then the in-process
        # parts alone, so that their step times see no other load
        t0 = time.perf_counter()
        started = [_phase1_start(root), _run_all_start(root, fake.url)]
        out["phase1"] = _phase1_check(dev, *started[0])
        out["run_all"] = _run_all_check(*started[1])
        steps["subprocesses"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        for name, fn in (("embedding", lambda: _train_embedding(dev, root)),
                         ("lora", lambda: _train_lora(qm, dev))):
            t0 = time.perf_counter()
            out[name] = fn()
            steps[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        import shutil

        fake.stop()
        for _, (proc, _) in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    out["step_s"] = steps
    out["launches"] = out["lora"]["launches"]
    log("train " + json.dumps(out))
    return out


# -- phase 17: the parallel layer on a mesh ----------------------------------

PAR_Q = 64               # queries of each sharded search (the 2-D route:
                         # 32 a data shard)
PAR_K = 10
PAR_LEX_B = (64, 512)    # C's per-term batch (#10 / #11), then its union
                         # batch (#12 / #13)
PAR_REQUESTS = 8         # /search requests to the mesh system
PAR_ENCODE = 512         # A's chunks encoded data-parallel
PAR_EMB_TOL = 1e-5       # data-parallel vs single-device embeddings
PAR_TRAIN_STEPS = 2
PAR_TP = 2               # the decoder's tensor-parallel width (module
                         # docstring of the phase: why 2)
PAR_TP_TOKENS = 16
PAR_TP_PROMPTS = 2
PAR_TP_MAX_LEN = 256
PAR_IVF_SLACK = 0.005    # sharded IVF recall may trail the single probe's
                         # by near-ties alone


def _par_mesh(corpus: int, data: int, dev):
    """A (corpus, data) mesh: distinct cards where the host has that many,
    else `dev` repeated. Returns (mesh, "distinct" | "repeated")."""
    from persian_rag_tpu_torch.core.mesh import build_mesh

    n = corpus * data
    if torch.cuda.device_count() >= n > 1:
        return build_mesh(corpus, data), "distinct"
    return build_mesh(corpus, data, devices=[dev] * n), "repeated"


def _dense_counts(ft) -> dict:
    return {"bf16": ft.extract_candidates_bf16_cuda.launches,
            "bf16x2": ft.extract_candidates_bf16x2_cuda.launches,
            "extract_candidates_int8": ft.extract_candidates_int8_cuda.launches}


def _dense_reset(ft) -> None:
    for fn in (ft.extract_candidates_bf16_cuda,
               ft.extract_candidates_bf16x2_cuda,
               ft.extract_candidates_int8_cuda):
        fn.launches = 0


def _ivf_on(index, mesh):
    """The IVF state of `index` on `mesh` (cells sharded over its corpus
    axis), without retraining."""
    from persian_rag_tpu_torch.index.ivf import IVFIndex

    out = IVFIndex(index.dim, n_cells=index.n_cells, nprobe=index.nprobe,
                   metric=index.metric, mesh=mesh)
    out.centroids = index.centroids.to(mesh.device)
    has_ovf = index._overflow is not None
    out._set_storage(
        index._cells.cpu().numpy(), index._cell_ids.cpu().numpy(),
        index._overflow.cpu().numpy() if has_ovf else None,
        index._overflow_ids.cpu().numpy() if has_ovf else None)
    out._ntotal = index.ntotal
    return out


def _sharded_ivf_near_ties(q, ids, cpu_ids, cpu) -> int:
    """Rows whose sharded IVF lists on the card and on the CPU differ;
    each must part at an f32 near-tie (`_ivf_near_ties`' bound): of the
    listed rows' f64 distances, or of some shard's local probe (its
    nprobe-th and next centroid)."""
    rows = (ids != cpu_ids).any(dim=1).nonzero().flatten()
    if rows.numel() == 0:
        return 0
    q64 = q[rows].double()
    dist = lambda i: torch.from_numpy(cpu.rows(i.reshape(-1).numpy())).double(
        ).reshape(*i.shape, -1).sub(q64[:, None, :]).pow(2).sum(-1)
    got, ref = dist(ids[rows].clamp(min=0)), dist(cpu_ids[rows].clamp(min=0))
    cmax = float(cpu._cell_sq.max().sqrt())
    tol = 2 * (q.shape[1] + 3) * 2.0 ** -24 * (q64.norm(dim=1) + cmax) ** 2
    tied = (got - ref).abs().max(dim=1).values <= tol
    for cent, *_ in cpu._sharded:
        c = ((cent.double()[None] - q64[:, None, :]) ** 2).sum(-1)
        c = c.sort(dim=1).values
        p = min(cpu.nprobe, c.shape[1])
        if p < c.shape[1]:
            tied |= (c[:, p] - c[:, p - 1]) <= tol
    if not bool(tied.all()):
        raise AssertionError(
            f"sharded IVF lists on the card differ from the CPU's past a "
            f"near-tie: {ids[rows][~tied].tolist()} against "
            f"{cpu_ids[rows][~tied].tolist()}")
    return int(rows.numel())


def _par_dense(enc, chunks, vectors, rng, ft, mesh, RetrievalSystem,
               RetrievalServer) -> tuple:
    """A's vectors in RetrievalSystem(mesh=) on a (2, 2) mesh: the sharded
    search of PAR_Q queries (the 2-D route) and of one (the 1-D route),
    held to the f32 scan; PAR_REQUESTS /search requests through
    RetrievalServer, each equal to the system's own answer in process and
    held to the scan. Returns (readings, the system)."""
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder

    dp_enc = SentenceEncoder(
        enc.config, state_dict=enc.encoder.state_dict(),
        head_state_dict=enc.head.state_dict(), tokenizer=enc.tokenizer,
        max_seq_len=enc.max_seq_len, mesh=mesh)
    t0 = time.perf_counter()
    rs = RetrievalSystem(method="dense", encoder=dp_enc, dense_metric="l2",
                         mesh=mesh)
    if not rs.load_chunks_and_index(chunks, embeddings=vectors):
        raise AssertionError("load_chunks_and_index failed on the mesh")
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    index = rs.dense_index
    shards = index._shards["corpus"]
    out["shard_rows"] = [int(row[0].shape[0]) for row in shards]
    out["stage1_mode"] = index._stage1_mode
    corpus = index.fused_args().corpus
    q = dp_enc.encode_device(make_queries([PAR_Q], rng)[0])
    _dense_reset(ft)
    _, ids = index.search_device(q, PAR_K)
    torch.cuda.synchronize()
    out["launches"] = _dense_counts(ft)
    out["search_ms"] = host_median_ms(
        lambda: index.search_device(q, PAR_K)[1].cpu(), runs=5)
    _, ref = ft.flat_topk_ref(q, corpus, PAR_K, metric="l2")
    out["near_tie_rows"], _, _ = near_tie_rows(q, corpus, ids, ref)
    _, one = index.search_device(q[:1], PAR_K)
    near1, _, _ = near_tie_rows(q[:1], corpus, one, ref[:1])
    out["near_tie_rows"] += near1
    if out["near_tie_rows"] > NEAR_TIE_SHARE * (PAR_Q + 1):
        raise AssertionError(f"mesh dense: too many near-tie rows: {out}")
    if out["launches"][out["stage1_mode"]] < 2 * len(shards):
        raise AssertionError(f"the shards did not each run stage 1: {out}")
    out["search_ms_1d"] = host_median_ms(
        lambda: index.search_device(q[:1], PAR_K)[1].cpu(), runs=5)
    # /search through RetrievalServer
    row_of = {c["id"]: i for i, c in enumerate(chunks)}
    _dense_reset(ft)
    served = near = 0
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        for batch in make_queries(
                [int(v) for v in rng.choice(REQUEST_SIZES,
                                            size=PAR_REQUESTS)], rng):
            resp = _post(server.url + "/search", {"queries": batch,
                                                  "top_k": PAR_K})
            want = rs.retrieve_batch(batch, PAR_K)
            got = [[row_of[h["id"]] for h in hits] for hits in resp["results"]]
            if got != [[row_of[c["id"]] for c, _ in r] for r in want]:
                raise AssertionError("a /search answer on the mesh differs "
                                     "from the system's own")
            emb = dp_enc.encode_device(batch)
            _, ref = ft.flat_topk_ref(emb, corpus, PAR_K, metric="l2")
            near += near_tie_rows(emb, corpus,
                                  torch.tensor(got, device=emb.device),
                                  ref)[0]
            served += len(batch)
    out["served_launches"] = _dense_counts(ft)
    out["served_queries"] = served
    out["served_near_tie_rows"] = near
    if near > NEAR_TIE_SHARE * served or not sum(
            out["served_launches"].values()):
        raise AssertionError(f"mesh /search: {out}")
    return out, rs


def _par_int8(vectors, q, ft, mesh) -> dict:
    """E's tier (cosine, int8 + refine) at corpus 4: each shard's rows
    through #4, the refined scores exact, Recall@k as E's floor asks."""
    from persian_rag_tpu_torch.index.dense import DenseIndex

    t0 = time.perf_counter()
    e = DenseIndex(DIM, metric="cosine", storage_dtype=torch.int8, mesh=mesh)
    e.add(vectors)
    e.commit()
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "shard_rows": [int(r[0].shape[0]) for r in e._shards["corpus"]]}
    _dense_reset(ft)
    t0 = time.perf_counter()
    scores, ids = e.search_device(q, PAR_K)
    torch.cuda.synchronize()
    out["search_ms"] = 1e3 * (time.perf_counter() - t0)
    out["launches"] = _dense_counts(ft)
    normed = e.fused_args().refine_corpus
    qn = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
    exact = torch.einsum("qd,qkd->qk", qn.double(), normed[ids].double())
    out["score_err"] = float((scores.double() - exact).abs().max())
    ref = ft.flat_topk_ref(qn, normed, PAR_K)[1]
    out["recall_at_k"] = float((ids[:, :, None] == ref[:, None, :]).any(1)
                               .float().mean())
    if out["score_err"] > 1e-5 or out["recall_at_k"] < 0.99:
        raise AssertionError(f"mesh int8 tier: {out}")
    if out["launches"]["extract_candidates_int8"] < len(out["shard_rows"]):
        raise AssertionError(f"a shard skipped the int8 kernel: {out}")
    return out


def _par_lexical(bm, vocab, rng, ss, mesh) -> dict:
    """C's BM25 ELL at corpus 4 (every bucket sharded; each shard in the
    layout its rows get alone): a per-term batch (#10 / #11) and a union
    batch (#12 / #13), held to the f64 scorer and to the single-device
    lists (near-ties aside)."""
    from persian_rag_tpu_torch.index.lexical import BM25Index, _Bucket

    t0 = time.perf_counter()
    sharded = BM25Index(mesh=mesh)
    sharded.vocab = bm.vocab
    if bm._buckets is None:
        sharded._set_ell(bm.doc_ids, bm.doc_vals)
    else:
        sharded._set_buckets([_Bucket(b.ids, b.vals, b.gids)
                              for b in bm._buckets], bm.ntotal)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    layouts = (sharded._shards if sharded._buckets is None
               else [s for b in sharded._buckets for s in b.shards])
    out["hashed_shards"] = sum(lay[0].dim() == 3 for lay, _ in layouts)
    x, vmax = f64_matrix(bm)
    out["launches"] = {name: 0 for name in ss.KERNELS}
    for b, kernel in zip(PAR_LEX_B, ("flat", "union")):
        terms = [bm._query_terms(t)
                 for t in lexical_queries([b], vocab, rng)[0]]
        sharded.batch_kernel = bm.batch_kernel = kernel
        _reset(ss)
        t0 = time.perf_counter()
        s, i = sharded._search_device(terms, PAR_K)
        torch.cuda.synchronize()
        out[f"search_ms_B{b}"] = 1e3 * (time.perf_counter() - t0)
        for name, n in _counts(ss).items():
            out["launches"][name] += n
        s, i = s.cpu().numpy(), i.cpu().numpy()
        out[f"check_B{b}"] = check_lexical(bm, x, vmax, terms, i, s)
        _, one = bm._search_device(terms, PAR_K)
        out[f"differ_from_single_B{b}"] = int(
            (one.cpu().numpy() != i).any(axis=1).sum())
    sharded.batch_kernel = bm.batch_kernel = None
    missing = [n for n, c in out["launches"].items() if c == 0]
    if missing:
        raise AssertionError(f"the sharded BM25 never launched {missing}: "
                             f"{out}")
    return out


def _par_ivf(ivf, q, vectors, ft, mesh, dev) -> dict:
    """A-IVF's cells at corpus 4 (the state the ingest phase built and
    calibrated): the card's sharded lists equal the CPU's sharded search
    of the same state, near-ties aside, and their Recall@10 of the f32
    scan is at least the single-device probe's."""
    from persian_rag_tpu_torch.core.mesh import build_mesh

    t0 = time.perf_counter()
    card = _ivf_on(ivf, mesh)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "nprobe": card.nprobe,
           "cells": card.n_cells}
    cpu = _ivf_on(ivf, build_mesh(mesh.shape["corpus"], 1,
                                  devices=["cpu"] * mesh.shape["corpus"]))
    t0 = time.perf_counter()
    _, ids = card.search_device(q, PAR_K)
    torch.cuda.synchronize()
    out["search_ms"] = 1e3 * (time.perf_counter() - t0)
    _, cpu_ids = cpu.search_device(q.cpu(), PAR_K)
    out["cpu_differ_rows"] = _sharded_ivf_near_ties(
        q.cpu(), ids.cpu(), cpu_ids, cpu)
    corpus = torch.from_numpy(np.ascontiguousarray(vectors)).to(dev)
    _, want = ft.flat_topk_ref(q, corpus, PAR_K, metric="l2")
    del corpus
    _, single = ivf.search_device(q, PAR_K)

    def recall(got):
        return float((got[:, :, None] == want[:, None, :]).any(1).float()
                     .mean())

    out["recall_at_10"], out["single_recall_at_10"] = recall(ids), recall(
        single)
    if (out["cpu_differ_rows"] > INGEST_DIFFER_SHARE * q.shape[0] + 1
            or out["recall_at_10"] < out["single_recall_at_10"]
            - PAR_IVF_SLACK):
        raise AssertionError(f"mesh IVF: {out}")
    return out


def _par_encode_train(enc, chunks, dp_enc, dev) -> dict:
    """A data-parallel MiniLM `encode` (data 2) held to the single-device
    encoder, then PAR_TRAIN_STEPS data-parallel EmbeddingTrainer steps
    held to the same steps on one device (TRAIN_* limits)."""
    from persian_rag_tpu_torch.data.loader import synthetic_persian_qa
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.train import EmbeddingTrainer

    texts = [c["text"] for c in chunks[:PAR_ENCODE]]
    t0 = time.perf_counter()
    got = dp_enc.encode(texts, batch_size=64)
    out = {"encode_s": time.perf_counter() - t0}
    out["encode_err"] = float(np.abs(got - enc.encode(texts, batch_size=64))
                              .max())
    if out["encode_err"] > PAR_EMB_TOL:
        raise AssertionError(f"data-parallel encode: {out}")
    one = SentenceEncoder(
        enc.config, state_dict=enc.encoder.state_dict(),
        head_state_dict=enc.head.state_dict(), tokenizer=enc.tokenizer,
        max_seq_len=enc.max_seq_len, device=dev)
    trainers = [EmbeddingTrainer(dp_enc, seed=SEED),
                EmbeddingTrainer(one, seed=SEED)]
    examples = trainers[0].prepare_training_data(
        synthetic_persian_qa(seed=SEED))
    opts = [t.make_optimizer(TRAIN_LR, 1, PAR_TRAIN_STEPS) for t in trainers]
    losses = []
    t0 = time.perf_counter()
    for step in range(PAR_TRAIN_STEPS):
        batch = examples[step * TRAIN_BATCH:(step + 1) * TRAIN_BATCH]
        losses.append([float(t.train_step(*o, batch))
                       for t, o in zip(trainers, opts)])
    out["train_s"] = time.perf_counter() - t0
    out["losses"] = losses
    out["loss_err"] = max(abs(a - b) for a, b in losses)
    out["param_err"] = max(
        float((a - b).detach().abs().max()) for a, b in zip(
            trainers[0].parameters(), trainers[1].parameters()))
    if out["loss_err"] > TRAIN_LOSS_TOL or out["param_err"] > TRAIN_PARAM_TOL:
        raise AssertionError(f"data-parallel training: {out}")
    return out


def _par_tp(qm, dev) -> dict:
    """G's int8 Llama-3.2-1B (the same seed's weights) split at TP 2:
    prefill logits within G's limit of the single-device forward, and 16
    greedy tokens of each prompt equal. At TP 2 every projection shard
    keeps a kernel route (the vocabulary shard 64,128 = 501 x 128); at 4
    the lm_head's 32,064 columns would not (the JAX gate)."""
    from persian_rag_tpu_torch.gen.generator import TextGenerator
    from persian_rag_tpu_torch.models.decoder import (
        DecoderConfig, random_quantized_params)

    cfg = DecoderConfig.llama32_1b(compute_dtype=torch.bfloat16,
                                   quantized_weights=True)
    params = random_quantized_params(cfg, seed=SEED, device=dev)
    mesh, _ = _par_mesh(PAR_TP, 1, dev)
    kw = dict(params=params, tokenizer=word_tokenizer(),
              max_len=PAR_TP_MAX_LEN)
    t0 = time.perf_counter()
    tp = TextGenerator(cfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    single = TextGenerator(cfg, device=dev, **kw)
    m = tp.model
    shapes = {
        "q_proj": m.attn[0][0].block.q_proj.values.shape,
        "k_proj": m.attn[0][0].block.k_proj.values.shape,
        "o_proj": m.attn[0][0].block.o_proj.dense.values.shape,
        "gate_proj": m.mlp[0][0].block.gate_proj.values.shape,
        "down_proj": m.mlp[0][0].block.down_proj.dense.values.shape,
        "lm_head": m.embed[0][1]["values"].shape,
    }
    out["routes"] = {name: {"K": int(s[1] if name == "lm_head" else s[0]),
                            "N": int(s[0] if name == "lm_head" else s[1]),
                            "route": qm.kernel_route(
                                1, int(s[1] if name == "lm_head" else s[0]),
                                int(s[0] if name == "lm_head" else s[1]),
                                nt=name == "lm_head")}
                     for name, s in shapes.items()}
    rng = np.random.default_rng(SEED + 4)
    prompts = [gen_prompt(rng, int(n)) for n in rng.integers(24, 48, size=8)]
    prompt_ids = [tp.tokenizer.encode(p) for p in prompts[:PAR_TP_PROMPTS]]
    with torch.no_grad():
        for gen_ in (tp, single):
            gen_.generate_ids_device(prompt_ids[0], max_tokens=2,
                                     speculative=False)  # warm-up
        ids = torch.tensor([prompt_ids[0]], device=dev)
        last = torch.tensor([ids.shape[1] - 1], device=dev)
        logits = [g.model(ids, last_positions=last).float()
                  for g in (tp, single)]
    out["logit_err"] = float((logits[0] - logits[1]).abs().max())
    _quant_reset(qm)
    t0 = time.perf_counter()
    streams = [tp.generate_ids_device(p, max_tokens=PAR_TP_TOKENS,
                                      speculative=False) for p in prompt_ids]
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    out["launches"] = _quant_counts(qm)
    t0 = time.perf_counter()
    want = [single.generate_ids_device(p, max_tokens=PAR_TP_TOKENS,
                                       speculative=False)
            for p in prompt_ids]
    torch.cuda.synchronize()
    out["single_decode_s"] = time.perf_counter() - t0
    out["streams_equal"] = streams == want
    out["tokens"] = sum(len(s) for s in streams)
    if out["logit_err"] > GEN_LOGIT_TOL or not out["streams_equal"]:
        raise AssertionError(f"TP {PAR_TP}: {out}, {streams} vs {want}")
    for name in ("w8a16", "w8a16_nt"):
        if out["launches"][name] == 0:
            raise AssertionError(f"TP {PAR_TP} never launched {name}: {out}")
    return out


def parallel_phase(enc, chunks, vectors, rng, ft, ss, qm, bm, vocab, ivf,
                   dev, RetrievalSystem, RetrievalServer) -> dict:
    """Phase 17, the parallel layer (`core.mesh`, `parallel.*`) at full
    width on meshes of the card (distinct cards where the host has them,
    else cuda:0 repeated): A's MiniLM vectors on a (2, 2) mesh behind
    RetrievalServer (stage 1 on each 50,000-row shard), E's int8 tier,
    C's BM25 ELL and A-IVF's cells at corpus 4, a data-parallel encode
    and EmbeddingTrainer steps at data 2, and G's decoder at TP 2. Every
    part counts the launches of the kernels its shards reach."""
    mesh22, kind = _par_mesh(2, 2, dev)
    mesh4, _ = _par_mesh(4, 1, dev)
    log("parallelmesh " + json.dumps({
        "devices": kind, "cards": torch.cuda.device_count(),
        "mesh22": [[str(d) for d in r] for r in mesh22.devices]}))
    out = {"devices": kind}

    def part(name, value):
        out[name] = value
        log(f"parallel_{name} " + json.dumps(value))

    dense, rs = _par_dense(enc, chunks, vectors, rng, ft, mesh22,
                           RetrievalSystem, RetrievalServer)
    part("dense", dense)
    q = rs.embedding_model.encode_device(make_queries([PAR_Q], rng)[0])
    part("int8", _par_int8(vectors, q, ft, mesh4))
    part("lexical", _par_lexical(bm, vocab, rng, ss, mesh4))
    part("ivf", _par_ivf(ivf, q, vectors, ft, mesh4, dev))
    dp_enc = rs.embedding_model
    rs.cleanup()
    torch.cuda.empty_cache()
    part("encode_train", _par_encode_train(enc, chunks, dp_enc, dev))
    del dp_enc
    torch.cuda.empty_cache()
    part("tp", _par_tp(qm, dev))
    torch.cuda.empty_cache()
    launches = {}
    for part in (out["dense"]["launches"], out["dense"]["served_launches"],
                 out["int8"]["launches"], out["lexical"]["launches"],
                 out["tp"]["launches"]):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    log("parallel " + json.dumps({"devices": kind, "launches": launches}))
    return out


def gen_readings(seeds) -> int:
    """`python3 chip_smoke.py --gen-readings 0 1 2`: phases 10, 11 and 12
    alone, 11 and 12 once per weight and prompt seed, with the limits on
    logit differences and near ties reported but not enforced. The GEN_*
    limits of G and the H_* limits of H are set from these readings."""
    global SEED, GEN_LOGIT_TOL, GEN_LOGIT_TOL_F32, GEN_NEAR_TIE
    global GEN_NEAR_TIE_SHARE, H_LOGIT_TOL, H_LOGIT_TOL_F32, H_NEAR_TIE
    global H_NEAR_TIE_SHARE
    from persian_rag_tpu_torch.core.device import card_info, require_cuda

    require_cuda()
    from persian_rag_tpu_torch.ops import quant_matmul as qm
    from persian_rag_tpu_torch.serve.api import RetrievalServer

    log(card_info()["nvidia_smi"])
    dev = torch.device("cuda", 0)
    quant_kernel_phase(qm, dev)
    GEN_LOGIT_TOL = GEN_LOGIT_TOL_F32 = GEN_NEAR_TIE = float("inf")
    H_LOGIT_TOL = H_LOGIT_TOL_F32 = H_NEAR_TIE = float("inf")
    GEN_NEAR_TIE_SHARE = H_NEAR_TIE_SHARE = 1.0
    with multiprocessing.get_context("spawn").Pool(CLIENTS) as pool:
        for seed in seeds:
            SEED = seed  # of the weights and of the prompts
            out = gen_phase(qm, dev, pool, RetrievalServer)
            gaps = [v["gap"] for v in out["greedy_routes"].values()] + [
                v["gap"] for v in
                out["served_groups"]["parted_with_plain"].values()]
            log("genreading " + json.dumps({
                "deployment": "G", "seed": SEED,
                "logit_err_bf16": out["kernel_vs_plain_logits"]["max_abs_err"],
                "logit_err_f32":
                    out["kernel_vs_plain_logits_f32"]["max_abs_err"],
                "parted": out["near_tie_streams"]["parted"],
                "compared": out["near_tie_streams"]["compared"],
                "largest_gap": max(gaps, default=0.0)}))
            torch.cuda.empty_cache()
            out = h_phase(qm, dev, pool, g_served=out["served"])
            gaps = [v["gap"] for v in out["greedy_routes"].values()] + [
                v["gap"] for v in out["parted_with_plain"].values()]
            log("genreading " + json.dumps({
                "deployment": "H", "seed": SEED,
                "logit_err_bf16": out["kernel_vs_plain_logits"]["max_abs_err"],
                "logit_err_f32":
                    out["kernel_vs_plain_logits_f32"]["max_abs_err"],
                "parted": out["near_tie_streams"]["parted"],
                "compared": out["near_tie_streams"]["compared"],
                "largest_gap": max(gaps, default=0.0)}))
            torch.cuda.empty_cache()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--gen-readings"]:
        return gen_readings([int(a) for a in sys.argv[2:]])
    t_start = time.perf_counter()
    from persian_rag_tpu_torch.core.device import card_info, require_cuda

    require_cuda()
    from persian_rag_tpu_torch.index.dense import DenseIndex
    from persian_rag_tpu_torch.models.encoder import EncoderConfig
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.ops import _build
    from persian_rag_tpu_torch.ops import flat_topk as ft
    from persian_rag_tpu_torch.ops import quant_matmul as qm
    from persian_rag_tpu_torch.ops import sparse_scores as ss
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
    from persian_rag_tpu_torch.serve.api import RetrievalServer

    info = card_info()
    log(f"device {json.dumps(info)}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build {json.dumps({'seconds': time.perf_counter() - t0, 'nvcc_seconds': _build.build_seconds, 'library': str(_build.library_path().relative_to(_build.BUILD_ROOT.parent.parent))})}")

    kernels = run_phase("kernel", kernel_phase, ft)
    dev = torch.device("cuda", 0)
    run_phase("x2edge", x2_edge_phase, ft, dev)
    run_phase("bf16edge", bf16_edge_phase, ft, dev)
    width = run_phase("width", width_phase, ft, dev, DenseIndex)
    tier_kernels = run_phase("tierkernel", tier_kernel_phase, ft, dev)
    modes = run_phase("modes", kernel_modes_phase, ft, dev)
    quant_kernels = run_phase("quantkernel", quant_kernel_phase, qm, dev)
    matvec = run_phase("matvec", matvec_probe_phase, qm, dev)

    rng = np.random.default_rng(SEED)
    enc = SentenceEncoder(
        EncoderConfig.minilm_l12(), max_seq_len=128, device="cuda", seed=SEED
    )
    chunks = make_chunks(N_CORPUS, rng)
    # the probe picks one stage-1 kernel for this corpus; a second
    # deployment of the same encoder-made vectors is forced onto the
    # other, so the served path runs both kernels
    with multiprocessing.get_context("spawn").Pool(CLIENTS) as pool:
        first, rs = run_phase("serve_A", serve_phase, enc, chunks, rng,
                              ft, RetrievalSystem, RetrievalServer, pool)
        if first["stage1_mode"] == "scan":
            raise AssertionError("the commit probe routed the corpus to scan")
        other = "bf16" if first["stage1_mode"] == "bf16x2" else "bf16x2"
        vectors = rs.dense_index.vectors()
        # generation, with /rag answered over deployment A; then int4
        # generation behind the continuous scheduler under the same traffic
        gen = run_phase("gen", gen_phase, qm, dev, pool, RetrievalServer,
                        retriever=rs)
        h = run_phase("genH", h_phase, qm, dev, pool, g_served=gen["served"])
        rs.cleanup()
        second, rs = run_phase("serve_B", serve_phase, enc, chunks, rng,
                               ft, RetrievalSystem, RetrievalServer, pool,
                               embeddings=vectors, stage1=other)
        rs.cleanup()
        # the storage tiers over the same vectors
        tiers = run_phase("tiers", tier_phase, enc, chunks, vectors, rng,
                          ft, RetrievalSystem, RetrievalServer, pool, dev)
        # IVF over the same vectors, then the ingest path (PDF -> chunks ->
        # encoder -> index files) and its commands
        eval_root = tempfile.mkdtemp(prefix="prt_eval_")
        a_ivf = []
        ingest = run_phase("ingest", ingest_phase, enc, chunks, vectors, rng,
                           ft, pool, RetrievalSystem, RetrievalServer,
                           keep=eval_root, keep_ivf=a_ivf)
        # the evaluation pipelines and the UI over P3's chunks
        try:
            evaluate = run_phase("evaluate", evaluate_phase, eval_root, ft,
                                 ss, qm, dev)
        finally:
            import shutil

            shutil.rmtree(eval_root, ignore_errors=True)
        # lexical and hybrid deployments over their own seeded corpus
        lrng = np.random.default_rng(SEED + 1)
        vocab = lexical_vocab(lrng)
        lchunks = lexical_chunks(N_CORPUS, vocab, lrng)
        bm25, lex_kernels, lex_rs = run_phase(
            "lexical", lexical_serve_phase, lchunks, vocab, lrng, pool,
            RetrievalSystem, RetrievalServer, ss)
        union13 = run_phase("union13", union_hashed_phase,
                            lex_rs.bm25_index, vocab, lrng, ss)
        # the native builder, two-pass union serving (stage 1 of #12 and
        # #13), the hashed-UB prefilter (#1 at d = 1,024) and `serve` /
        # `status` from the command line, over C
        native = run_phase("native", native_phase, lchunks)
        twopass = run_phase("twopass", twopass_phase, lex_rs, lchunks, vocab,
                            lrng, ss, RetrievalSystem)
        prefilter = run_phase("prefilter", prefilter_phase, lex_rs, vocab,
                              lrng, ft)
        cli = run_phase("cli", cli_phase, lex_rs, lchunks, vocab, lrng, pool)
        # the parallel layer over A's vectors, C's ELL and A-IVF's cells
        par = run_phase("parallel", parallel_phase, enc, chunks, vectors,
                        rng, ft, ss, qm, lex_rs.bm25_index, vocab, a_ivf[0],
                        dev, RetrievalSystem, RetrievalServer)
        del vectors, a_ivf
        lex_rs.cleanup()
        hybrid = run_phase("hybrid", hybrid_phase, enc,
                           lchunks[:HYBRID_CHUNKS], vocab,
                           lrng, pool, RetrievalSystem, RetrievalServer, ss,
                           ft)
        del lchunks
        torch.cuda.empty_cache()
        # deployments loaded from files: A's encoder and a Q8_0 GGUF
        files = run_phase("files", files_phase, enc, chunks[:FILES_CHUNKS],
                          rng, ft, qm, pool, RetrievalSystem, RetrievalServer)
    # training: the embedding trainer, phase1 and LoRA at full width, then
    # run-all --tiny
    del enc
    torch.cuda.empty_cache()
    train = run_phase("train", train_phase, qm, dev)
    tier_runs = [tiers[name] for name in ("E", "F", "F_ungated", "in_process")
                 if name in tiers]
    total = {
        v: first["launches"][v] + second["launches"][v]
        + files["encoder"]["launches"][v]
        + hybrid["served_launches"][f"extract_candidates_{v}"]
        + sum(t["launches"][f"extract_candidates_{v}"] for t in tier_runs)
        + ingest["launches"][v] + evaluate["launches_total"][v]
        + par["launches"][v]
        for v in ("bf16", "bf16x2")
    }
    total["bf16"] += prefilter["candidates_launches"]  # #1 at d = 1,024
    for v in ("extract_candidates_int8", "running_exact", "running_fast"):
        total[v] = sum(t["launches"][v] for t in tier_runs)
    total["extract_candidates_int8"] += par["launches"][
        "extract_candidates_int8"]
    # the width phase's calls through DenseIndex
    for v, name in (("bf16", "extract_candidates_bf16_cuda"),
                    ("bf16x2", "extract_candidates_bf16x2_cuda"),
                    ("extract_candidates_int8", "extract_candidates_int8_cuda"),
                    ("running_exact", "flat_topk_running_exact_cuda"),
                    ("running_fast", "flat_topk_running_fast_cuda")):
        total[v] += width["launches"][name]
    total.update(modes["launches"])  # #3, #7, #8, #9 from their entry points
    total["extract_candidates_grouped"] += width["launches"][
        "extract_candidates_grouped_cuda"]
    total["w8a16_2d"] = matvec["launches"]  # #19 from the matvec probe
    for v, count in total.items():
        if count == 0:
            raise AssertionError(f"no served or in-process path launched the "
                                 f"{v} kernel")
    lex_total = {
        name: bm25["served_launches"][name] + bm25["big_top_k_launches"][name]
        + bm25["inproc_launches"][name] + bm25["tfidf_launches"][name]
        + hybrid["served_launches"][name]
        + evaluate["launches_total"][name] + par["launches"][name]
        for name in ss.KERNELS
    }
    for name, count in lex_total.items():
        if count == 0:
            raise AssertionError(f"no lexical path launched the {name} kernel")

    quant_launches = {name: gen["launches"][name] + h["launches"][name]
                      + files["launches"][name]
                      + evaluate["launches_total"][name]
                      + train["launches"][name] + par["launches"][name]
                      for name in qm.KERNELS}
    # #16 (w8a8) has no caller in the package: no served path launches it
    for name, count in quant_launches.items():
        if count == 0 and name != "w8a8":
            raise AssertionError(f"the served generation paths never launched "
                                 f"the {name} kernel")

    smi = info["nvidia_smi"]
    main_shape = {
        v: next(r for r in kernels[v] if r["Q"] == 64 and r["metric"] == "l2")
        for v in kernels
    }
    report = {"kernels": [
        {
            "name": "extract_candidates_bf16",
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/flat_topk_candidates_bf16.cu",
            "replaces": "persian_rag_tpu/ops/flat_topk.py:1197",
            "launches": total["bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in kernels["bf16"]),
            "ms": main_shape["bf16"]["ms"],
            "plain_ms": main_shape["bf16"]["plain_ms"],
            "bound_ms": main_shape["bf16"]["bound_ms"],
            "bound_by": main_shape["bf16"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "extract_candidates_bf16x2",
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/flat_topk_candidates_x2.cu",
            "replaces": "persian_rag_tpu/ops/flat_topk.py:1132",
            "launches": total["bf16x2"],
            "max_abs_err": max(r["max_abs_err"] for r in kernels["bf16x2"]),
            "ms": main_shape["bf16x2"]["ms"],
            "plain_ms": main_shape["bf16x2"]["plain_ms"],
            "bound_ms": main_shape["bf16x2"]["bound_ms"],
            "bound_by": main_shape["bf16x2"]["bound_by"],
            "library_ms": None,
        },
    ]}
    # #4 at a served dispatch's batch (64); #5 and #6 at the raw int8
    # tier's shape (100k row-scaled rows, k = 10)
    for name, key, source, line, pick in (
        ("extract_candidates_int8", "int8_candidates",
         "flat_topk_candidates_int8.cu", 1559, lambda r: r["Q"] == 64),
        ("flat_topk_running_exact", "running_exact",
         "flat_topk_running_select.cu", 676,
         lambda r: r["case"] == "int8 100k k=10"),
        ("flat_topk_running_fast", "running_fast",
         "flat_topk_running_select.cu", 840,
         lambda r: r["case"] == "int8 100k k=10"),
    ):
        rows = tier_kernels[key]
        at = next(r for r in rows if pick(r))
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"persian_rag_tpu_torch/csrc/{source}",
            "replaces": f"persian_rag_tpu/ops/flat_topk.py:{line}",
            "launches": total[
                key if key != "int8_candidates" else "extract_candidates_int8"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{x: at[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    # #3 at #1's shape (Q = 64, 100k, l2; group 16, tile 1,024); #7, #8 and
    # #9 at #5 / #6's (100k int8 row-scaled rows, k = 10)
    for name, key, line, pick in (
        ("extract_candidates_grouped", "grouped", 1304,
         lambda r: r["Q"] == 64 and r["metric"] == "l2"),
        ("flat_topk_running_insert", "running_insert", 956,
         lambda r: r["case"] == "int8 100k k=10"),
        ("flat_topk_running_group", "running_group", 1035,
         lambda r: r["case"] == "int8 100k k=10"),
        ("flat_topk_running_maxonly", "running_maxonly", 1600,
         lambda r: r["case"] == "int8 100k k=10"),
    ):
        rows = modes[key] + ([modes["lane"]] if key == "grouped" else [])
        at = next(r for r in rows if pick(r))
        count_key = {"grouped": "extract_candidates_grouped"}.get(key, key)
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/" + {
                "grouped": "grouped_candidates.cuh",
                "running_maxonly": "flat_topk_maxonly.cu"}.get(
                    key, "segment_topk.cuh"),
            "replaces": f"persian_rag_tpu/ops/flat_topk.py:{line}",
            "launches": total[count_key],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{x: at[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    # the per-term kernels at a served dispatch's batch (64), the union
    # kernels at the batch that crosses the union gate in process (512)
    for name, line, main_b in (
        ("sparse_topk", 138, 64), ("sparse_topk_hashed", 351, 64),
        ("sparse_topk_union", 612, 512), ("sparse_topk_union_hashed", 960, 512),
    ):
        rows = lex_kernels[name]
        at = next(r for r in rows if r["B"] == main_b)
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/sparse_topk.cu",
            "replaces": f"persian_rag_tpu/ops/sparse_scores.py:{line}",
            "launches": lex_total[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{x: at[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    # stage 1 of #12 (C16's flat ELL) and #13 (C's hashed bucket) at the
    # two-pass batch of 512, launches from two-pass serving
    for name, line in (("sparse_topk_union", 663),
                       ("sparse_topk_union_hashed", 1009)):
        rows = twopass["kernels"][name]
        at = [r for r in rows if r["B"] == 512][-1]
        report["kernels"].append({
            "name": name + "_stage1",
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/sparse_stage1.cu",
            "replaces": f"persian_rag_tpu/ops/sparse_scores.py:{line}",
            "launches": twopass["stage1_launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{x: at[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    # the quantized matmuls at the served shapes: 8 rows (a speculative
    # verify block, a full decode batch); #14 and #16 at the largest layer
    # shape, #18 at the down projection (the shape where it lost most)
    for name, (k, n) in (("w8a16", (2048, 8192)),
                         ("w8a16_nt", (2048, 128_256)),
                         ("w8a16_splitk", (8192, 2048)),
                         ("w4a16", (8192, 2048)),
                         ("w8a8", (2048, 8192))):
        rows = quant_kernels[name]
        at = next(r for r in rows if (r["K"], r["N"], r["B"]) == (k, n, 8))
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "persian_rag_tpu/ops/quant_matmul.py:"
                        f"{QUANT_SOURCE_LINES[name]}",
            "launches": quant_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{x: at[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        })
    # #19 at the down projection's JAX tile, 8 rows (#17's row)
    report["kernels"].append({
        "name": "w8a16_2d",
        "route": "cuda",
        "source": "persian_rag_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "scripts/bench_matvec_probe.py:72",
        "launches": matvec["launches"],
        "max_abs_err": matvec["max_abs_err"],
        **{x: matvec["main"][x] for x in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
    })
    # the launches of #1, #2, #4, #10-#13 (their C entries' choice) and
    # #14 (the chunks the wrapper passes its C entry) on the main path, and
    # the slots a pass of #10-#13 past one block's query slots
    log("geometry " + json.dumps({
        **{f"extract_candidates_{v}": [
            {"Q": r["Q"], **r["geometry"]} for r in kernels[v]
            if r["metric"] == "l2"] for v in ("bf16", "bf16x2")},
        "extract_candidates_int8": [
            {"Q": r["Q"], **r["geometry"]}
            for r in tier_kernels["int8_candidates"]],
        **{name: [{"B": r["B"], "T": r["T"], "N": r["N"], **r["geometry"]}
                  for r in lex_kernels[name] if "geometry" in r]
           for name in ("sparse_topk", "sparse_topk_union")},
        "sparse_topk_hashed": [{"B": r["B"], "T": r["T"], **r["geometry"]}
                               for r in lex_kernels["sparse_topk_hashed"]],
        "sparse_topk_union_hashed": [
            {"B": r["B"], "T": r["T"], **r["geometry"]}
            for r in union13["rows"]],
        "long_query_passes": {
            "T": union13["long"]["T"],
            **{name: r["slots_a_pass"]
               for name, r in union13["long"]["entries"].items()}},
        "w8a16": [{"K": r["K"], "N": r["N"], **r["geometry"]}
                  for r in quant_kernels["w8a16"] if r["B"] == 1],
    }))
    log("lexleftovers " + json.dumps({
        "native_s": native["native_s"], "python_s": native["python_s"],
        "twopass": twopass["served"], "stage1_launches":
            twopass["stage1_launches"],
        "prefilter": prefilter["rows"], "cli": {
            k: cli[k] for k in ("ready_s", "rows", "differ_near_tie",
                                "pid_listed", "card_mib")}}))
    log(f"wall {json.dumps({'seconds': time.perf_counter() - t_start})}")
    log(smi)
    log(json.dumps(report))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
