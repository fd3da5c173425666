"""Chip smoke test of persian_rag_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — dense exact retrieval served over HTTP — at
the full width of paraphrase-multilingual-MiniLM-L12-v2 (random weights
from a seed) over a 100,000-chunk Persian corpus, and checks it:

1. device: the card's name, capability and nvidia-smi power limit;
2. build: compiles the CUDA kernels from ``persian_rag_tpu_torch/csrc``;
3. kernel vs plain: both stage-1 candidate kernels against their plain
   PyTorch version at N=100,000, d=384, Q in {16, 64, 512}, l2 and dot: the
   extracted keys and bounds hold the proof contract, and the two-stage
   ids equal the full f32 scan's; median CUDA-event times of both;
4. end to end: a RetrievalServer answers /health, 440 /search requests
   of 1-16 queries (200 from one client, then 240 from 8 concurrent
   clients) and /rag; every served id list equals an exact f32 scan for
   the same query embeddings, and the candidate kernels' launch counters
   rose during this phase. It prints p50/p90 request latency of each
   phase and the concurrent phase's queries per second. The commit probe
   picks one stage-1 kernel for the encoded corpus; a second deployment
   of the same vectors is forced onto the other kernel.

It needs CUDA and exits non-zero without it (it never falls back to the
CPU). The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""
from __future__ import annotations

import json
import multiprocessing
import statistics
import sys
import time
import urllib.request

import numpy as np
import torch

N_CORPUS = 100_000
DIM = 384
SEED = 0
# the served /search load of each deployment
REQUEST_SIZES = (1, 2, 4, 8, 16)  # queries per request
SEQ_REQUESTS = 200  # one client, back to back
CLIENTS, PER_CLIENT = 8, 30  # closed-loop concurrent clients

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


def kernel_phase(ft) -> dict:
    """Both candidate kernels against the plain version at serving width."""
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
    lo = (centered - hi.float()).bfloat16()
    tile_n, n_easy = ft.TWO_STAGE_TILE_N, 4
    results = {"bf16": [], "bf16x2": []}
    for n_q in (16, 64, 512):
        idx = torch.randint(0, N_CORPUS, (n_q,), device=dev, generator=g)
        q = corpus[idx] + 0.3 * torch.randn(
            n_q, DIM, device=dev, generator=g
        ) / DIM ** 0.5
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        with ft.full_f32():
            ref_dot = q @ centered.T
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
                row = {
                    "variant": variant, "metric": metric, "Q": n_q,
                    "contract_margin": violation, "max_abs_err": max_err,
                    "tol": tol, "same_keys": same, "ms": ms,
                    "plain_ms": plain_ms, "proof_ok": float(ok.float().mean()),
                    "two_stage_ms": e2s_ms, "f32_scan_ms": ref_ms,
                }
                results[variant].append(row)
                log("kernel " + json.dumps(row))
    return results


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
                pool, embeddings=None, stage1=None):
    """Index the chunks, serve /health, /search and /rag, and check every
    served id list against an exact f32 scan of the same embeddings.

    The /search load: a warm-up request of each size, then SEQ_REQUESTS
    back to back from one client, then CLIENTS closed-loop clients sending
    PER_CLIENT requests each; every client is a process of `pool`. Sizes
    are drawn from REQUEST_SIZES, top_k from (5, 10). Returns (summary,
    the RetrievalSystem)."""
    t0 = time.perf_counter()
    rs = RetrievalSystem(method="dense", encoder=enc, dense_metric="l2")
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

    n_conc = CLIENTS * PER_CLIENT
    sizes = [int(v) for v in rng.choice(
        REQUEST_SIZES, size=SEQ_REQUESTS + n_conc)]
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
        dispatches0 = server.batches_served
        served = pool.apply(_client, (server.url, jobs[:SEQ_REQUESTS]))
        dispatches_seq = server.batches_served - dispatches0
        # client c sends requests SEQ_REQUESTS + c, + c + CLIENTS, ...
        t_conc = time.perf_counter()
        per_client = pool.starmap(_client, [
            (server.url, jobs[SEQ_REQUESTS + c :: CLIENTS])
            for c in range(CLIENTS)
        ])
        conc_s = time.perf_counter() - t_conc
        served += [
            per_client[c][j]
            for j in range(PER_CLIENT) for c in range(CLIENTS)
        ]
        dispatches_conc = (
            server.batches_served - dispatches0 - dispatches_seq)
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
    responses = [resp for resp, _ in served]
    latencies = [t for _, t in served]
    for batch, k, resp in zip(batches, top_ks, responses):
        if resp is None or len(resp["results"]) != len(batch):
            raise AssertionError(f"bad /search response {resp}")
        alone = enc.encode_device(batch)
        nearest = torch.cdist(alone, seen_emb).argmin(dim=1).tolist()
        for hits, j in zip(resp["results"], nearest):
            got = [row_of[h["id"]] for h in hits]
            if len(got) != k or not all(np.isfinite(h["score"]) for h in hits):
                raise AssertionError(f"bad hits {hits}")
            if got != seen_ids[j][:k]:
                raise AssertionError("served ids differ from the f32 scan")
            n_checked += 1
    seq_ms = [1e3 * t for t in latencies[:SEQ_REQUESTS]]
    conc_ms = [1e3 * t for t in latencies[SEQ_REQUESTS:]]
    n_conc_queries = sum(sizes[SEQ_REQUESTS:])
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
        "index_build_s": build_s,
        "seq_requests": SEQ_REQUESTS,
        "seq_p50_ms": _percentile(seq_ms, 50),
        "seq_p90_ms": _percentile(seq_ms, 90),
        "seq_dispatches": dispatches_seq,
        "conc_clients": CLIENTS,
        "conc_requests": n_conc,
        "conc_p50_ms": _percentile(conc_ms, 50),
        "conc_p90_ms": _percentile(conc_ms, 90),
        "conc_qps": n_conc_queries / conc_s,
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


def main() -> int:
    from persian_rag_tpu_torch.core.device import card_info, require_cuda

    require_cuda()
    from persian_rag_tpu_torch.models.encoder import EncoderConfig
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.ops import _build
    from persian_rag_tpu_torch.ops import flat_topk as ft
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
    from persian_rag_tpu_torch.serve.api import RetrievalServer

    info = card_info()
    log(f"device {json.dumps(info)}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build {json.dumps({'seconds': time.perf_counter() - t0, 'nvcc_seconds': _build.build_seconds, 'library': str(_build.library_path().relative_to(_build.BUILD_ROOT.parent.parent))})}")

    kernels = kernel_phase(ft)

    rng = np.random.default_rng(SEED)
    enc = SentenceEncoder(
        EncoderConfig.minilm_l12(), max_seq_len=128, device="cuda", seed=SEED
    )
    chunks = make_chunks(N_CORPUS, rng)
    # the probe picks one stage-1 kernel for this corpus; a second
    # deployment of the same encoder-made vectors is forced onto the
    # other, so the served path runs both kernels
    with multiprocessing.get_context("spawn").Pool(CLIENTS) as pool:
        first, rs = serve_phase(enc, chunks, rng, ft, RetrievalSystem,
                                RetrievalServer, pool)
        if first["stage1_mode"] == "scan":
            raise AssertionError("the commit probe routed the corpus to scan")
        other = "bf16" if first["stage1_mode"] == "bf16x2" else "bf16x2"
        vectors = rs.dense_index.vectors()
        rs.cleanup()
        second, _ = serve_phase(enc, chunks, rng, ft, RetrievalSystem,
                                RetrievalServer, pool, embeddings=vectors,
                                stage1=other)
    total = {
        v: first["launches"][v] + second["launches"][v]
        for v in ("bf16", "bf16x2")
    }
    for v, count in total.items():
        if count == 0:
            raise AssertionError(f"the served path never launched the {v} kernel")

    smi = info["nvidia_smi"]
    main_shape = {
        v: next(r for r in kernels[v] if r["Q"] == 64 and r["metric"] == "l2")
        for v in kernels
    }
    report = {"kernels": [
        {
            "name": "extract_candidates_bf16",
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/flat_topk_candidates.cu",
            "replaces": "persian_rag_tpu/ops/flat_topk.py:1197",
            "launches": total["bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in kernels["bf16"]),
            "ms": main_shape["bf16"]["ms"],
            "plain_ms": main_shape["bf16"]["plain_ms"],
        },
        {
            "name": "extract_candidates_bf16x2",
            "route": "cuda",
            "source": "persian_rag_tpu_torch/csrc/flat_topk_candidates.cu",
            "replaces": "persian_rag_tpu/ops/flat_topk.py:1132",
            "launches": total["bf16x2"],
            "max_abs_err": max(r["max_abs_err"] for r in kernels["bf16x2"]),
            "ms": main_shape["bf16x2"]["ms"],
            "plain_ms": main_shape["bf16x2"]["plain_ms"],
        },
    ]}
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
