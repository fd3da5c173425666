"""Device times and outputs of the lexical kernels, for comparing two
revisions of the port on the card in one call.

Host and device times move between calls to the card (PERF.md section 5),
so a kernel change is read only beside the version it replaces, on one card
in one call. This script measures the wrappers of whichever
``persian_rag_tpu_torch`` comes first on the import path: run it by path,
once per tree, in one command to the card, in the order other, this, this,
other:

    git archive <rev> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 persian_rag_tpu_torch/scripts/lex_ab.py \\
          --label $t --save build/lex_ab/$(basename $(realpath $t)).json
    done
    python3 persian_rag_tpu_torch/scripts/lex_ab.py \\
        --compare build/lex_ab/parent.json build/lex_ab/repo.json

A run builds the BM25 deployment C of ``chip_smoke.py`` (its 100,000 seeded
Persian chunks, read from the ``chip_smoke.py`` beside this script's
package, never from the path) with the package on the path, and times #11
``sparse_topk_hashed_cuda`` on the index's largest hashed bucket and #10
``sparse_topk_cuda`` on its largest flat bucket, at the query batches of
``chip_smoke.py``'s lexkernel lines (B in 1, 16, 64, 512, k = 10, the
queries drawn as that phase draws them), then #10 on each of C's other flat
buckets at B = 1 and 16, then the union kernels at the in-process batches
that cross the union gate (``UNION_BATCHES``, B = 128 and 512, drawn as
``lexical_serve_phase`` draws them): #12 ``sparse_topk_union_cuda`` on the
largest flat bucket, #13 ``sparse_topk_union_hashed_cuda`` on the largest
hashed one, and the per-term kernels on the same buckets and queries (the
union gate's two sides: #10 flat, #11 hashed), then #12 and #13 on the
union edge request (``union_edge_batch``); the union kernels' outputs are
also hashed at k = 200. A ``time`` line each gives the CUDA-event median of the whole
wrapper (kernel, prep and tile merge), beside the bound (the bucket and the
queries read once, or a multiply-add for each (query term, document holding
it) at the f32 rate), the device time of the kernel alone and of the whole
call (torch.profiler), the host time of one call (the card idle at its
start) and, where the tree has its geometry entry, the launch #10's (and
#12's) C entry picks; a union line also gives the batch's distinct terms
``U`` and their chunks of 64. ``--save`` writes a hash of every output, and
``--compare`` names the outputs two saved runs share bit for bit.
Correctness is ``chip_smoke.py``'s (``lexical_kernel_phase``), not this
script's.

A run needs a card; ``--compare`` runs anywhere.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# the chip_smoke.py of this script's tree: its corpus, queries and timing
CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def _log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def device_ms(fn, calls: int = 5):
    """(the sparse kernel's, every kernel's) device ms of one fn(), from
    torch.profiler over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ours = total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        total += us
        if "sparse_topk" in evt.key:
            ours += us
    return ours / calls / 1e3, total / calls / 1e3


def run(label: str, save) -> None:
    from persian_rag_tpu_torch.ops import sparse_scores as ss
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem

    cs = _chip_smoke()
    rng = np.random.default_rng(cs.SEED + 1)
    vocab = cs.lexical_vocab(rng)
    chunks = cs.lexical_chunks(cs.N_CORPUS, vocab, rng)
    rs = RetrievalSystem(method="bm25", device="cuda")
    if not rs.load_chunks_and_index(chunks):
        raise RuntimeError("load_chunks_and_index failed")
    index = rs.bm25_index
    flat = sorted((b for b in index._buckets if b.dev_ids.dim() == 2),
                  key=lambda b: b.n_actual)
    buckets = {
        "sparse_topk": flat[-1],
        "sparse_topk_hashed": max(
            (b for b in index._buckets if b.dev_ids.dim() == 3),
            key=lambda b: b.n_actual),
    }
    geometry = {"sparse_topk": getattr(ss, "sparse_topk_geometry", None),
                "sparse_topk_union": getattr(ss, "sparse_topk_union_geometry",
                                             None)}
    union13_geometry = getattr(ss, "sparse_topk_union_hashed_geometry", None)
    hashes = {}

    def timed(name, bucket, b, qids, qvals, key, **extra):
        ids, vals = bucket.dev_ids, bucket.dev_vals
        kernel = ss.KERNELS[name]
        s, i = kernel(ids, vals, qids, qvals, 10)
        hashes[key] = hashlib.sha256(
            s.cpu().numpy().tobytes() + i.cpu().numpy().tobytes()
        ).hexdigest()
        live = ids.reshape(ids.shape[0], -1)
        freq = torch.bincount(live[live >= 0].long(),
                              minlength=len(index.vocab))
        matches = float(freq[qids[qids >= 0].long()].sum())

        def call():
            return kernel(ids, vals, qids, qvals, 10)

        kernel_ms, call_device_ms = device_ms(call)
        line = {
            "label": label, "kernel": name, "B": b,
            "T": int(qids.shape[1]), "shape": list(ids.shape), **extra,
            "ms": cs.cuda_median_ms(call, runs=15 if b <= 64 else 7),
            "host_ms": cs.host_median_ms(call, runs=15 if b <= 64 else 7),
            "kernel_ms": kernel_ms, "device_ms": call_device_ms,
            **cs.roofline(cs._nbytes(ids, vals, qids, qvals, s, i),
                          2.0 * matches, "f32")}
        if geometry.get(name) is not None:
            line["geometry"] = geometry[name](b, int(qids.shape[1]),
                                              int(ids.shape[0]))._asdict()
        elif name == "sparse_topk_union_hashed" and union13_geometry:
            line["geometry"] = union13_geometry(
                b, int(qids.shape[1]))._asdict()
        if "_union" in name:  # past a tile: each tile's whole list
            s2, i2 = kernel(ids, vals, qids, qvals, 200)
            hashes[key + " k=200"] = hashlib.sha256(
                s2.cpu().numpy().tobytes() + i2.cpu().numpy().tobytes()
            ).hexdigest()
        _log("time", line)

    queries = {}
    for b in cs.LEX_BATCHES:
        texts = cs.lexical_queries([b], vocab, rng)[0]
        qids_np, qvals_np = index._encode_queries(
            [index._query_terms(q) for q in texts])
        queries[b] = (torch.from_numpy(qids_np).cuda(),
                      torch.from_numpy(qvals_np).cuda())
        for name, bucket in buckets.items():
            timed(name, bucket, b, *queries[b], f"{name} {b}")
    # #10 on C's other flat buckets, at a served request's batches
    for bucket in flat[:-1]:
        for b in (1, 16):
            timed("sparse_topk", bucket, b, *queries[b],
                  f"sparse_topk {b} N={bucket.dev_ids.shape[0]}")
    # the union kernels, and #10 on the same queries
    for b in cs.UNION_BATCHES:
        texts = cs.lexical_queries([b], vocab, rng)[0]
        qids_np, qvals_np = index._encode_queries(
            [index._query_terms(q) for q in texts])
        qids = torch.from_numpy(qids_np).cuda()
        qvals = torch.from_numpy(qvals_np).cuda()
        n_union = len(np.unique(qids_np[qids_np >= 0]))
        union = {"U": n_union, "chunks": -(-n_union // 64)}
        for name in ("sparse_topk_union", "sparse_topk_union_hashed",
                     "sparse_topk", "sparse_topk_hashed"):
            bucket = buckets[name.replace("_union", "")]
            timed(name, bucket, b, qids, qvals, f"{name} union{b}", **union)
    # the union edge request (chip_smoke's): a long query, an all-pad row, a
    # term twice in a query and one shared
    qids_np, qvals_np = cs.union_edge_batch(index, vocab, rng)
    for name in ("sparse_topk_union", "sparse_topk_union_hashed"):
        timed(name, buckets[name.replace("_union", "")], qids_np.shape[0],
              torch.from_numpy(qids_np).cuda(),
              torch.from_numpy(qvals_np).cuda(), f"{name} edge")
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        with open(save, "w") as f:
            json.dump(hashes, f)


def compare(path_a: str, path_b: str) -> int:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    by_kernel: dict = {}
    for key in sorted(set(a) & set(b)):
        by_kernel.setdefault(key.split()[0], []).append(a[key] == b[key])
    for name, same in by_kernel.items():
        _log("bits", {"kernel": name, "outputs": len(same),
                      "bit_equal": sum(same)})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name printed with the run")
    ap.add_argument("--save", help="write the output hashes to this file")
    ap.add_argument("--compare", nargs=2, metavar="RUN",
                    help="two --save files: which outputs are bit-equal")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("lex_ab needs a CUDA card", file=sys.stderr)
        return 2
    from persian_rag_tpu_torch.ops import sparse_scores as ss

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    _log("run", {"label": args.label, "package": os.path.dirname(ss.__file__),
                 "device": torch.cuda.get_device_name(0),
                 "nvidia_smi": smi.stdout.strip()})
    run(args.label, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
