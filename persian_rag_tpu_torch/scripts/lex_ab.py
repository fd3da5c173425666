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
    PYTHONPATH=. python3 persian_rag_tpu_torch/scripts/lex_ab.py \\
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
also hashed at k = 200. Then the stage-1 arm: #12's stage 1 over C16
(``chip_smoke.py``'s C cut to its first 16 words a chunk: one flat bucket
of 100,000 rows) and #13's over C's largest hashed bucket, at B = 128 and
512 and the served k_scan of 32, each beside its exact mode on the same
queries; a ``stage1`` line gives the wrapper's CUDA-event median, its host
time, the device time of each kernel it launches (torch.profiler: the
product or walk with its tile selection, the rows' weights where the tree
has them, and the merge of the tile lists) and, where the tree has the
tensor-core kernel, its launch (``sparse_stage1_geometry``).
``--variants NAME ...`` also times, on the same queries, copies of the
tree's ``csrc/sparse_stage1.cu`` edited by the ``STAGE1_VARIANTS`` of those
names (``str.replace``: ``product`` leaves the running lists alone, so its
``stage1_mma_kernel`` is the product without the selection; the others set
other launch constants, the measurement behind the kernel's own), each
built alone by ``nvcc`` beside the package's library and called through
its C entries, a ``variant`` line each; ``--variants all`` takes every
one. ``--only-stage1`` runs the arm alone. A ``time`` line each gives the
CUDA-event median of the whole wrapper (kernel, prep and tile merge), beside the bound (the bucket and the
queries read once, or a multiply-add for each (query term, document holding
it) at the f32 rate), the device time of the kernel alone and of the whole
call (torch.profiler), the host time of one call (the card idle at its
start) and, where the tree has its geometry entry, the launch #10's (and
#12's) C entry picks; a union line also gives the batch's distinct terms
``U`` and their chunks of 64. ``--save`` writes a hash of every output, and
``--compare`` names the outputs two saved runs share bit for bit. Stage 1's
bits differ between the walk's f32 chain and the tensor cores by design:
``--save`` keeps its lists, and ``--compare`` holds them to each other
within the stage-1 bound (``stage1_rel_error``, twice: each run within it
of the exact sum of the products) and counts the ids that differ beyond a
near-tie. Correctness is ``chip_smoke.py``'s (``lexical_kernel_phase``,
``twopass_phase``), not this script's.

A run needs a card; ``--compare`` runs anywhere.
"""
from __future__ import annotations

import argparse
import ctypes
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


def device_split(fn, calls: int = 5) -> dict:
    """Device ms of one fn() by kernel name (torch.profiler over `calls`
    calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            name = evt.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")[:60]
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return out


def device_ms(fn, calls: int = 5):
    """(the sparse kernel's, every kernel's) device ms of one fn()."""
    split = device_split(fn, calls)
    return (sum(ms for name, ms in split.items() if "sparse_topk" in name),
            sum(split.values()))


# the served stage-1 list (index/lexical.py: _TWOPASS_K_SCAN)
STAGE1_K = 32
# Copies of csrc/sparse_stage1.cu timed by --variants: each edit replaces
# text that occurs once in the source.
_FLAT = "constexpr int kFlatTN = 128, kFlatDK = 128;"
_HASHED = "constexpr int kHashedTN = 64, kHashedDK = 256;"
STAGE1_VARIANTS = {
    # the running lists never updated: the product alone (merges of empty
    # lists still run)
    "product": [("      update_lists<QB, TN, WARPS>(",
                 "      if (false) update_lists<QB, TN, WARPS>(")],
    "flat-tile-64": [(_FLAT, "constexpr int kFlatTN = 64, kFlatDK = 128;")],
    "flat-tile-256": [(_FLAT, "constexpr int kFlatTN = 256, kFlatDK = 128;")],
    "flat-chunk-256": [(_FLAT,
                        "constexpr int kFlatTN = 128, kFlatDK = 256;")],
    "hashed-tile-128": [(_HASHED,
                         "constexpr int kHashedTN = 128, kHashedDK = 256;")],
    "hashed-chunk-128": [(_HASHED,
                          "constexpr int kHashedTN = 64, kHashedDK = 128;")],
    "queries-128": [("constexpr int kQB = 64;", "constexpr int kQB = 128;"),
                    ("constexpr int kBlockWarps = 8;",
                     "constexpr int kBlockWarps = 16;")],
    # a warp's 8 docs at 64-doc tiles take no m16n8k16 pair: these two set
    # the hashed tile to 128 as well
    "queries-32-hashed-tile-128": [
        ("constexpr int kQB = 64;", "constexpr int kQB = 32;"),
        (_HASHED, "constexpr int kHashedTN = 128, kHashedDK = 256;")],
    "threads-512-hashed-tile-128": [
        ("constexpr int kBlockWarps = 8;", "constexpr int kBlockWarps = 16;"),
        (_HASHED, "constexpr int kHashedTN = 128, kHashedDK = 256;")],
}


def variant_source(src: str, name: str) -> str:
    """The stage-1 source with variant `name`'s edits; raises where an
    edit's text does not occur exactly once."""
    for old, new in STAGE1_VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """name -> ctypes library of the variant (or the nvcc error text), all
    compiled at once, under the build directory beside the package's
    library; {} where the tree has no stage-1 kernel."""
    from persian_rag_tpu_torch.ops import _build

    src_path = _build.CSRC / "sparse_stage1.cu"
    if not names or not src_path.exists():
        return {}
    src = src_path.read_text()
    nvcc = _build._find_nvcc()
    out_dir = _build.BUILD_ROOT.parent / "stage1_variants"
    procs = {}
    for name in names:
        text = variant_source(src, name)
        d = out_dir / hashlib.sha256(
            (" ".join(_build.NVCC_FLAGS) + text).encode()).hexdigest()[:16]
        d.mkdir(parents=True, exist_ok=True)
        (d / "sparse_stage1.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
               "-o", str(d / "lib.so"), str(d / "sparse_stage1.cu")]
        procs[name] = (d / "lib.so", None if (d / "lib.so").exists() else
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate() if proc is not None else ("", "")
        if proc is not None and proc.returncode != 0:
            libs[name] = f"nvcc failed: {out}{err}"[-2000:]
            continue
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.prt_sparse_topk_union_stage1,
                   lib.prt_sparse_topk_union_hashed_stage1):
            fn.argtypes = [p] * 5 + [ll, p, p] + [i] * 6 + [p]
            fn.restype = i
        lib.prt_sparse_stage1_geometry.argtypes = [i] * 5 + [
            ctypes.POINTER(ll)]
        lib.prt_sparse_stage1_geometry.restype = i
        libs[name] = lib
    return libs


def variant_call(lib, ids3, vals3, qids, qvals, k):
    """A variant library's stage 1 over an (N, S, Ls) corpus, as
    `union_stage1_cuda` launches the package's."""
    b, t = qids.shape
    n, s_n, ls = ids3.shape
    geo = (ctypes.c_longlong * 12)()
    if lib.prt_sparse_stage1_geometry(b, t, n, s_n, k, geo) != 0:
        raise ValueError("no launch of this variant fits")
    scratch = torch.empty(geo[11], dtype=torch.uint8, device=qids.device)
    res_s = torch.empty((b, k), dtype=torch.float32, device=qids.device)
    res_i = torch.empty((b, k), dtype=torch.int32, device=qids.device)
    fn = (lib.prt_sparse_topk_union_stage1 if s_n == 1
          else lib.prt_sparse_topk_union_hashed_stage1)
    err = fn(qids.data_ptr(), qvals.data_ptr(), ids3.data_ptr(),
             vals3.data_ptr(), scratch.data_ptr(), geo[11], res_s.data_ptr(),
             res_i.data_ptr(), b, t, n, s_n, ls, k,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch: cudaError {err}")
    return res_s, res_i


def stage1_arm(label, cs, ss, index, chunks, vocab, rng, saved,
               variants=()) -> None:
    """The stage-1 lines (the module docstring says which)."""
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem

    short = RetrievalSystem(method="bm25", device="cuda")
    if not short.load_chunks_and_index(cs._short_chunks(chunks)):
        raise RuntimeError("C16: load_chunks_and_index failed")
    sidx = short.bm25_index
    hashed = max((b for b in index._buckets if b.dev_ids.dim() == 3),
                 key=lambda b: b.n_actual)
    cases = (("sparse_topk_union", "C16", sidx._dev_ids, sidx._dev_vals,
              sidx),
             ("sparse_topk_union_hashed", "C", hashed.dev_ids,
              hashed.dev_vals, index))
    tc = getattr(ss, "union_stage1_cuda", None)
    libs = build_variants(variants if tc is not None else ())
    for name, lib in libs.items():
        if isinstance(lib, str):
            _log("variant", {"label": label, "variant": name,
                             "error": lib})
    for b in cs.UNION_BATCHES:
        texts = cs.lexical_queries([b], vocab, rng)[0]
        for name, corpus, ids, vals, idx in cases:
            qids_np, qvals_np = idx._encode_queries(
                [idx._query_terms(q) for q in texts])
            qids = torch.from_numpy(qids_np).cuda()
            qvals = torch.from_numpy(qvals_np).cuda()
            kernel = ss.KERNELS[name]
            ids3 = ids if ids.dim() == 3 else ids.view(ids.shape[0], 1, -1)
            vals3 = vals.view(ids3.shape)

            def call():
                return kernel(ids, vals, qids, qvals, STAGE1_K, stage1=True)

            s, i = call()
            t, u = int(qids.shape[1]), len(np.unique(qids_np[qids_np >= 0]))
            saved[f"{name}_stage1 {corpus} {b}"] = {
                "s": s.cpu().tolist(), "i": i.cpu().tolist(), "U": u, "T": t}
            line = {
                "label": label, "kernel": name + "_stage1", "corpus": corpus,
                "B": b, "T": t, "U": u, "shape": list(ids.shape),
                "k": STAGE1_K,
                "ms": cs.cuda_median_ms(call, runs=15),
                "exact_ms": cs.cuda_median_ms(
                    lambda: kernel(ids, vals, qids, qvals, STAGE1_K),
                    runs=15),
                "host_ms": cs.host_median_ms(call, runs=15),
                "split": device_split(call)}
            if tc is not None:
                line["geometry"] = ss.sparse_stage1_geometry(
                    b, t, int(ids.shape[0]), STAGE1_K,
                    int(ids3.shape[1]))._asdict()
            _log("stage1", line)
            for vname, lib in libs.items():
                if isinstance(lib, str):
                    continue

                def vcall():
                    return variant_call(lib, ids3, vals3, qids, qvals,
                                        STAGE1_K)

                vline = {"label": label, "variant": vname,
                         "kernel": name + "_stage1", "corpus": corpus,
                         "B": b}
                try:
                    vline.update(ms=cs.cuda_median_ms(vcall, runs=15),
                                 split=device_split(vcall))
                except (ValueError, RuntimeError) as e:
                    vline["error"] = str(e)
                _log("variant", vline)
    short.cleanup()


def run(label: str, save, only_stage1: bool = False,
        variants=()) -> None:
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
    hashes, stage1 = {}, {}
    if only_stage1:
        stage1_arm(label, cs, ss, index, chunks, vocab, rng, stage1,
                   variants)
        _write(save, hashes, stage1)
        return
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
    stage1_arm(label, cs, ss, index, chunks, vocab, rng, stage1, variants)
    _write(save, hashes, stage1)


def _write(save, hashes: dict, stage1: dict) -> None:
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        with open(save, "w") as f:
            json.dump({**hashes, "stage1": stage1}, f)


def stage1_agree(a: dict, b: dict) -> dict:
    """Two runs' stage-1 lists of one case held to each other: every
    score within 2 stage1_rel_error(U, T) of the other's (each run lies
    within it of the exact sum of the bf16 products), and the ids that
    differ where neither neighbour of run a's score lies within that."""
    from persian_rag_tpu_torch.ops import sparse_scores as ss

    sa, sb = np.asarray(a["s"]), np.asarray(b["s"])
    ia, ib = np.asarray(a["i"]), np.asarray(b["i"])
    rel = 2.0 * ss.stage1_rel_error(a["U"], a["T"])
    tol = rel * np.abs(sa)
    gaps = np.abs(np.diff(sa, axis=1))
    inf = np.full((len(sa), 1), np.inf)
    near = np.minimum(np.concatenate([inf, gaps], axis=1),
                      np.concatenate([gaps, inf], axis=1))
    differ = ia != ib
    return {"rows": int(sa.shape[0]), "rel": rel,
            "scores_within": bool((np.abs(sa - sb) <= tol).all()),
            "max_rel_err": float((np.abs(sa - sb) / np.where(
                sa > 0, sa, np.inf)).max()),
            "ids_differ": int(differ.sum()),
            "ids_differ_past_near_ties": int((differ & (near > 2 * tol)).sum())}


def compare(path_a: str, path_b: str) -> int:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    s1a, s1b = a.pop("stage1", {}), b.pop("stage1", {})
    by_kernel: dict = {}
    for key in sorted(set(a) & set(b)):
        by_kernel.setdefault(key.split()[0], []).append(a[key] == b[key])
    for name, same in by_kernel.items():
        _log("bits", {"kernel": name, "outputs": len(same),
                      "bit_equal": sum(same)})
    for key in sorted(set(s1a) & set(s1b)):
        _log("bound", {"case": key, **stage1_agree(s1a[key], s1b[key])})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name printed with the run")
    ap.add_argument("--save", help="write the output hashes to this file")
    ap.add_argument("--compare", nargs=2, metavar="RUN",
                    help="two --save files: which outputs are bit-equal "
                    "(stage 1: within its bound)")
    ap.add_argument("--only-stage1", action="store_true",
                    help="run the stage-1 arm alone")
    ap.add_argument("--variants", nargs="+", default=[], metavar="NAME",
                    help="also time these STAGE1_VARIANTS copies of the "
                    "stage-1 kernel ('all': every one)")
    args = ap.parse_args(argv)
    variants = (list(STAGE1_VARIANTS) if args.variants == ["all"]
                else args.variants)
    unknown = sorted(set(variants) - set(STAGE1_VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
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
    run(args.label, args.save, args.only_stage1, variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
