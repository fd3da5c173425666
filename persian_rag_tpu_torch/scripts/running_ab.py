"""Device times and outputs of the running top-k kernels of modes exact,
fast, fasti and fastg (#5-#8) and of the grouped stage 1 (#3), for
comparing two revisions of the port on the card in one call.

Host and device times move between calls to the card (PERF.md section 5),
so a kernel change is read only beside the version it replaces, on one card
in one call. This script measures the wrappers of whichever
``persian_rag_tpu_torch`` comes first on the import path, built by that
tree's own ``_build``: run it by path, once per tree, in one command to the
card, in the order other, this, this, other:

    git archive <rev> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 persian_rag_tpu_torch/scripts/running_ab.py \\
          --label $t --save build/running_ab/$(basename $(realpath $t)).json
    done
    python3 persian_rag_tpu_torch/scripts/running_ab.py \\
        --compare build/running_ab/parent.json build/running_ab/repo.json

A run prints one ``time`` line for each case of ``chip_smoke.py``'s
tier-kernel phase (its 100,000 seeded unit rows of width 384 with 256 rows
repeated 50,000 rows on; in int8 with per-row scales and bf16 compute at k
= 10, 100 and 128 and in the (d, N) layout; their first 20,000 rows in f32,
dot and l2, and in bf16 with bf16 compute, l2), each at Q in 1, 16, 64,
512, and for the 2,304 x 30,000 f32 case: modes exact, fast, fasti and
fastg through ``flat_topk_running``, the CUDA-event median of the wrapper
(``ms``), the device time of queued calls (``queued_ms``), the device
time of the running kernels alone (``kernel_ms``, torch.profiler: the
select, tile or segment kernel and the merge levels), the byte bound
(inputs read once, scores and ids written once, at 3.35 TB/s) and the f32
floor (2 Q N d FMAs at 67 TFLOP/s); then #3
(``extract_candidates_grouped_cuda``) timed at Q = 1, 16, 64, 512 over the
int8 rows' values in bf16, l2, tile 1,024, group 16, and at the lane pick
(Q = 2,048 over 1,000,000 seeded rows of width 384 in bf16, dot, tile
2,048, 16 slots, depth 3). ``--save`` writes a hash of every list (scores
and ids), and of #3 at Q = 64 there, at the lane pick, and at d = 1,024
(tile 2,048, group 16, depth 16) and 2,048 (tile 1,024, group 16, depth 2)
over bf16 (l2) and int8 rows, both layouts, where the tree's #3 takes them
(a tree whose #3 refuses the width records the refusal); ``--compare``
names the outputs two saved runs share bit for bit, by kernel. Correctness
is ``chip_smoke.py``'s (``tier_kernel_phase``, ``kernel_modes_phase``,
``width_phase``), not this script's.

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

import torch

CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
BATCHES = (1, 16, 64, 512)
MODES = ("exact", "fast", "fasti", "fastg")
F32_FLOPS = 67e12
LANE = (1_000_000, 2_048, 2_048, 16, 3)  # N, Q, tile_n, slots, depth
# #3 at the width phase's shapes: (d, tile_n, group, depth)
GROUPED = ((1_024, 2_048, 16, 16), (2_048, 1_024, 16, 2))


def _log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _hash(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_ms(fn, calls: int = 5) -> float:
    """Device ms of the running kernels of one fn() (the select, tile or
    segment kernel and the merge levels), from torch.profiler over `calls`
    calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if any(x in evt.key for x in ("running_tile_kernel",
                                       "running_select_kernel",
                                       "segment_topk_kernel",
                                       "merge_kernel")):
            t = getattr(evt, "self_device_time_total", None)
            us += t if t is not None else getattr(evt, "self_cuda_time_total",
                                                  0.0)
    return us / calls / 1e3


def cases(cs, dev):
    """(name, rows, kwargs, queries by Q) of the tier-kernel phase's
    corpus, as `chip_smoke.tier_kernel_phase` makes it."""
    from persian_rag_tpu_torch.index.dense import _quantize_int8

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    corpus = torch.randn(cs.N_CORPUS, cs.DIM, device=dev, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    corpus[cs.N_CORPUS // 2: cs.N_CORPUS // 2 + 256] = corpus[:256]
    _, scales, values = _quantize_int8(corpus.cpu().numpy())
    c8 = torch.from_numpy(values).to(dev)
    scale = torch.from_numpy(scales).to(dev)
    small = corpus[:20_000].contiguous()
    small[10_000:10_128] = small[:128]
    queries = {n_q: cs._queries_near(corpus, n_q, g) for n_q in BATCHES}
    bf16 = dict(corpus_scale=scale, compute_dtype=torch.bfloat16)
    out = [(f"int8 100k k={k}", c8, dict(k=k, **bf16), queries)
           for k in (10, 100, 128)]
    out.append(("int8 100k k=10 (d, N)", c8.t().contiguous(),
                dict(k=10, corpus_transposed=True, **bf16), queries))
    out += [(f"f32 20k {m}", small, dict(k=10, metric=m), queries)
            for m in ("dot", "l2")]
    out.append(("bf16 20k l2", small.bfloat16(),
                dict(k=10, metric="l2", compute_dtype=torch.bfloat16),
                queries))
    out.append(("f32 2304x30k", corpus[:30_000].contiguous(), dict(k=10),
                {2304: cs._queries_near(corpus, 2_304, g)}))
    return g, out


def run(label: str, save) -> None:
    from persian_rag_tpu_torch.ops import flat_topk as ft

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    g, all_cases = cases(cs, dev)
    saved = {}
    for name, rows, kw, queries in all_cases:
        n = rows.shape[1 if kw.get("corpus_transposed") else 0]
        for n_q, q in queries.items():
            for mode in MODES:
                def call(q=q, rows=rows, kw=kw, mode=mode):
                    return ft.flat_topk_running(q, rows, mode=mode, **kw)

                s, i = call()
                key = f"{mode} {name} Q={n_q}"
                saved[key] = _hash(s, i)
                big = n_q >= 512
                line = {"label": label, "mode": mode, "case": name,
                        "Q": n_q, "N": n, "k": kw["k"],
                        "ms": cs.cuda_median_ms(call, runs=7 if big else 15),
                        "queued_ms": cs.cuda_queued_ms(
                            call, launches=5 if big else 20),
                        "kernel_ms": kernel_ms(call),
                        **cs.roofline(cs._nbytes(q, rows, kw.get(
                            "corpus_scale"), s, i), 0.0, "f32"),
                        "f32_floor_ms": 1e3 * 2.0 * n_q * n * cs.DIM
                        / F32_FLOPS}
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                if mode in ("exact", "fast") and hasattr(
                        ft, "running_geometry"):
                    line["geometry"] = ft.running_geometry(
                        n_q, n, cs.DIM, kw["k"], rows.element_size(),
                        sms)._asdict()
                elif mode in ("fasti", "fastg") and hasattr(
                        ft, "segment_geometry"):
                    line["geometry"] = ft.segment_geometry(
                        n_q, n, cs.DIM, kw["k"], rows.element_size(),
                        MODES.index(mode) - 2, sms)._asdict()
                _log("time", line)
    # #3 at its table shape (the corpus's first 100k rows in bf16, l2, tile
    # 1,024, group 16) at each Q, then at the lane pick, then past the
    # widths an earlier kernel refused
    rows16 = all_cases[0][1].float().bfloat16()  # int8 values, exact
    csq = torch.sum(rows16.float() ** 2, dim=-1)
    for n_q, q in all_cases[0][3].items():
        def grouped(q=q):
            return ft.extract_candidates_grouped_cuda(q, rows16, csq, None,
                                                      1024, 4, 16, 2)

        if n_q == 64:
            saved["grouped d=384 tile=1024 (16, 2) bf16 l2 (N, d)"] = _hash(
                grouped())
        _log("time", {"label": label, "kernel": "grouped", "Q": n_q,
                      "N": rows16.shape[0], "d": cs.DIM, "tile_n": 1024,
                      "group": 16, "depth": 2,
                      "ms": cs.cuda_median_ms(grouped),
                      "queued_ms": cs.cuda_queued_ms(grouped),
                      "f32_floor_ms": 1e3 * 2.0 * n_q * rows16.shape[0]
                      * cs.DIM / F32_FLOPS})
    n, n_q, tile_n, slots, depth = LANE
    big = torch.randn(n, cs.DIM, device=dev, generator=g).bfloat16()
    ql = torch.randn(n_q, cs.DIM, device=dev, generator=g)

    def lane():
        return ft.extract_candidates_grouped_cuda(ql, big, None, None, tile_n,
                                                  4, slots, depth)

    saved[f"grouped lane d=384 tile={tile_n} ({slots}, {depth}) bf16 dot "
          f"N={n}"] = _hash(lane())
    _log("time", {"label": label, "kernel": "grouped lane", "Q": n_q, "N": n,
                  "d": cs.DIM, "tile_n": tile_n, "group": slots,
                  "depth": depth,
                  "queued_ms": cs.cuda_queued_ms(lane, launches=3, reps=3,
                                                 warmup=1),
                  "f32_floor_ms": 1e3 * 2.0 * n_q * n * cs.DIM / F32_FLOPS})
    del big, ql
    for d, tile_n, group, depth in GROUPED:
        rows = torch.randn(20_000, d, device=dev, generator=g)
        rows /= rows.norm(dim=1, keepdim=True)
        q = torch.randn(64, d, device=dev, generator=g)
        r16 = rows.bfloat16()
        csq = torch.sum(r16.float() ** 2, dim=-1)
        s8 = (rows.abs().amax(dim=1) / 127.0).float()
        r8 = torch.round(rows / s8[:, None]).clamp(-127, 127).to(torch.int8)
        for kind, rr, cn, sc in (("bf16 l2", r16, csq, None),
                                 ("int8", r8, None, s8)):
            for trans in (False, True):
                src = rr.t().contiguous() if trans else rr
                key = (f"grouped d={d} tile={tile_n} ({group}, {depth}) "
                       f"{kind} {'(d, N)' if trans else '(N, d)'}")
                try:
                    saved[key] = _hash(ft.extract_candidates_grouped_cuda(
                        q, src, cn, sc, tile_n, 4, group, depth, trans))
                except (ValueError, RuntimeError) as e:
                    saved[key] = f"refused: {e}"[:200]
                _log("grouped", {"label": label, "case": key,
                                 "out": saved[key][:16]})
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        with open(save, "w") as f:
            json.dump(saved, f)


def compare(path_a: str, path_b: str) -> int:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    by_kernel: dict = {}
    for key in sorted(set(a) | set(b)):
        kernel = key.split()[0]
        rec = by_kernel.setdefault(kernel, {"outputs": 0, "bit_equal": 0,
                                            "refused_a": 0, "refused_b": 0})
        va, vb = a.get(key, "missing"), b.get(key, "missing")
        rec["refused_a"] += va.startswith(("refused", "missing"))
        rec["refused_b"] += vb.startswith(("refused", "missing"))
        if va.startswith(("refused", "missing")) or vb.startswith(
                ("refused", "missing")):
            continue
        rec["outputs"] += 1
        rec["bit_equal"] += va == vb
    for name, rec in by_kernel.items():
        _log("bits", {"kernel": name, **rec})
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
        print("running_ab needs a CUDA card", file=sys.stderr)
        return 2
    from persian_rag_tpu_torch.ops import flat_topk as ft

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    _log("run", {"label": args.label, "package": os.path.dirname(ft.__file__),
                 "device": torch.cuda.get_device_name(0),
                 "nvidia_smi": smi.stdout.strip()})
    run(args.label, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
