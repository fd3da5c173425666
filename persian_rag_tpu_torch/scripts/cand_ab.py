"""Device times and outputs of the stage-1 candidate kernels, for comparing
two revisions of the port on the card in one call.

Host and device times move between calls to the card (PERF.md section 5),
so a kernel change is read only beside the version it replaces, on one card
in one call. This script measures the wrappers of whichever
``persian_rag_tpu_torch`` comes first on the import path, built by that
tree's own ``_build``: run it by path, once per tree, in one command to the
card, in the order other, this, this, other:

    git archive <rev> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 persian_rag_tpu_torch/scripts/cand_ab.py \\
          --label $t --save build/cand_ab/$(basename $(realpath $t)).json
    done
    python3 persian_rag_tpu_torch/scripts/cand_ab.py \\
        --compare build/cand_ab/parent.json build/cand_ab/repo.json

A run prints one ``time`` line for each kernel, metric and query batch Q in
1, 16, 64, 512 over the corpus of ``chip_smoke.py``'s kernel phase (100,000
seeded unit rows of width 384, mean-centred, in bf16; their bf16 residues
for bf16x2): #1 ``extract_candidates_bf16_cuda`` and #2
``extract_candidates_bf16x2_cuda`` at tile 1,024, n_easy 4, dot and l2, and
#4 ``extract_candidates_int8_cuda`` over the rows in int8 with per-row
scales at tile 2,048, n_easy 7 (the int8 tier's). Each line gives the
CUDA-event median of the wrapper (``ms``), its host time (``host_ms``, the
card idle at its start), the device time of queued calls (``queued_ms``),
the device time of the stage-1 kernels alone (``kernel_ms``,
torch.profiler: the extraction and part-merge kernels, no allocation),
the byte bound (inputs read once, slots written once, at
3.35 TB/s), the f32 floor (the FMAs at 67 TFLOP/s: 2 Q N d, 3x for bf16x2)
and, for #1 and #2, ``proof_ok``: the share of queries the two-stage
regime (``flat_topk_exact2_stream`` over that stage 1) proves. ``--save``
writes a hash of every output (#1, #2 and #4 at every line's inputs; #1
also over the (d, N) image and at ``ODD``'s shapes, d odd, N off the tile,
n_easy 1 and 7; #9 ``flat_topk_running_maxonly_cuda`` over the int8 rows
and the bf16 image, and #3 ``extract_candidates_grouped_cuda`` over both,
group 16) and each line's ``proof_ok``; ``--compare`` names the outputs two
saved runs share bit for bit and, for each line, the two runs'
``proof_ok``. Correctness is ``chip_smoke.py``'s (``kernel_phase``), not
this script's.

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

# the chip_smoke.py of this script's tree: its corpus sizes and timing
CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
BATCHES = (1, 16, 64, 512)
F32_FLOPS = 67e12
# (d, N, Q, tile_n, n_easy) of #1's odd shapes, hashed beside the lines
ODD = ((385, 5_000, 9, 1024, 4), (384, 20_000, 40, 1024, 1),
       (777, 20_000, 64, 1024, 7))


def _log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _hash(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def kernel_ms(fn, calls: int = 5) -> float:
    """Device ms of the stage-1 kernels of one fn() (the extraction and the
    parts' merge), from torch.profiler over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if "extract_candidates" in evt.key or "merge_parts" in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            us += t if t is not None else getattr(evt, "self_cuda_time_total",
                                                  0.0)
    return us / calls / 1e3


def corpus(cs, dev):
    """The kernel phase's corpus and serving caches: unit rows, their
    squared norms, the mean, the centred bf16 image and its residues, and
    the rows in int8 with per-row scales."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    c = torch.randn(cs.N_CORPUS, cs.DIM, device=dev, generator=g)
    c /= c.norm(dim=1, keepdim=True)
    csq = torch.sum(c * c, dim=-1)
    mu = c.mean(dim=0)
    centered = c - mu[None, :]
    hi = centered.bfloat16()
    lo = (centered - hi.float()).bfloat16()
    scale = c.abs().amax(dim=1) / 127.0
    c8 = torch.round(c / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return g, c, csq, mu, centered, hi, lo, c8, scale.float().contiguous()


def run(label: str, save) -> None:
    from persian_rag_tpu_torch.ops import flat_topk as ft

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    g, c, csq, mu, centered, hi, lo, c8, scale = corpus(cs, dev)
    center_sqmax = torch.max(torch.sum(centered * centered, dim=-1))
    n, d = c.shape
    hi_t = hi.t().contiguous()
    saved = {}
    geometries = {"bf16": getattr(ft, "bf16_geometry", None),
                  "bf16x2": getattr(ft, "bf16x2_geometry", None)}
    for n_q in BATCHES:
        idx = torch.randint(0, n, (n_q,), device=dev, generator=g)
        q = c[idx] + 0.3 * torch.randn(n_q, d, device=dev,
                                       generator=g) / d ** 0.5
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
        for name, metric, parts in (("bf16", "dot", 1), ("bf16", "l2", 1),
                                    ("bf16x2", "dot", 3), ("bf16x2", "l2", 3),
                                    ("int8", "dot", 1)):
            cn = csq if metric == "l2" else None
            if name == "bf16":
                def call():
                    return ft.extract_candidates_bf16_cuda(q, hi, cn, 1024, 4)
            elif name == "bf16x2":
                def call():
                    return ft.extract_candidates_bf16x2_cuda(q, hi, lo, cn,
                                                             1024, 4)
            else:
                def call():
                    return ft.extract_candidates_int8_cuda(q, c8, scale, 2048,
                                                           7)
            out = call()
            key = f"{name} {metric} {n_q}"
            saved[key] = _hash(out)
            rows = (c8, scale) if name == "int8" else (
                (hi, lo) if name == "bf16x2" else (hi,))
            line = {"label": label, "kernel": name, "metric": metric,
                    "Q": n_q, "ms": cs.cuda_median_ms(call),
                    "host_ms": cs.host_median_ms(call),
                    "queued_ms": cs.cuda_queued_ms(
                        call, launches=5 if n_q == 512 else 20),
                    "kernel_ms": kernel_ms(call),
                    **cs.roofline(cs._nbytes(q, cn, out, *rows), 0.0, "f32"),
                    "f32_floor_ms": 1e3 * 2.0 * parts * n_q * n * d
                    / F32_FLOPS}
            if name != "int8":
                _, _, ok = ft.flat_topk_exact2_stream(
                    q, c, 10, metric, corpus_sqnorm=csq, corpus_bf16=hi,
                    corpus_center=mu, center_sqmax=center_sqmax,
                    corpus_bf16_lo=lo if name == "bf16x2" else None,
                    return_ok=True)
                line["proof_ok"] = float(ok.float().mean())
                saved[f"proof_ok {key}"] = line["proof_ok"]
            if geometries.get(name) is not None:
                line["geometry"] = geometries[name](n_q, n, d, 1024)._asdict()
            if name == "bf16":
                saved[f"bf16 {metric} {n_q} (d, N)"] = _hash(
                    ft.extract_candidates_bf16_cuda(q, hi_t, cn, 1024, 4,
                                                    True))
            _log("time", line)
        # #9 over the int8 rows (bf16 compute) and over the bf16 image
        for what, rows, rv, mode in (("int8", c8, scale, 2),
                                     ("bf16", hi, None, 0)):
            best = ft.flat_topk_running_maxonly_cuda(q, rows, rv, mode, True)
            saved[f"maxonly {what} {n_q}"] = _hash(best)
        # #3 over the bf16 image (l2) and the int8 rows, group 16
        for what, rows, cn, rv, tile_n, n_easy in (
                ("bf16", hi, csq, None, 1024, 4),
                ("int8", c8, None, scale, 2048, 7)):
            saved[f"grouped {what} {n_q}"] = _hash(
                ft.extract_candidates_grouped_cuda(q, rows, cn, rv, tile_n,
                                                   n_easy, 16, 2))
    # #1 at odd shapes, both layouts and metrics
    for d_odd, n_odd, n_q, tile_n, n_easy in ODD:
        rows = torch.randn(n_odd, d_odd, device=dev, generator=g)
        rows = (rows / rows.norm(dim=1, keepdim=True)).bfloat16()
        rows_t = rows.t().contiguous()
        sq = torch.sum(rows.float() ** 2, dim=-1)
        q = torch.randn(n_q, d_odd, device=dev, generator=g)
        for metric in ("dot", "l2"):
            cn = sq if metric == "l2" else None
            for layout, rr, trans in (("(N, d)", rows, False),
                                      ("(d, N)", rows_t, True)):
                saved[f"bf16 odd {d_odd}x{n_odd} Q={n_q} n_easy={n_easy} "
                      f"{metric} {layout}"] = _hash(
                    ft.extract_candidates_bf16_cuda(q, rr, cn, tile_n, n_easy,
                                                    trans))
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
    for key in sorted(set(a) & set(b)):
        if key.startswith("proof_ok "):
            _log("proof_ok", {"case": key.split(" ", 1)[1], "a": a[key],
                              "b": b[key], "b_lower": b[key] < a[key]})
        else:
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
        print("cand_ab needs a CUDA card", file=sys.stderr)
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
