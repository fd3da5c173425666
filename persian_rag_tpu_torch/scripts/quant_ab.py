"""Device times and outputs of the weight-streaming quantized kernels, for
comparing two revisions of the port on the card in one call.

Host and device times move between calls to the card (PERF.md section 5),
so a kernel change is read only beside the version it replaces, on one card
in one call. This script measures the wrappers of whichever
``persian_rag_tpu_torch`` comes first on the import path, built by that
tree's own ``_build``: run it by path, once per tree, in one command to the
card, in the order other, this, this, other:

    git archive <rev> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 persian_rag_tpu_torch/scripts/quant_ab.py \\
          --label $t --save build/quant_ab/$(basename $(realpath $t)).json
    done
    python3 persian_rag_tpu_torch/scripts/quant_ab.py \\
        --compare build/quant_ab/parent.json build/quant_ab/repo.json

A run prints one ``time`` line for each kernel, shape and row count: the
queued device time (ms) of #14 ``w8a16_cuda`` at the k / v, q / o and gate /
up projections (2,048 x 512, 2,048 x 2,048, 2,048 x 8,192), #15
``w8a16_nt_cuda`` at the tied lm_head (2,048 x 128,256), #17
``w8a16_splitk_cuda`` at the down projection (8,192 x 2,048) and #18
``w4a16_cuda`` at the same shape in int4, at 1, 8, 64 and 256 rows,
with the weights cycled past the L2 (every call streams them from device
memory), beside the bf16 library product (``torch.matmul`` on a bf16 copy of
the weights, times the scale) and the byte / operation bound. ``--save``
writes a hash of the outputs of #14 ``w8a16_cuda``, #15, #17 and #18 at
seeded inputs (Llama-3.2-1B's shapes, 1 to 256 rows), and ``--compare``
names the outputs two saved runs share bit for bit. ``--sass`` prints the
count of ``HMMA`` instructions in each kernel function of the tree's built
library (``cuobjdump``). Correctness is ``chip_smoke.py``'s
(``quant_kernel_phase``), not this script's.

A run needs a card; ``--compare`` runs anywhere.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

TIMED_ROWS = (1, 8, 64, 256)
BITS_ROWS = (1, 2, 3, 5, 8, 9, 64, 72, 256)
L2_BYTES = 50 * 1024 * 1024
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# (kernel, K, N) of the outputs hashed by --save: Llama-3.2-1B's int8 layer
# projections (#14), its down projection (#17), its tied lm_head (#15, N x K)
# and its int4 layer projections (#18)
BITS_SHAPES = (
    ("w8a16", 2048, 512), ("w8a16", 2048, 2048), ("w8a16", 2048, 8192),
    ("w8a16_splitk", 8192, 2048), ("w8a16_nt", 2048, 128_256),
    ("w4a16", 2048, 512), ("w4a16", 2048, 2048), ("w4a16", 2048, 8192),
    ("w4a16", 8192, 2048),
)


def _log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _weights(name: str, k: int, n: int, copies: int, g, dev):
    """`copies` random weight tensors of kernel `name` and their scale."""
    shape = {"w8a16_nt": (n, k), "w4a16": (k // 2, n)}.get(name, (k, n))
    low = -128 if name == "w4a16" else -127
    ws = torch.randint(low, 128, (copies, *shape), dtype=torch.int8,
                       device=dev, generator=g)
    scale = torch.rand((n, 1) if name == "w8a16_nt" else (1, n), device=dev,
                       generator=g) * 0.01 + 0.001
    return ws, scale


def queued_ms(fn, launches: int = 20, reps: int = 7, warmup: int = 3):
    """Device time (ms) of one fn(): `launches` calls queued behind a spin,
    the median over `reps` of the CUDA-event time over `launches`."""
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


# (K, N) timed for each kernel: Llama-3.2-1B's shapes that reach it
TIMED_SHAPES = {
    "w8a16": ((2048, 512), (2048, 2048), (2048, 8192)),
    "w8a16_nt": ((2048, 128_256),),
    "w8a16_splitk": ((8192, 2048),),
    "w4a16": ((8192, 2048),),
}


def timing(qm, name: str, k: int, n: int, g, dev) -> None:
    kernel = qm.KERNELS[name]
    weight_bytes = (k // 2 if name == "w4a16" else k) * n
    copies = max(2, -(-2 * L2_BYTES // weight_bytes) + 1)
    ws, scale = _weights(name, k, n, copies, g, dev)
    if name == "w4a16":
        w16 = torch.stack([torch.cat(qm.unpack_int4(w)).bfloat16()
                           for w in ws])
    else:
        w16 = ws.bfloat16()
    for b in TIMED_ROWS:
        x = torch.randn((b, k), device=dev, generator=g).bfloat16()
        turn = [0]

        def cycle(f, wl):
            def run():
                turn[0] = (turn[0] + 1) % copies
                return f(wl[turn[0]])
            return run

        if name == "w8a16_nt":
            lib = lambda w: torch.matmul(x, w.T) * scale.reshape(1, -1)
        else:
            lib = lambda w: torch.matmul(x, w) * scale
        n_bytes = 2 * b * k + weight_bytes + 4 * n + 4 * b * n
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = 2.0 * b * k * n / BF16_OPS_PER_S
        _log("time", {
            "kernel": name, "K": k, "N": n, "B": b,
            "ms": queued_ms(cycle(lambda w: kernel(x, w, scale), ws)),
            "library_ms": queued_ms(cycle(lib, w16)),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    del ws, w16
    torch.cuda.empty_cache()


def output_hashes(qm, dev) -> dict:
    """SHA-256 of each kernel's output at seeded inputs, by
    'kernel K N B'."""
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for name, k, n in BITS_SHAPES:
        ws, scale = _weights(name, k, n, 1, g, dev)
        for b in BITS_ROWS:
            x = torch.randn((b, k), device=dev, generator=g).bfloat16()
            got = qm.KERNELS[name](x, ws[0], scale).cpu()
            out[f"{name} {k} {n} {b}"] = hashlib.sha256(
                got.numpy().tobytes()).hexdigest()
    return out


def sass_hmma(build) -> dict:
    """HMMA instructions in each function of the tree's built library."""
    so = build.build()
    cuobjdump = os.path.join(os.path.dirname(build._find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    return {block.split("\n", 1)[0].strip(): block.count("HMMA")
            for block in sass.split("Function : ")[1:]}


def compare(path_a: str, path_b: str) -> int:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    by_kernel: dict = {}
    for key in sorted(set(a) & set(b)):
        name = key.split()[0]
        by_kernel.setdefault(name, []).append(a[key] == b[key])
    for name, same in by_kernel.items():
        _log("bits", {"kernel": name, "outputs": len(same),
                      "bit_equal": sum(same)})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name printed with the run")
    ap.add_argument("--kernels", default=",".join(TIMED_SHAPES),
                    help="the kernels to time")
    ap.add_argument("--save", help="write the output hashes to this file")
    ap.add_argument("--sass", action="store_true",
                    help="print the HMMA count of each kernel function")
    ap.add_argument("--compare", nargs=2, metavar="RUN",
                    help="two --save files: which outputs are bit-equal")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("quant_ab needs a CUDA card", file=sys.stderr)
        return 2
    from persian_rag_tpu_torch.ops import _build
    from persian_rag_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    _log("run", {"label": args.label, "package": os.path.dirname(qm.__file__),
                 "device": torch.cuda.get_device_name(0),
                 "nvidia_smi": smi.stdout.strip()})
    if args.sass:
        _log("sass", {fn: c for fn, c in sass_hmma(_build).items() if c})
    g = torch.Generator(device=dev).manual_seed(13)
    for name in args.kernels.split(","):
        for k, n in TIMED_SHAPES[name]:
            timing(qm, name, k, n, g, dev)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)),
                    exist_ok=True)
        with open(args.save, "w") as f:
            json.dump(output_hashes(qm, dev), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
