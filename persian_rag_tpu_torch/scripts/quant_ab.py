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
``w8a16_splitk_cuda`` at the down projection (8,192 x 2,048), #18
``w4a16_cuda`` at the same shape in int4 and #16 ``w8a8_cuda`` (int8
activations) at the gate / up and down shapes, at 1, 8, 64 and 256 rows,
with the weights cycled past the L2 (every call streams them from device
memory), beside the library product (``torch.matmul`` on a bf16 copy of the
weights, times the scale; for #16 ``torch._int_mm`` times the scale, which
takes more than 16 rows only) and the byte / operation bound (bf16 peak;
int8 for #16). ``--save`` writes a hash of the outputs of #14
``w8a16_cuda``, #15, #17, #18 and #16 at seeded inputs (Llama-3.2-1B's
shapes, 1 to 256 rows), and ``--compare`` names the outputs two saved runs
share bit for bit. ``--sass`` prints the count of ``HMMA`` (bf16) and
``IMMA`` (int8) tensor-core instructions in each kernel function of the
tree's built library (``cuobjdump``). ``--variants NAME ...`` also times
copies of the tree's ``csrc/quant_matmul.cu`` edited by the
``W8A8_VARIANTS`` of those names (``str.replace``), each built alone and
called through its own ``prt_w8a8`` at #16's shapes and rows after a check
that it gives the package's bits (``--variants all`` takes every one; only
a tree with ``w8a8_geometry`` has them). Correctness is ``chip_smoke.py``'s
(``quant_kernel_phase``), not this script's.

A run needs a card; ``--compare`` runs anywhere.
"""
from __future__ import annotations

import argparse
import ctypes
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
OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
# torch._int_mm (cuBLASLt int8) takes more than 16 rows only
INT_MM_MIN_ROWS = 17
# (kernel, K, N) of the outputs hashed by --save: Llama-3.2-1B's int8 layer
# projections (#14), its down projection (#17), its tied lm_head (#15, N x K)
# and its int4 layer projections (#18)
BITS_SHAPES = (
    ("w8a16", 2048, 512), ("w8a16", 2048, 2048), ("w8a16", 2048, 8192),
    ("w8a16_splitk", 8192, 2048), ("w8a16_nt", 2048, 128_256),
    ("w4a16", 2048, 512), ("w4a16", 2048, 2048), ("w4a16", 2048, 8192),
    ("w4a16", 8192, 2048), ("w8a8", 2048, 8192), ("w8a8", 8192, 2048),
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
    "w8a8": ((2048, 8192), (8192, 2048)),
}


def _x(name: str, b: int, k: int, g, dev):
    """Activations of kernel `name`: int8 for #16, else bf16."""
    if name == "w8a8":
        return torch.randint(-127, 128, (b, k), dtype=torch.int8, device=dev,
                             generator=g)
    return torch.randn((b, k), device=dev, generator=g).bfloat16()


def _bound(name: str, b: int, k: int, n: int) -> dict:
    """Bytes (x, weights, scale, out each once) over the HBM rate or the
    operations over the peak of their type, whichever is larger."""
    x_bytes, w_bytes = ((1, k * n) if name == "w8a8" else
                        (2, (k // 2 if name == "w4a16" else k) * n))
    t_bytes = (x_bytes * b * k + w_bytes + 4 * n + 4 * b * n) / HBM_BYTES_PER_S
    t_ops = 2.0 * b * k * n / OPS_PER_S["int8" if name == "w8a8" else "bf16"]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timing(qm, name: str, k: int, n: int, g, dev, variants=None) -> None:
    kernel = qm.KERNELS[name]
    weight_bytes = (k // 2 if name == "w4a16" else k) * n
    copies = max(2, -(-2 * L2_BYTES // weight_bytes) + 1)
    ws, scale = _weights(name, k, n, copies, g, dev)
    if name == "w4a16":
        w16 = torch.stack([torch.cat(qm.unpack_int4(w)).bfloat16()
                           for w in ws])
    elif name == "w8a8":
        w16 = None
    else:
        w16 = ws.bfloat16()
    for b in TIMED_ROWS:
        x = _x(name, b, k, g, dev)
        turn = [0]

        def cycle(f, wl):
            def run():
                turn[0] = (turn[0] + 1) % copies
                return f(wl[turn[0]])
            return run

        if name == "w8a16_nt":
            library_ms = queued_ms(cycle(
                lambda w: torch.matmul(x, w.T) * scale.reshape(1, -1), w16))
        elif name != "w8a8":
            library_ms = queued_ms(cycle(
                lambda w: torch.matmul(x, w) * scale, w16))
        elif b >= INT_MM_MIN_ROWS:
            library_ms = queued_ms(cycle(
                lambda w: torch._int_mm(x, w).float() * scale, ws))
        else:
            library_ms = None
        _log("time", {
            "kernel": name, "K": k, "N": n, "B": b,
            "ms": queued_ms(cycle(lambda w: kernel(x, w, scale), ws)),
            "library_ms": library_ms, **_bound(name, b, k, n)})
        for vname, lib in (variants or {}).items():
            if isinstance(lib, str):
                _log("variant", {"variant": vname, "error": lib})
                continue
            if not torch.equal(variant_w8a8(qm, lib, x, ws[0], scale),
                               kernel(x, ws[0], scale)):
                _log("variant", {"variant": vname, "K": k, "N": n, "B": b,
                                 "error": "differs from the package"})
                continue
            _log("variant", {
                "variant": vname, "K": k, "N": n, "B": b,
                "ms": queued_ms(cycle(
                    lambda w: variant_w8a8(qm, lib, x, w, scale), ws))})
    del ws, w16
    torch.cuda.empty_cache()


# Copies of csrc/quant_matmul.cu timed by --variants (#16 only): each edit
# replaces text that occurs once in the source.
_SMALL = "launch_w8a8<2, 8, false>"
W8A8_VARIANTS = {
    # up to 16 rows: one n8 tile a pass (two passes above 8 rows)
    "one-tile": [(_SMALL, "launch_w8a8<1, 8, false>")],
    # up to 16 rows: spans of 1,024 K rows, two blocks an SM
    "two-blocks": [(_SMALL, "launch_w8a8<2, 4, false>"),
                   ("__launch_bounds__(kThreads, 1)\nw8a8_mma_kernel(",
                    "__launch_bounds__(kThreads, 2)\nw8a8_mma_kernel(")],
    # the weights' loads without the L2 256-byte fetch hint, or a 128-byte one
    "no-hint": [("ldg_stream8<true>(wl +", "ldg_stream8<false>(wl +")],
    "hint-128": [("L2::256B.v2.u32", "L2::128B.v2.u32")],
}


def variant_source(src: str, name: str) -> str:
    """The source with variant `name`'s edits; raises where an edit's text
    does not occur exactly once."""
    for old, new in W8A8_VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    return src


def build_variants(build, names) -> dict:
    """name -> ctypes library of the variant (or the nvcc error text), all
    compiled at once, under the build directory beside the package's
    library."""
    if not names:
        return {}
    src = (build.CSRC / "quant_matmul.cu").read_text()
    nvcc = build._find_nvcc()
    procs = {}
    for name in names:
        text = variant_source(src, name)
        d = build.BUILD_ROOT.parent / "quant_variants" / hashlib.sha256(
            (" ".join(build.NVCC_FLAGS) + text).encode()).hexdigest()[:16]
        d.mkdir(parents=True, exist_ok=True)
        (d / "quant_matmul.cu").write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "quant_matmul.cu")]
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
        lib.prt_w8a8.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.prt_w8a8.restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_w8a8(qm, lib, x_q, values, scale):
    """A variant library's prt_w8a8, launched as `w8a8_cuda` launches the
    package's."""
    k, n = values.shape
    geo = qm.w8a8_geometry(k, n)
    out = torch.empty((x_q.shape[0], n), dtype=torch.float32,
                      device=x_q.device)
    sums, tickets = qm._w8a8_scratch(
        x_q.device, x_q.shape[0] * n if geo.chunks > 1 else 0, geo.tickets)
    xp = qm._pad_x(x_q)
    err = lib.prt_w8a8(xp.data_ptr(), values.data_ptr(), scale.data_ptr(),
                       sums.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                       x_q.shape[0], k, n, geo.k_chunk,
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch: cudaError {err}")
    return out


def output_hashes(qm, dev) -> dict:
    """SHA-256 of each kernel's output at seeded inputs, by
    'kernel K N B'."""
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for name, k, n in BITS_SHAPES:
        ws, scale = _weights(name, k, n, 1, g, dev)
        for b in BITS_ROWS:
            x = _x(name, b, k, g, dev)
            got = qm.KERNELS[name](x, ws[0], scale).cpu()
            out[f"{name} {k} {n} {b}"] = hashlib.sha256(
                got.numpy().tobytes()).hexdigest()
    return out


def sass_mma(build) -> dict:
    """Tensor-core instructions (HMMA, IMMA) in each function of the tree's
    built library that has any."""
    so = build.build()
    cuobjdump = os.path.join(os.path.dirname(build._find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        counts = {op: block.count(op) for op in ("HMMA", "IMMA")}
        if any(counts.values()):
            out[block.split("\n", 1)[0].strip()] = counts
    return out


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
                    help="print the HMMA and IMMA counts of each kernel "
                         "function")
    ap.add_argument("--variants", nargs="+", default=[], metavar="NAME",
                    help="also time these W8A8_VARIANTS copies of the "
                         "source at #16's shapes ('all': every one)")
    ap.add_argument("--compare", nargs=2, metavar="RUN",
                    help="two --save files: which outputs are bit-equal")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    variants = (list(W8A8_VARIANTS) if args.variants == ["all"]
                else args.variants)
    unknown = sorted(set(variants) - set(W8A8_VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
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
        _log("sass", sass_mma(_build))
    libs = build_variants(_build, variants)
    g = torch.Generator(device=dev).manual_seed(13)
    for name in args.kernels.split(","):
        for k, n in TIMED_SHAPES[name]:
            timing(qm, name, k, n, g, dev,
                   libs if name == "w8a8" else None)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)),
                    exist_ok=True)
        with open(args.save, "w") as f:
            json.dump(output_hashes(qm, dev), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
