"""Device time of the grouped stage 1 (#3) at each query block it can run,
on the card: the measurement behind ``flat_topk.grouped_geometry``'s pick.

The C entry ``prt_extract_candidates_grouped`` takes the query block from
its caller, so this script launches it at 8, 16 and 32 queries a block on
the same inputs and reports the device time of queued calls beside the
block's shared memory and the number of blocks an SM holds, and whether
every block size returns the same keys (it must: the chain does not
depend on the block). Shapes: Q = 64 and 512 over chip_smoke.py's
100,000 seeded unit rows of width 384 in bf16, l2, tile 1,024, group 16
(depth 2); and the lane pick, Q = 2,048 over 1,000,000 rows, dot, tile
2,048, 16 slots, depth 3.

    python -m persian_rag_tpu_torch.scripts.grouped_qb   # from the repo root

Needs a card; prints one ``qb`` line a (shape, block) and the card's name
and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

QBS = (8, 16, 32)
SHAPES = (  # name, Q, N, tile_n, group, depth, l2
    ("table Q=64", 64, 100_000, 1024, 16, 2, True),
    ("table Q=512", 512, 100_000, 1024, 16, 2, True),
    ("lane Q=2048", 2048, 1_000_000, 2048, 16, 3, False),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("grouped_qb needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from persian_rag_tpu_torch.ops import _build
    from persian_rag_tpu_torch.ops import flat_topk as ft

    lib = _build.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, n_easy = cs.DIM, 4
    for name, n_q, n, tile_n, group, depth, l2 in SHAPES:
        rows = torch.randn(n, d, device=dev, generator=g)
        rows /= rows.norm(dim=1, keepdim=True)
        q = cs._queries_near(rows, n_q, g)
        rows = rows.bfloat16()
        cn = torch.sum(rows.float() ** 2, dim=-1) if l2 else None
        out = torch.empty((n_q, -(-n // tile_n), n_easy + 1),
                          dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        first = None
        for qb in QBS:
            def launch(qb=qb):
                err = lib.prt_extract_candidates_grouped(
                    q.data_ptr(), rows.data_ptr(),
                    cn.data_ptr() if cn is not None else None,
                    out.data_ptr(), n_q, n, d, tile_n, n_easy, group, depth,
                    0, 0, qb, stream)
                _build.check(lib, err, "grouped kernel launch")

            launch()
            torch.cuda.synchronize()
            same = True if first is None else torch.equal(out, first)
            first = out.clone() if first is None else first
            big = n_q * n > 10 ** 8
            smem = ft.grouped_smem(d, 2, qb, tile_n, group, depth)[0]
            line = {"shape": name, "qb": qb, "Q": n_q, "N": n,
                    "tile_n": tile_n, "group": group, "depth": depth,
                    "queued_ms": cs.cuda_queued_ms(
                        launch, launches=3 if big else 20,
                        reps=3 if big else 7, warmup=1 if big else 3),
                    "smem": smem,
                    "per_sm": min(2, ft._SM_SMEM // (
                        smem + ft._BLOCK_SMEM_RESERVED)),
                    "picked": ft.grouped_geometry(
                        n_q, n, d, tile_n, group, depth, 2, sms).queries,
                    "same_keys": same}
            print("qb " + json.dumps(line), flush=True)
            if not same:
                raise AssertionError(f"{name}: keys at {qb} queries a block "
                                     f"differ from {QBS[0]}'s")
        del rows, q, out
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
