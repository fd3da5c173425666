"""Served load and proof rate of dense deployment B, for comparing two
revisions of the port on the card in one call.

Host times move between calls to the card (PERF.md section 5), so a change
to the serving path is read only beside the version it replaces, on one
card in one call. This script serves deployment B of ``chip_smoke.py``
(paraphrase-multilingual-MiniLM-L12-v2 at full width on random weights,
seed 0, over its 100,000 seeded Persian chunks; dense f32, l2, stage 1
pinned to bf16) with whichever ``persian_rag_tpu_torch`` comes first on the
import path: run it by path, once per tree, in one command to the card, in
the order other, this, this, other:

    git archive <rev> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 persian_rag_tpu_torch/scripts/serve_ab.py \\
          --label $t --save build/serve_ab/$(basename $(realpath $t)).json
    done
    python3 persian_rag_tpu_torch/scripts/serve_ab.py \\
        --compare build/serve_ab/parent.json build/serve_ab/repo.json

A run sends ``chip_smoke.py``'s /search load (a warm-up, 200 requests of
1-16 queries from one client, then 240 from 8 client processes; top_k 5 or
10, drawn from the seed) to a ``RetrievalServer(max_batch=64,
max_wait_ms=5.0)`` and prints one ``serve`` line: sequential and
concurrent p50 / p90 ms, queries a second, the server's dispatches,
``served_proof_ok``, the share of served queries whose two-stage proof
held (a query's verdict depends on its keys and on the k it is served at,
so on how the server grouped the requests), and ``proof_ok``, the same
share over the 440 requests sent in process one by one at their own top_k
(no grouping: the same on every run of one tree). ``--save`` writes the
served id lists' hash and both shares; ``--compare`` prints them for two
runs.

A run needs a card; ``--compare`` runs anywhere.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# the chip_smoke.py of this script's tree: its corpus, load and timing
CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def _log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def run(label: str, save, pool) -> None:
    import chip_smoke as cs
    from persian_rag_tpu_torch.models.encoder import EncoderConfig
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
    from persian_rag_tpu_torch.serve.api import RetrievalServer

    rng = np.random.default_rng(cs.SEED)
    enc = SentenceEncoder(EncoderConfig.minilm_l12(), max_seq_len=128,
                          device="cuda", seed=cs.SEED)
    chunks = cs.make_chunks(cs.N_CORPUS, rng)
    rs = RetrievalSystem(method="dense", encoder=enc, dense_metric="l2")
    if not rs.load_chunks_and_index(chunks):
        raise RuntimeError("load_chunks_and_index failed")
    index = rs.dense_index
    index._set_stage1_mode("bf16")
    verdicts = []
    note = index._note_proof_verdict

    def recording_note(ok):
        if ok is not None:
            verdicts.append(ok.clone())
        note(ok)

    index._note_proof_verdict = recording_note
    n_jobs = cs.SEQ_REQUESTS + cs.CLIENTS * cs.PER_CLIENT
    sizes = [int(v) for v in rng.choice(cs.REQUEST_SIZES, size=n_jobs)]
    top_ks = [int(v) for v in rng.choice((5, 10), size=n_jobs)]
    batches = cs.make_queries(sizes, rng)
    with RetrievalServer(rs, max_batch=64, max_wait_ms=5.0) as server:
        for batch in cs.make_queries(cs.REQUEST_SIZES, rng):
            cs._post(server.url + "/search", {"queries": batch, "top_k": 10})
        verdicts.clear()
        responses, latencies, conc_s, dispatches = cs._drive(
            server, list(zip(batches, top_ks)), pool, cs.SEQ_REQUESTS)
    served_ok = torch.cat(verdicts) if verdicts else torch.zeros(0)
    verdicts.clear()
    for batch, k in zip(batches, top_ks):
        rs.retrieve_batch(batch, k)
    ok = torch.cat(verdicts) if verdicts else torch.zeros(0)
    ids = [[h["id"] for h in row] for r in responses for row in r["results"]]
    line = {"label": label, "stage1_mode": index._stage1_mode,
            **cs._load_stats(latencies, sizes, cs.SEQ_REQUESTS, conc_s),
            "dispatches": list(dispatches),
            "served_proof_ok": float(served_ok.float().mean()),
            "proof_ok": float(ok.float().mean()), "proof_queries": ok.numel()}
    _log("serve", line)
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        with open(save, "w") as f:
            json.dump({"ids": hashlib.sha256(json.dumps(ids).encode())
                       .hexdigest(), "proof_ok": line["proof_ok"],
                       "served_proof_ok": line["served_proof_ok"]}, f)


def compare(path_a: str, path_b: str) -> int:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    _log("same", {"ids": a["ids"] == b["ids"],
                  "proof_ok": [a["proof_ok"], b["proof_ok"]],
                  "served_proof_ok": [a["served_proof_ok"],
                                      b["served_proof_ok"]]})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name printed with the run")
    ap.add_argument("--save", help="write the served ids' hash to this file")
    ap.add_argument("--compare", nargs=2, metavar="RUN",
                    help="two --save files: their ids and proof shares")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("serve_ab needs a CUDA card", file=sys.stderr)
        return 2
    # last on the path: the package on PYTHONPATH stays the one measured
    sys.path.append(str(CHIP_SMOKE.parent))
    import chip_smoke as cs
    from persian_rag_tpu_torch.serve import api

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    _log("run", {"label": args.label, "package": os.path.dirname(api.__file__),
                 "device": torch.cuda.get_device_name(0),
                 "nvidia_smi": smi.stdout.strip()})
    with multiprocessing.get_context("spawn").Pool(cs.CLIENTS) as pool:
        run(args.label, args.save, pool)
    return 0


if __name__ == "__main__":
    sys.exit(main())
