"""ChromaDB-style collection API over the dense index.

The counterpart of ``persian_rag_tpu.index.collections`` on the port's
`DenseIndex`: add(documents, embeddings, metadatas, ids) in batches,
query(query_embeddings | query_texts, n_results) returning the Chroma
response shape (ids / documents / metadatas / distances lists of lists;
cosine distance = 1 - cosine similarity).

Persistence keeps the JAX package's directory format, so each package
opens the other's: a CollectionStore with a path writes each collection to
``<path>/<name>/``: ``index.npz`` / ``index.meta.json`` (DenseIndex's
format), a JSON sidecar ``collection.json`` (name, metric, dim, ids,
documents, metadatas), and one ``shard-NNNNNN.npz`` / ``.json`` pair per
``add`` (append-only; `save` consolidates them into the base files).

Three faults of the JAX module are corrected here (chosen divergences):

* a crash-safe consolidation: `save` records the highest shard number it
  consolidated in the sidecar (``consolidated_through``, which the JAX
  loader ignores), and `load` skips shards at or below it, so a shard
  whose unlink failed after consolidation is not replayed twice (the JAX
  `save` swallows the failed unlink and its `load` replays the shard on top
  of the sidecar). `load` also reads no more index rows than the sidecar
  has ids, so a crash between writing the index and the sidecar leaves
  the shards to replay;
* new shards are numbered one past the highest shard number on disk or
  consolidated, so a new shard never sorts before a leftover one (the JAX
  module numbers them by the count of shard files);
* `get_or_create_collection` raises on a metric mismatch for a collection
  already open in the store, not only for one reopened from disk.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np

from persian_rag_tpu_torch.core.device import resolve_device, to_host
from persian_rag_tpu_torch.index.dense import DenseIndex

_SIDECAR = "collection.json"
_SHARD = re.compile(r"^shard-(\d+)\.json$")


def _shard_numbers(directory: str) -> List[int]:
    """The numbers of the shard pairs in `directory`, ascending."""
    return sorted(
        int(m.group(1)) for m in map(_SHARD.match, os.listdir(directory)) if m
    )


def _shard_stem(directory: str, number: int) -> str:
    return os.path.join(directory, f"shard-{number:06d}")


class Collection:
    def __init__(
        self,
        name: str,
        dim: Optional[int] = None,
        metric: str = "cosine",
        encoder=None,
        mesh=None,
        persist_dir: Optional[str] = None,
        device=None,
    ):
        """device: where the index lives; default the encoder's device,
        else the card (raises without CUDA). mesh: the index shards over
        it, and its first device is the collection's."""
        self.name = name
        self.metric = metric
        self.encoder = encoder
        self.mesh = mesh
        self.persist_dir = persist_dir
        if mesh is not None:
            device = mesh.device
        elif device is None and encoder is not None:
            device = encoder.device
        self.device = resolve_device(device)
        self._dim = dim
        self._index: Optional[DenseIndex] = None
        self._ids: List[str] = []
        self._documents: List[str] = []
        self._metadatas: List[Dict] = []
        # the highest shard number the base files cover (-1: none)
        self._consolidated_through = -1
        sidecar = None if persist_dir is None else os.path.join(
            persist_dir, _SIDECAR)
        if sidecar is not None and os.path.exists(sidecar):
            with open(sidecar, "r", encoding="utf-8") as f:
                self._consolidated_through = json.load(f).get(
                    "consolidated_through", -1)

    def count(self) -> int:
        return len(self._ids)

    def _new_index(self, dim: int) -> DenseIndex:
        return DenseIndex(dim, metric=self.metric, mesh=self.mesh,
                          device=self.device)

    def add(
        self,
        ids: Sequence[str],
        documents: Optional[Sequence[str]] = None,
        embeddings: Optional[np.ndarray] = None,
        metadatas: Optional[Sequence[Dict]] = None,
        batch_size: int = 500,
    ) -> None:
        """Batched adds (the reference inserts in batches of 500). With a
        persist_dir each add also writes one shard pair."""
        n = len(ids)
        if embeddings is None:
            if self.encoder is None or documents is None:
                raise ValueError("need embeddings, or documents + an encoder")
            embeddings = self.encoder.encode(list(documents))
        embeddings = np.asarray(embeddings, np.float32)
        if self._index is None:
            self._dim = embeddings.shape[1]
            self._index = self._new_index(self._dim)
        for start in range(0, n, batch_size):
            self._index.add(embeddings[start : start + batch_size])
        self._ids.extend(ids)
        self._documents.extend(documents or [""] * n)
        self._metadatas.extend(metadatas or [{}] * n)
        if self.persist_dir is not None:
            self._save_shard(
                self.persist_dir, list(ids),
                list(documents or [""] * n),
                list(metadatas or [{}] * n),
                embeddings,
            )

    def query(
        self,
        query_embeddings: Optional[np.ndarray] = None,
        query_texts: Optional[Sequence[str]] = None,
        n_results: int = 10,
    ) -> Dict[str, List[List]]:
        if self._index is None:
            raise ValueError("empty collection")
        if query_embeddings is None:
            if self.encoder is None or query_texts is None:
                raise ValueError("need query_embeddings, or query_texts + encoder")
            query_embeddings = self.encoder.encode(list(query_texts))
        scores, idx = to_host(*self._index.search(
            np.asarray(query_embeddings, np.float32), n_results
        ))
        if scores.ndim == 1:
            scores, idx = scores[None], idx[None]
        out = {"ids": [], "documents": [], "metadatas": [], "distances": []}
        for qi in range(scores.shape[0]):
            row_ids, row_docs, row_meta, row_dist = [], [], [], []
            for s, i in zip(scores[qi], idx[qi]):
                if 0 <= i < len(self._ids):
                    row_ids.append(self._ids[i])
                    row_docs.append(self._documents[i])
                    row_meta.append(self._metadatas[i])
                    # Chroma's cosine space returns distance = 1 - cos
                    row_dist.append(
                        1.0 - float(s) if self.metric == "cosine" else float(s)
                    )
            out["ids"].append(row_ids)
            out["documents"].append(row_docs)
            out["metadatas"].append(row_meta)
            out["distances"].append(row_dist)
        return out

    # -- persistence -----------------------------------------------------------

    def _save_shard(
        self,
        directory: str,
        ids: List[str],
        documents: List[str],
        metadatas: List[Dict],
        embeddings: np.ndarray,
    ) -> None:
        """Append one add() batch as a shard pair numbered one past the
        highest on disk or consolidated. The base sidecar is written once
        (empty) so a reopening store can identify the collection even if
        the process dies before the first consolidation."""
        os.makedirs(directory, exist_ok=True)
        if not os.path.exists(os.path.join(directory, _SIDECAR)):
            self._write_sidecar(directory, [], [], [],
                                self._consolidated_through)
        number = max([self._consolidated_through]
                     + _shard_numbers(directory)) + 1
        stem = _shard_stem(directory, number)
        np.savez(stem + ".npz", vectors=np.asarray(embeddings, np.float32))
        tmp = stem + ".json.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"ids": ids, "documents": documents,
                 "metadatas": metadatas},
                f, ensure_ascii=False,
            )
        os.replace(tmp, stem + ".json")

    def _write_sidecar(self, directory, ids, documents, metadatas,
                       consolidated_through: int) -> None:
        sidecar = {
            "name": self.name,
            "metric": self.metric,
            "dim": self._dim,
            "ids": ids,
            "documents": documents,
            "metadatas": metadatas,
            "consolidated_through": consolidated_through,
        }
        tmp = os.path.join(directory, _SIDECAR + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(sidecar, f, ensure_ascii=False)
        os.replace(tmp, os.path.join(directory, _SIDECAR))

    def save(self, directory: str) -> None:
        """Write the collection to `directory`: the DenseIndex payload
        (vectors npz + meta json) and the sidecar, which then covers every
        shard on disk; then remove those shards (a failed removal leaves a
        shard that `load` skips).

        Vectors still staged host-side are written from that copy, so a
        persisted add never forces a device commit."""
        os.makedirs(directory, exist_ok=True)
        covered = _shard_numbers(directory)
        if self._index is not None:
            idx = self._index
            if idx._pending and idx._device_corpus is None:
                vectors = np.concatenate(idx._pending, axis=0)
                if idx.metric == "cosine":
                    norms = np.linalg.norm(vectors, axis=1, keepdims=True)
                    vectors = vectors / np.maximum(norms, 1e-12)
                base = os.path.join(directory, "index")
                np.savez(base + ".npz", vectors=vectors)
                with open(base + ".meta.json", "w", encoding="utf-8") as f:
                    json.dump(
                        {
                            "dim": idx.dim,
                            "metric": idx.metric,
                            "ntotal": vectors.shape[0],
                        },
                        f,
                    )
            else:
                idx.save(os.path.join(directory, "index"))
        through = max([self._consolidated_through] + covered)
        self._write_sidecar(
            directory, self._ids, self._documents, self._metadatas, through
        )
        self._consolidated_through = through
        for number in covered:
            stem = _shard_stem(directory, number)
            for suffix in (".npz", ".json"):
                try:
                    os.remove(stem + suffix)
                except OSError:
                    pass  # skipped on replay: the sidecar covers it

    @classmethod
    def load(
        cls,
        directory: str,
        encoder=None,
        mesh=None,
        persist: bool = False,
        device=None,
    ) -> "Collection":
        with open(
            os.path.join(directory, _SIDECAR), "r", encoding="utf-8"
        ) as f:
            sidecar = json.load(f)
        col = cls(
            sidecar["name"],
            dim=sidecar.get("dim"),
            metric=sidecar["metric"],
            encoder=encoder,
            mesh=mesh,
            device=device,
        )
        col.persist_dir = directory if persist else None
        col._consolidated_through = sidecar.get("consolidated_through", -1)
        col._ids = list(sidecar["ids"])
        col._documents = list(sidecar["documents"])
        col._metadatas = list(sidecar["metadatas"])
        index_path = os.path.join(directory, "index")
        if os.path.exists(index_path + ".meta.json") and col._ids:
            # rows past the sidecar's ids were written by a save that did
            # not reach its sidecar: their shards replay below
            with np.load(index_path + ".npz") as z:
                vectors = np.asarray(z["vectors"], np.float32)
            col._index = col._new_index(vectors.shape[1])
            col._index.add(vectors[: len(col._ids)])
            col._index.commit()
            col._dim = col._index.dim
        # replay the shards written after the last consolidation, in order
        numbers = [n for n in _shard_numbers(directory)
                   if n > col._consolidated_through]
        for number in numbers:
            stem = _shard_stem(directory, number)
            with open(stem + ".json", "r", encoding="utf-8") as f:
                rec = json.load(f)
            with np.load(stem + ".npz") as z:
                vectors = np.asarray(z["vectors"], np.float32)
            if col._index is None:
                col._dim = vectors.shape[1]
                col._index = col._new_index(col._dim)
            col._index.add(vectors)
            col._ids.extend(rec["ids"])
            col._documents.extend(rec["documents"])
            col._metadatas.extend(rec["metadatas"])
        if numbers and persist:
            # consolidate so the shard list doesn't grow without bound
            col.save(directory)
        return col


class CollectionStore:
    """get_or_create_collection facade (chromadb.PersistentClient-like).

    With `path` set, collections persist under ``<path>/<name>/`` after
    every add, a fresh store over the same path lists and reopens them, and
    delete_collection removes the on-disk copy too."""

    def __init__(self, encoder=None, mesh=None, path: Optional[str] = None,
                 device=None):
        self._collections: Dict[str, Collection] = {}
        self.encoder = encoder
        self.mesh = mesh
        self.path = path
        self.device = device
        if path is not None:
            os.makedirs(path, exist_ok=True)

    def _dir(self, name: str) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, name)

    def get_or_create_collection(
        self, name: str, metric: str = "cosine"
    ) -> Collection:
        if name not in self._collections:
            d = self._dir(name)
            if d is not None and os.path.exists(os.path.join(d, _SIDECAR)):
                col = Collection.load(
                    d, encoder=self.encoder, mesh=self.mesh, persist=True,
                    device=self.device,
                )
            else:
                col = Collection(
                    name,
                    metric=metric,
                    encoder=self.encoder,
                    mesh=self.mesh,
                    persist_dir=d,
                    device=self.device,
                )
            self._collections[name] = col
        col = self._collections[name]
        if col.metric != metric:
            # chromadb raises on a metric mismatch; serving cosine
            # distances to a caller who asked for l2 would corrupt results
            raise ValueError(
                f"collection {name!r} exists with metric "
                f"{col.metric!r}; requested {metric!r}"
            )
        return col

    def list_collections(self) -> List[str]:
        names = set(self._collections)
        if self.path is not None and os.path.isdir(self.path):
            for entry in os.listdir(self.path):
                if os.path.exists(
                    os.path.join(self.path, entry, _SIDECAR)
                ):
                    names.add(entry)
        return sorted(names)

    def persist(self) -> None:
        """Flush every open collection to disk (adds already persist
        eagerly; this covers collections mutated through their index)."""
        if self.path is None:
            return
        for name, col in self._collections.items():
            col.save(os.path.join(self.path, name))

    def delete_collection(self, name: str) -> None:
        self._collections.pop(name, None)
        d = self._dir(name)
        if d is not None and os.path.isdir(d):
            shutil.rmtree(d)
