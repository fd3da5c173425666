"""Corpus construction: word- and sentence-based chunking.

Capability-equivalent to the reference's TextChunker (reference:
src/chunking.py): word chunks of ``word_chunk_size`` words with
``word_overlap`` overlap and a >=10-word tail (src/chunking.py:42-66),
sentence chunks of ``sentences_per_chunk`` sentences (:118-174), the same
chunk record schema, streaming generators for memory, and CSV
persistence. The reference's fixed 50k/100k-char segmentation (a
host-memory workaround that resets chunk state at segment seams) is
replaced by a true streaming tokenizer over the whole text, which yields
seamless chunk boundaries at equal memory.

The counterpart of ``persian_rag_tpu.text.chunking``, with the same
records. The chunk CSVs go through the `csv` module
(`core.config.write_csv_records`) and are read back by
`retrieval.system.read_csv_records`: the files and records pandas gives,
with no pandas.
"""
from __future__ import annotations

import os
from typing import Dict, Generator, Iterable, List, Tuple

from persian_rag_tpu_torch.core.config import write_csv_records
from persian_rag_tpu_torch.text.persian import PersianTextProcessor


class TextChunker:
    def __init__(self, config, sentence_split_mode: str = "auto"):
        """config: the port's Config or a raw dict with a 'chunking'
        section (word_chunk_size / word_overlap / sentences_per_chunk).

        sentence_split_mode:
          "auto"   — hazm-equivalent tokenizer (splits on . ! ? ؟ keeping
                     terminators; matches the reference running WITH hazm,
                     its primary path at src/chunking.py:135-138).
          "simple" — byte-for-byte the reference's hazm-failure fallback
                     (src/chunking.py:139-140): split on '.' only and
                     re-append '.' to every fragment, including an
                     unterminated trailing one.
        """
        if sentence_split_mode not in ("auto", "simple"):
            raise ValueError(sentence_split_mode)
        self.config = config
        self.sentence_split_mode = sentence_split_mode
        self.text_processor = PersianTextProcessor()

    def _chunking_params(self) -> Tuple[int, int, int]:
        chunking = self.config["chunking"]
        return (
            int(chunking["word_chunk_size"]),
            int(chunking["word_overlap"]),
            int(chunking["sentences_per_chunk"]),
        )

    # -- word-based ----------------------------------------------------------

    def _iter_words(self, text: str, segment_chars: int = 1_000_000
                    ) -> Generator[str, None, None]:
        """Stream words without materializing the full token list; segments
        split on whitespace so no word straddles a boundary."""
        position = 0
        n = len(text)
        while position < n:
            end = min(position + segment_chars, n)
            if end < n:
                # retreat to the last whitespace so words stay intact
                cut = text.rfind(" ", position, end)
                if cut > position:
                    end = cut
            segment = self.text_processor.normalize_text(text[position:end])
            for word in segment.split():
                yield word
            position = end

    def word_based_chunking_generator(
        self, text: str
    ) -> Generator[Dict, None, None]:
        chunk_size, overlap, _ = self._chunking_params()
        chunk_id = 0
        start_idx = 0
        current: List[str] = []
        for word in self._iter_words(text):
            current.append(word)
            if len(current) >= chunk_size:
                yield {
                    "id": f"word_chunk_{chunk_id}",
                    "text": " ".join(current),
                    "start_word": start_idx,
                    "end_word": start_idx + len(current),
                    "num_words": len(current),
                    "chunk_type": "word_based",
                    "overlap_words": overlap if chunk_id > 0 else 0,
                }
                chunk_id += 1
                if overlap > 0:
                    current = current[-overlap:]
                    start_idx += chunk_size - overlap
                else:
                    current = []
                    start_idx += chunk_size
        # tail chunk only if it carries enough new content
        if current and len(current) >= 10 and (chunk_id == 0 or len(current) > overlap):
            yield {
                "id": f"word_chunk_{chunk_id}",
                "text": " ".join(current),
                "start_word": start_idx,
                "end_word": start_idx + len(current),
                "num_words": len(current),
                "chunk_type": "word_based",
                "overlap_words": 0,
            }

    def word_based_chunking(self, text: str) -> List[Dict]:
        return list(self.word_based_chunking_generator(text))

    # -- sentence-based -------------------------------------------------------

    def sentence_based_chunking(self, text: str) -> List[Dict]:
        _, _, per_chunk = self._chunking_params()
        normalized = self.text_processor.normalize_text(text)
        if self.sentence_split_mode == "simple":
            sentences = []
        else:
            sentences = self.text_processor.tokenize_sentences(normalized)
        if not sentences:
            # reference fallback split (src/chunking.py:139-140)
            sentences = [
                s.strip() + "." for s in normalized.split(".") if s.strip()
            ]
        chunks: List[Dict] = []
        for i in range(0, len(sentences), per_chunk):
            group = sentences[i : i + per_chunk]
            if not group:
                continue
            chunk_text = " ".join(group)
            chunks.append(
                {
                    "id": f"sentence_chunk_{len(chunks)}",
                    "text": chunk_text,
                    "start_sentence": i,
                    "end_sentence": min(i + per_chunk, len(sentences)),
                    "num_sentences": len(group),
                    "num_words": len(chunk_text.split()),
                    "chunk_type": "sentence_based",
                }
            )
        return chunks

    # -- document-level -------------------------------------------------------

    def process_pdf_document(
        self, pdf_text: str
    ) -> Tuple[List[Dict], List[Dict]]:
        """Both chunkings over one document (reference: src/chunking.py:176)."""
        if not pdf_text or len(pdf_text.strip()) < 100:
            return [], []
        return (
            self.word_based_chunking(pdf_text),
            self.sentence_based_chunking(pdf_text),
        )

    def get_chunk_statistics(self, chunks: List[Dict]) -> Dict:
        if not chunks:
            return {}
        word_counts = [len(c["text"].split()) for c in chunks]
        total = sum(word_counts)
        return {
            "total_chunks": len(chunks),
            "avg_words_per_chunk": total / len(chunks),
            "min_words_per_chunk": min(word_counts),
            "max_words_per_chunk": max(word_counts),
            "total_words": total,
            "chunk_type": chunks[0].get("chunk_type", "unknown"),
        }

    # -- persistence ----------------------------------------------------------

    def save_chunks(
        self, chunks: Iterable[Dict], filename: str, directory: str = "data/processed"
    ) -> str:
        os.makedirs(directory, exist_ok=True)
        filepath = os.path.join(directory, filename)
        write_csv_records(filepath, chunks)
        return filepath

    def load_chunks(
        self, filename: str, directory: str = "data/processed"
    ) -> List[Dict]:
        from persian_rag_tpu_torch.retrieval.system import read_csv_records

        filepath = (
            filename
            if os.path.isabs(filename) or os.path.exists(filename)
            else os.path.join(directory, filename)
        )
        return read_csv_records(filepath)
