"""QA dataset loading and train/test preparation.

Capability-equivalent to the reference's DataLoader (reference:
src/data_loader.py): loads the two Persian QA datasets
(Gholamreza/pquad, SajjadAyoubi/persian_qa) from the HuggingFace hub or a
local cache, extracts PDFs, applies the same record filters
(len(question) > 10, len(answer) > 5 — src/data_loader.py:97,:111) and
the same shuffled train/test split (:122-132).

This environment has zero network egress, so when the hub is unreachable
a deterministic synthetic Persian QA corpus stands in — every pipeline
stays runnable end-to-end offline, and real datasets drop in unchanged
when a cache exists.

The counterpart of ``persian_rag_tpu.data.loader``. One chosen
divergence: `load_datasets` is a download from the HuggingFace hub, which
the port does not do (it has no `datasets` dependency), so it raises
NotImplementedError where the JAX loader prints and returns (None, None).
`prepare_qa_data_for_training` takes any mapping with a "train" list, and
`save_processed_data` writes through the `csv` module.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple

from persian_rag_tpu_torch.core.config import write_csv_records
from persian_rag_tpu_torch.text.persian import PersianTextProcessor

_TOPICS = [
    ("دارو", "درمان بیماری"),
    ("قلب", "پمپاژ خون در بدن"),
    ("کبد", "تصفیه سموم بدن"),
    ("واکسن", "پیشگیری از بیماری"),
    ("آنتی بیوتیک", "مقابله با عفونت باکتریایی"),
    ("ویتامین", "تقویت سیستم ایمنی"),
    ("انسولین", "تنظیم قند خون"),
    ("آسپرین", "کاهش درد و التهاب"),
]


def synthetic_persian_qa(
    n: int = 2000, seed: int = 0
) -> List[Dict[str, str]]:
    """Deterministic synthetic Persian QA records with the reference's
    {question, context, answer, source} schema."""
    rng = random.Random(seed)
    records = []
    for i in range(n):
        topic, function = _TOPICS[rng.randrange(len(_TOPICS))]
        dose = rng.randrange(1, 500)
        question = f"کاربرد {topic} شماره {i} در پزشکی چیست؟"
        answer = f"{topic} برای {function} استفاده می شود"
        context = (
            f"{topic} یکی از مهم ترین ابزارهای پزشکی است. "
            f"{answer}. دوز مصرفی معمول {dose} میلی گرم در روز است. "
            f"مصرف {topic} باید طبق دستور پزشک باشد."
        )
        records.append(
            {
                "question": question,
                "context": context,
                "answer": answer,
                "source": "synthetic",
            }
        )
    return records


class DataLoader:
    def __init__(self):
        self.text_processor = PersianTextProcessor()

    def load_datasets(self) -> Tuple[Optional[object], Optional[object]]:
        """The HF hub datasets the reference uses (src/data_loader.py:27,
        :31) are a download: the port raises instead of fetching them.
        Pass local records ({"train": [...]}) to
        `prepare_qa_data_for_training`, or use `synthetic_persian_qa`."""
        raise NotImplementedError(
            "load_datasets downloads Gholamreza/pquad and "
            "SajjadAyoubi/persian_qa from the HuggingFace hub; the port does "
            "not download: pass local records ({'train': [...]}) to "
            "prepare_qa_data_for_training, or use synthetic_persian_qa")

    def extract_pdf(self, pdf_path: str) -> str:
        from persian_rag_tpu_torch.text.pdf import extract_pdf_text

        text = extract_pdf_text(pdf_path)
        return self.text_processor.normalize_text(text)

    def preprocess_text(self, text: str) -> str:
        return self.text_processor.normalize_text(text)

    def prepare_qa_data_for_training(
        self, pquad=None, persian_qa=None, synthetic_fallback: bool = True
    ) -> List[Dict]:
        """Build {question, context, answer, source} training records with
        the reference's length filters (src/data_loader.py:94-117)."""
        records: List[Dict] = []
        if pquad is not None and "train" in pquad:
            for item in pquad["train"]:
                question = self.preprocess_text(item.get("question", ""))
                context = self.preprocess_text(item.get("context", ""))
                answers = item.get("answers", {})
                if answers and answers.get("text"):
                    answer = self.preprocess_text(answers["text"][0])
                    if len(question) > 10 and len(answer) > 5:
                        records.append(
                            {
                                "question": question,
                                "context": context,
                                "answer": answer,
                                "source": "pquad",
                            }
                        )
        if persian_qa is not None and "train" in persian_qa:
            for item in persian_qa["train"]:
                question = self.preprocess_text(item.get("question", ""))
                answer = self.preprocess_text(item.get("answer", ""))
                if len(question) > 10 and len(answer) > 5:
                    records.append(
                        {
                            "question": question,
                            "context": "",
                            "answer": answer,
                            "source": "persian_qa",
                        }
                    )
        if not records and synthetic_fallback:
            records = synthetic_persian_qa()
        return records

    def create_test_split(
        self, qa_data: List[Dict], test_size: float = 0.2, seed: int = 0
    ) -> Tuple[List[Dict], List[Dict]]:
        """Shuffled split (reference: src/data_loader.py:122-132); seeded
        here for reproducibility."""
        data = list(qa_data)
        random.Random(seed).shuffle(data)
        split = int(len(data) * (1 - test_size))
        return data[:split], data[split:]

    def save_processed_data(self, data: List[Dict], filename: str,
                            directory: str = "data/processed") -> str:
        os.makedirs(directory, exist_ok=True)
        filepath = os.path.join(directory, filename)
        write_csv_records(filepath, data)
        return filepath
