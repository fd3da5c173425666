"""The port's data loader against the JAX package's.

`synthetic_persian_qa` for several seeds and sizes, the training-record
filters of `prepare_qa_data_for_training` on local records, the seeded
`create_test_split`, `extract_pdf` / `preprocess_text`, and
`save_processed_data` (the JAX writer is pandas: byte-equal files).
`load_datasets` is a download: the port raises (a chosen divergence; the
JAX loader would try the HuggingFace hub, so it is not called here).
"""
import zlib

import pytest

from persian_rag_tpu.data import loader as jloader
from persian_rag_tpu_torch.data import loader as tloader


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 3), (57, 0), (400, 0),
                                    (400, 1), (2000, 9)])
def test_synthetic_qa_equals_jax(n, seed):
    got = tloader.synthetic_persian_qa(n, seed=seed)
    assert got == jloader.synthetic_persian_qa(n, seed=seed)
    assert len(got) == n
    assert tloader.synthetic_persian_qa() == jloader.synthetic_persian_qa()


LOCAL_PQUAD = {"train": [
    {"question": "داروی  قلب\nچیست و چه کاربردی دارد؟", "context": "متن كوتاه",
     "answers": {"text": ["برای درمان قلب"]}},
    {"question": "کوتاه؟", "context": "x", "answers": {"text": ["پاسخ بلند"]}},
    {"question": "پرسش بدون پاسخ معتبر؟", "answers": {"text": []}},
    {"question": "پرسش با پاسخ خیلی کوتاه؟", "answers": {"text": ["بله"]}},
    {"question": "ويتامين ث برای چیست؟", "context": "ويتامين",
     "answers": {"text": ["تقویت ایمنی بدن", "دوم"]}},
]}
LOCAL_PERSIAN_QA = {"train": [
    {"question": "آسپرین چه عوارضی دارد؟", "answer": "ناراحتی معده و خونریزی"},
    {"question": "؟", "answer": "پاسخ طولانی"},
    {"question": "پرسشی که پاسخ ندارد؟"},
]}


@pytest.mark.parametrize("pquad,persian_qa", [
    (LOCAL_PQUAD, LOCAL_PERSIAN_QA), (LOCAL_PQUAD, None),
    (None, LOCAL_PERSIAN_QA), ({"validation": []}, None), (None, None)])
def test_training_records_and_split_equal_jax(pquad, persian_qa):
    got = tloader.DataLoader().prepare_qa_data_for_training(pquad, persian_qa)
    want = jloader.DataLoader().prepare_qa_data_for_training(
        pquad, persian_qa)
    assert got == want and got
    for test_size, seed in ((0.2, 0), (0.5, 3)):
        assert tloader.DataLoader().create_test_split(got, test_size, seed) \
            == jloader.DataLoader().create_test_split(want, test_size, seed)
    assert tloader.DataLoader().prepare_qa_data_for_training(
        None, None, synthetic_fallback=False) == []


def test_load_datasets_raises_instead_of_downloading():
    with pytest.raises(NotImplementedError, match="does not download"):
        tloader.DataLoader().load_datasets()


def test_pdf_and_preprocess_equal_jax(tmp_path):
    content = ("BT (" + "داروی  قلب\n\nو ويتامين".replace("\n", "\\n")
               + ") Tj ET").encode("utf-8")
    stream = zlib.compress(content)
    pdf = (b"%PDF-1.4\n1 0 obj << /Length " + str(len(stream)).encode()
           + b" /Filter /FlateDecode >> stream\n" + stream
           + b"\nendstream endobj\n%%EOF\n")
    path = tmp_path / "x.pdf"
    path.write_bytes(pdf)
    got = tloader.DataLoader().extract_pdf(str(path))
    assert got == jloader.DataLoader().extract_pdf(str(path))
    assert got == "داروی قلب و ویتامین"
    raw = "  متن\n\nكوتاه  با  اِعراب  "
    assert tloader.DataLoader().preprocess_text(raw) == \
        jloader.DataLoader().preprocess_text(raw)


def test_save_processed_data_equals_pandas(tmp_path):
    records = tloader.synthetic_persian_qa(30, seed=2)
    records[3]["extra"] = 'with "quotes", and\nnewline'
    got = tloader.DataLoader().save_processed_data(
        records, "train.csv", str(tmp_path / "port"))
    want = jloader.DataLoader().save_processed_data(
        records, "train.csv", str(tmp_path / "jax"))
    assert open(got, "rb").read() == open(want, "rb").read()
