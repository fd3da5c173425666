"""The stage-1 term of the two-pass proof's bound (`stage1_rel_error`, in
`_twopass_rel_bound`), held to a model of the tensor cores' f32
accumulation, on the CPU.

The card's stage 1 (`csrc/sparse_stage1.cu`) sums a score's exact bf16
products with mma.sync.m16n8k16, 16 union terms a k-step. The model, as
`_twopass_rel_bound`'s docstring states it: a k-step adds its products to
the running sum c in groups of g (4, 8 or 16) products; a group's addends
(its products and c) are aligned to the largest exponent among them and cut
to 24 significant bits below it, added exactly, and written as an f32,
truncated (or rounded to nearest). Here, on nonnegative adversarial inputs
(one large term and many small ones, values spread over 2^+-10, and small
products placed just under a group's cut), at the flat and the hashed
union's sizes and orders:

* the model's score lies within stage1_rel_error(U, T) of the exact sum of
  the products (math.fsum), and the inputs do make it lose;
* the port's plain stage 1 (`sparse_topk_union(..., stage1=True)` and the
  hashed entry, an f32 chain) lies within the same term of the exact sum;
* the term enters `_twopass_rel_bound` and stays under 2^-12 at the served
  T (16);
* `lex_ab.py --compare` holds two runs' stage-1 lists to each other within
  twice the term;
* each of `lex_ab.py --variants`' edited copies of the kernel's source
  applies to it.
"""
import json
import math

import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import sparse_scores as tss
from persian_rag_tpu_torch.scripts import lex_ab


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().double(
        ).numpy()


def _f32_toward_zero(x: float) -> float:
    f = np.float32(x)
    if abs(float(f)) > abs(x):
        f = np.nextafter(f, np.float32(0))
    return float(f)


def tc_sum(prods, group: int, rounding: str) -> float:
    """The model's f32 sum of nonnegative exact products in union order:
    k-steps of 16, groups of `group`, each aligned to its largest exponent
    and cut to 24 bits below it, then written as an f32."""
    c = 0.0
    for s in range(0, len(prods), 16):
        step = prods[s:s + 16]
        for g0 in range(0, len(step), group):
            addends = [c] + [float(p) for p in step[g0:g0 + group]]
            top = max(addends)
            if top == 0.0:
                continue
            ulp = 2.0 ** (math.frexp(top)[1] - 1 - 23)
            total = math.fsum(math.floor(a / ulp) * ulp for a in addends)
            c = (_f32_toward_zero(total) if rounding == "rz"
                 else float(np.float32(total)))
    return c


def _union_order(ids, s_n):
    return sorted(ids, key=lambda tid: (tid % s_n, tid))


def _adversarial(rng, u, t, s_n):
    """A union of u term ids, one query of t of them (one large weight,
    t - 1 small ones) and a document holding all t: its values spread over
    2^+-10, except that every fourth small product is set just under the
    cut of a group led by the large one. Returns the union order of the
    ids and the exact bf16-rounded (weight, value) of each union term (0
    where the query lacks it)."""
    union = rng.choice(50_000, u, replace=False)
    mine = rng.choice(union, t, replace=False)
    w = _bf16(np.concatenate([[2.0 ** 10 * rng.uniform(1, 2)],
                              2.0 ** rng.uniform(-10, -2, t - 1)]))
    v = _bf16(2.0 ** rng.uniform(-10, 10, t))
    big = w[0] * v[0]
    for j in range(1, t, 4):  # just under 2^-23 of the large product
        v[j] = _bf16(big * 2.0 ** -23 * 0.99 / w[j])
    at = {int(tid): (w[j], v[j]) for j, tid in enumerate(mine)}
    order = _union_order([int(x) for x in union], s_n)
    return order, at


CASES = [(423, 10, 1), (1243, 16, 1), (1243, 16, 8), (640, 48, 8),
         (2048, 64, 1)]


@pytest.mark.parametrize("u, t, s_n", CASES)
@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("rounding", ["rz", "rn"])
def test_model_within_stage1_term(u, t, s_n, group, rounding):
    rng = np.random.default_rng(u + t + s_n + group)
    bound = tss.stage1_rel_error(u, t)
    worst = 0.0
    for _ in range(6):
        order, at = _adversarial(rng, u, t, s_n)
        prods = [at[tid][0] * at[tid][1] if tid in at else 0.0
                 for tid in order]
        exact = math.fsum(prods)
        err = abs(tc_sum(prods, group, rounding) - exact) / exact
        worst = max(worst, err)
        assert err <= bound, (err, bound)
    if rounding == "rz":
        assert worst > 2.0 ** -24  # the inputs do make the model lose


@pytest.mark.parametrize("s_n", [1, 8])
def test_plain_stage1_within_stage1_term(s_n):
    """The port's plain stage 1 on a corpus of adversarial documents: each
    listed score within stage1_rel_error(U, T) of math.fsum of its exact
    products."""
    rng = np.random.default_rng(3 + s_n)
    u, t, n_docs = 300, 24, 40
    union = rng.choice(5_000, u, replace=False).astype(np.int32)
    qids = np.full((4, t), -1, np.int32)
    qvals = np.zeros((4, t), np.float32)
    for b in range(4):
        mine = rng.choice(union, t, replace=False)
        qids[b] = mine
        qvals[b] = np.concatenate([[2.0 ** 10], 2.0 ** rng.uniform(-10, -2,
                                                                  t - 1)])
    ids = np.full((n_docs, 2 * t), -1, np.int32)
    vals = np.zeros((n_docs, 2 * t), np.float32)
    for d in range(n_docs):
        held = rng.choice(union, 2 * t - 4, replace=False)
        ids[d, :len(held)] = held
        vals[d, :len(held)] = 2.0 ** rng.uniform(-10, 10, len(held))
    if s_n == 1:
        s, i = tss.sparse_topk_union(torch.from_numpy(ids),
                                     torch.from_numpy(vals),
                                     torch.from_numpy(qids),
                                     torch.from_numpy(qvals), 10, stage1=True)
    else:
        ids3, vals3 = tss.hash_segments(ids, vals, s_n)
        s, i = tss.sparse_topk_union_hashed(
            torch.from_numpy(ids3), torch.from_numpy(vals3),
            torch.from_numpy(qids), torch.from_numpy(qvals), 10, stage1=True)
    bound = tss.stage1_rel_error(len(np.unique(qids)), t)
    w16 = _bf16(qvals)
    v16 = _bf16(vals)
    for b in range(4):
        wq = dict(zip(qids[b].tolist(), w16[b]))
        for score, doc in zip(s[b].tolist(), i[b].tolist()):
            exact = math.fsum(wq[tid] * v16[doc, j]
                              for j, tid in enumerate(ids[doc].tolist())
                              if tid in wq)
            assert abs(score - exact) <= bound * exact


@pytest.mark.parametrize("u, t", [(1243, 10), (423, 16), (5, 64)])
def test_term_enters_the_proof_bound(u, t):
    l_slots = 256
    term = tss.stage1_rel_error(u, t)
    assert term == min(t, u) * tss.TC_STEP_REL
    delta = 2.0 * 2.0 ** -9 + term + (l_slots + t) * 2.0 ** -24
    assert tss._twopass_rel_bound(u, t, l_slots) == pytest.approx(
        delta / (1.0 - delta) + 2.0 ** -16, rel=1e-12)
    if t <= 16:
        assert term < 2.0 ** -12


def test_lex_ab_holds_stage1_lists_to_the_term(tmp_path, capsys):
    """`lex_ab.py --compare` holds two runs' stage-1 lists to each other
    within twice stage1_rel_error (the bits differ between the walk's chain
    and the tensor cores by design) and counts the ids that differ past a
    near-tie."""
    s = np.sort(np.random.default_rng(0).uniform(1, 5, (3, 32)))[:, ::-1]
    ids = np.arange(96).reshape(3, 32)
    moved = ids.copy()
    moved[0, [3, 4]] = moved[0, [4, 3]]
    case = {"U": 400, "T": 16}
    a = {"sparse_topk 64": "x", "stage1": {
        "sparse_topk_union_stage1 C16 512": {"s": s.tolist(),
                                             "i": ids.tolist(), **case}}}
    b = {"sparse_topk 64": "x", "stage1": {
        "sparse_topk_union_stage1 C16 512": {
            "s": (s * (1 + 2.0 ** -20)).tolist(), "i": moved.tolist(),
            **case}}}
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    assert lex_ab.main(["--compare", str(pa), str(pb)]) == 0
    lines = [json.loads(line.split(" ", 1)[1])
             for line in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"kernel": "sparse_topk", "outputs": 1,
                        "bit_equal": 1}
    bound = lines[1]
    assert bound["case"] == "sparse_topk_union_stage1 C16 512"
    assert bound["scores_within"] is True
    assert bound["rel"] == 2 * tss.stage1_rel_error(400, 16)
    assert bound["ids_differ"] == 2
    # the swapped pair's scores lie far apart: past any near-tie
    assert bound["ids_differ_past_near_ties"] == 2


@pytest.mark.parametrize("name", sorted(lex_ab.STAGE1_VARIANTS))
def test_lex_ab_variants_edit_the_kernel_source(name):
    """Each of `lex_ab.py --variants`' copies of csrc/sparse_stage1.cu
    finds every text it replaces exactly once in the kernel's source, and
    changes it; an unknown variant name is refused."""
    from persian_rag_tpu_torch.ops import _build

    src = (_build.CSRC / "sparse_stage1.cu").read_text()
    out = lex_ab.variant_source(src, name)
    assert out != src
    for old, new in lex_ab.STAGE1_VARIANTS[name]:
        assert out.count(new) == 1
    with pytest.raises(SystemExit):
        lex_ab.main(["--variants", "no-such-variant"])
