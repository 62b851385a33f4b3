"""The far view's bf16 decode on the split-KV kernel, as far as the CPU
reaches it.

With the far view (``mode="full"``), bf16 q runs ``paged_decode_split_kernel``
unchanged and then the combine's far form
(``paged_decode_combine_far_kernel`` in ``csrc/paged_decode.cu``), which
scores the CAP far entries, folds them first, then the splits and the
current token, and writes each far entry's probability summed over a kv
head's query heads. The kernels run only on the card, where
``chip_smoke.py --phases build,kernels`` holds them against the plain
version. Here, with torch and the port only, their plain model
(``split_partials`` then ``combine_far_plain``):

* against the plain version ``ref.paged_decode_attention_ref`` with the far
  view, at chip_smoke's parity shapes and at qwen2.5-32b's head layout:
  out within 1e-5 in f32 (summation order) and 2e-2 in bf16 (chip_smoke's
  ``TOL``: the plain version rounds p to bf16), far_util within 1e-4
  (chip_smoke's ``UTIL_TOL``);
* a far view whose entries are all masked gives ``combine_plain``'s output,
  bitwise, and a zero far_util;
* a retired slot gives a zero output and a zero far_util;
* the split count comes from the shapes alone, the far view's among them;
* the wrapper's rule: n_rep above ``FAR_COMBINE_MAX_REP`` with the far view
  is refused.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402

H100_SMS = 132
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
UTIL_TOL = 1e-4
# (B, KV, n_rep, hd, BT, NB, MAXC, CAP, n_chunks per slot): chip_smoke's
# parity shapes (far cap 4 below 5 and 7 summaries) and qwen2.5-32b's head
# layout at a short window with serve_full's far view (max_chunks 13, cap
# 16, mixed fill)
SHAPES = {
    "parity": (4, 2, 2, 16, 8, 3, 7, 4, [0, 5, 2, 7]),
    "qwen": (4, 2, 5, 32, 8, 9, 13, 16, [3, 13, 16, 7]),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (xdist workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, dtype, *, B, KV, n_rep, hd, BT, NB, MAXC, CAP, n_chunks):
    """One full-mode decode step: slot 0 at seq_lens 0, the last slot
    retired, window bases from the engine's rule, distinct physical blocks
    per slot; each slot's far table selects its summaries as the host
    policy does (all of them up to CAP, else CAP of them)."""
    rng = np.random.default_rng(seed)
    H, W, P = KV * n_rep, (NB - 1) * BT, B * NB + 1
    t = rng.integers(1, 3 * W, size=B)
    t[0] = 0
    wb = (np.maximum(0, t + 1 - W) // BT) * BT
    act = np.ones(B, np.int32)
    act[-1] = 0
    tbl = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB)
    table = np.zeros((B, CAP), np.int32)
    valid = np.zeros((B, CAP), np.int32)
    for b, n in enumerate(n_chunks):
        n = min(n, MAXC)
        sel = (np.arange(n) if n <= CAP
               else np.sort(rng.permutation(n)[:CAP]))
        table[b, :len(sel)] = sel
        valid[b, :len(sel)] = 1
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    args = [f(B, H, hd), f(P, BT, KV, hd), f(P, BT, KV, hd),
            torch.from_numpy(tbl.astype(np.int32)),
            torch.from_numpy(wb.astype(np.int32)),
            torch.from_numpy(t.astype(np.int32)), torch.from_numpy(act)]
    kw = dict(near_window=W, cur_k=f(B, KV, hd), cur_v=f(B, KV, hd))
    far = dict(far_k=f(B, MAXC, KV, hd), far_v=f(B, MAXC, KV, hd),
               far_table=torch.from_numpy(table),
               far_valid=torch.from_numpy(valid))
    return args, kw, far


def _model(args, kw, far, *, splits):
    work = pa.split_partials(*args, near_window=kw["near_window"],
                             splits=splits)
    return pa.combine_far_plain(work, args[0], kw["cur_k"], kw["cur_v"],
                                args[6], splits=splits, **far), work


def _splits(name):
    B, KV, n_rep, hd, BT, NB = SHAPES[name][:6]
    return pa.split_count(B, KV, n_rep, NB, BT, hd, H100_SMS)[0]


def _shape(name):
    return dict(zip(("B", "KV", "n_rep", "hd", "BT", "NB", "MAXC", "CAP",
                     "n_chunks"), SHAPES[name]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_far_model_matches_plain(name, dtype):
    args, kw, far = _case(3, dtype, **_shape(name))
    want, u_want = pa.plain(*args, skip_extent=True, **kw, **far)
    NB = SHAPES[name][5]
    for splits in sorted({1, _splits(name), NB}):
        (got, util), _ = _model(args, kw, far, splits=splits)
        assert got.dtype == dtype and util.dtype == torch.float32
        assert util.shape == (args[0].shape[0], kw["cur_k"].shape[1],
                              far["far_table"].shape[1])
        err = (got.float() - want.float()).abs().max().item()
        assert torch.allclose(got.float(), want.float(), **TOL[dtype]), \
            (name, dtype, splits, err)
        uerr = (util.sum(dim=1) - u_want).abs().max().item()
        assert uerr <= UTIL_TOL, (name, dtype, splits, uerr)
    assert u_want.sum() > 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_all_masked_far_view_is_the_combine_bitwise(name):
    args, kw, far = _case(5, torch.bfloat16, **_shape(name))
    far = dict(far, far_valid=torch.zeros_like(far["far_valid"]))
    S = _splits(name)
    (got, util), work = _model(args, kw, far, splits=S)
    want = pa.combine_plain(work, args[0], kw["cur_k"], kw["cur_v"], args[6],
                            splits=S)
    assert torch.equal(got, want)
    assert not util.any()


@pytest.mark.parametrize("name", list(SHAPES))
def test_retired_slot_is_zero(name):
    args, kw, far = _case(7, torch.bfloat16, **_shape(name))
    (got, util), _ = _model(args, kw, far, splits=_splits(name))
    assert not args[6][-1] and not got[-1].any() and not util[-1].any()
    assert got[:-1].any() and util[:-1].any()


def test_split_count_is_the_far_views_too():
    # the shapes and the SM count, nothing of the far view or the lengths
    assert set(inspect.signature(pa.split_count).parameters) == {
        "B", "KV", "n_rep", "NB", "BT", "hd", "n_sm"}
    assert not any("far" in p for p in
                   inspect.signature(pa.split_partials).parameters)
    # serve_full: batch 8, qwen2.5-32b's heads, near window 256 (NB 17)
    assert pa.split_count(8, 8, 5, 17, 16, 128, H100_SMS) == (5, 4)


def test_far_split_rejects_wide_groups():
    q = torch.zeros(1, 33, 16, dtype=torch.bfloat16)
    pool = torch.zeros(2, 8, 1, 16, dtype=torch.bfloat16)
    far_k = torch.zeros(1, 3, 1, 16, dtype=torch.bfloat16)
    pa._check_split(q, pool, pool)                    # no far view: taken
    with pytest.raises(ValueError, match="n_rep <= 32"):
        pa._check_split(q, pool, pool, far_k, far_k)
    pa._check_split(q[:, :32], pool, pool, far_k, far_k)
