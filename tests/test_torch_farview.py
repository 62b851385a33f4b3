"""The port's far view (``mode="full"``) against the JAX package.

* ``core/farview.py``: the port's copy of the utility policy equals the
  reference's on the same utility sequences (exact: numpy on both sides).
* ``models``: one full-mode decode step — logits, the far utility and the
  post-step far pools — against ``repro.models.registry.decode_step`` with
  converted weights. The summaries are means of the same pre-write pool
  rows on both sides: within one bf16 ulp; entries the step does not write
  are bitwise equal. Logits within ``LOGIT_ULPS`` bf16 ulps of each row's
  scale (max |logit|): the two frameworks take f32 sums in different
  orders, a bf16 rounding can land one ulp apart, and such roundings carry
  through the layers (the same rows without the far view differ as much).
  far_util within ``UTIL_ATOL``: each layer's queries pass through bf16
  projections that may round one ulp apart.
* ``core/engine.py``: ``KVRMEngine(mode="full")`` against a LIVE run of the
  JAX engine (reduced qwen2.5-32b, batch 4, max_seq 128, near_window 32,
  block_tokens 8, sv_chunk 16, pipeline_depth 0, greedy budget EOS). Held
  exactly: ``steps_run``, frames, ``pager.stats`` (``trim_ops`` included),
  the transport stats, the shared audit keys, ``fv.n_chunks`` and the far
  table and validity the policy selects for every slot at every step. With
  ``farview_cap`` 4 (below max_chunks 7) a far-table difference counts as
  explained only where the reference's EMA scores at the top-cap boundary
  lie within ``EMA_TIE``; that slot's request is then compared only up to
  the difference. Token streams are held under the tie-margin rule of
  tests/test_torch_engine.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these runs are small, and xdist workers running the
# reference suite beside them share the cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core import descriptor as jdesc  # noqa: E402
from repro.core.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.core.engine import KVRMEngine as JEngine  # noqa: E402
from repro.core.farview import FarViewPolicy as JFarViewPolicy  # noqa: E402
from repro.core.scheduler import Request as JRequest  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import descriptor as tdesc  # noqa: E402
from repro_torch.core.engine import EngineConfig, KVRMEngine  # noqa: E402
from repro_torch.core.farview import FarViewPolicy  # noqa: E402
from repro_torch.core.scheduler import Request  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

LOGIT_ULPS = 4
UTIL_ATOL = 2e-2
TIE_MARGIN = 5e-2
EMA_TIE = 1e-3
FULL = dict(mode="full", batch=4, max_seq=128, near_window=32, block_tokens=8,
            sv_chunk=16, pipeline_depth=0)
# (prompt, generation) lengths: windows slide past several 16-token chunks,
# three requests complete 5 chunks (more than cap 4), slots are reused
LENS = [(100, 20), (60, 12), (20, 8), (90, 28), (116, 10), (40, 16),
        (10, 6), (70, 20)]
SHARED_AUDIT = ("mode", "steps", "prefill_chunk", "prefill_chunks_run",
                "single_commit_per_step", "frames_committed",
                "dma_groups_per_step", "avg_dma_bytes",
                "unmerged_groups_per_step", "train_overflows",
                "reserved_kv_bytes", "active_kv_bytes", "peak_reserved_kv",
                "peak_active_kv", "kernel_skip_extent", "kernel_blocks_total",
                "kernel_blocks_skipped", "greedy", "admit_blocked_no_slot",
                "continuous_batching", "continuous_admits",
                "slot_idle_steps_saved", "kv_dtype")

_WEIGHTS = {}


def weights():
    if not _WEIGHTS:
        jcfg = jget_reduced("qwen2.5-32b")
        jparams = jreg.init_params(jax.random.PRNGKey(11), jcfg)
        _WEIGHTS["jax"] = (jcfg, jparams)
        _WEIGHTS["torch"] = (get_reduced("qwen2.5-32b"),
                             params_from_reference(
                                 jax.tree.map(np.asarray, jparams)))
    return _WEIGHTS


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16_ulp(mag):
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                     - 7), 0.0)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [3, 8])
def test_policy_matches_reference_on_the_same_utilities(cap):
    B, MAXC = 4, 6
    rng = np.random.default_rng(cap)
    pols = [P(B, MAXC, cap, 16, 8) for P in (JFarViewPolicy, FarViewPolicy)]
    for step in range(60):
        for row in range(B):
            if rng.random() < 0.05:
                for p in pols:
                    p.reset_slot(row)
            if rng.random() < 0.3:
                assert len({p.on_chunk_summarized(row) for p in pols}) == 1
        tables = [np.stack([p.select(r)[0] for r in range(B)]) for p in pols]
        valids = [np.stack([p.select(r)[1] for r in range(B)]) for p in pols]
        np.testing.assert_array_equal(*tables)
        np.testing.assert_array_equal(*valids)
        util = rng.random((B, cap)).astype(np.float32) * valids[0]
        if step % 7 == 0:                               # exact ties too
            util[:] = 0.5
        for p in pols:
            p.observe_utility(util, tables[0])
        np.testing.assert_array_equal(pols[0].ema, pols[1].ema)
        np.testing.assert_array_equal(pols[0].n_chunks, pols[1].n_chunks)
    assert pols[1].n_chunks.max() == MAXC                  # recycling ran


# ---------------------------------------------------------------------------
# model: one full-mode decode step
# ---------------------------------------------------------------------------

B, BT, NB, CAP, CB, MAXC = 4, 8, 3, 3, 2, 4
W = (NB - 1) * BT
P = 1 + B * (NB + 2) + CB


def _full_mode_fields(seed):
    """Slot 0 completed a chunk (blocks c0, c1) that slot 2 partly reuses:
    slot 2's write block is c1 (the host TRIMmed c0, c1 and a later slot
    RESERVED c1 in the same step). Slot 1 has nothing to summarize and an
    all-invalid far table; slot 3 is retired."""
    rng = np.random.default_rng(seed)
    t = np.array([40, 5, 20, 11], np.int32)
    act = np.array([1, 1, 1, 0], np.int32)
    wb = ((np.maximum(0, t + 1 - W) // BT) * BT).astype(np.int32)
    blocks = rng.permutation(np.arange(1, P))[:B * NB + CB]
    chunk = blocks[B * NB:]
    blocks = blocks[:B * NB].reshape(B, NB)
    blocks[2, (t[2] - wb[2]) // BT] = chunk[1]
    wblk = blocks[np.arange(B), (t - wb) // BT]
    return dict(
        block_table=blocks.astype(np.int32), window_base=wb, seq_lens=t,
        slot_active=act, write_block=wblk.astype(np.int32),
        write_offset=(t % BT).astype(np.int32),
        far_table=np.array([[0, 2, 1], [0, 0, 0], [3, 1, 0], [0, 0, 0]],
                           np.int32),
        far_valid=np.array([[1, 1, 1], [0, 0, 0], [1, 0, 1], [0, 0, 0]],
                           np.int32),
        far_chunk_blocks=np.array([chunk, [0, 0], chunk[::-1], [0, 0]],
                                  np.int32),
        far_chunk_tokens=np.array([16, 0, 12, 0], np.int32),
        far_do_summarize=np.array([1, 0, 1, 0], np.int32),
        far_write_idx=np.array([2, 0, 3, 0], np.int32))


def _descriptors(fields):
    MT = NB + 1
    D = jdesc.descriptor_flat_size(B, NB, CAP, MT, CB)
    assert D == tdesc.descriptor_flat_size(B, NB, CAP, MT, CB)
    jflat = np.zeros(D, np.int32)
    tflat = np.zeros(D, np.int32)
    jv = jdesc.flat_descriptor_views(jflat, B, NB, CAP, MT, CB)
    tv = tdesc.flat_descriptor_views(tflat, B, NB, CAP, MT, CB)
    for name, a in fields.items():
        getattr(jv, name)[...] = a
        getattr(tv, name)[...] = a
    np.testing.assert_array_equal(jflat, tflat)       # CAP > 1, CB > 1
    jd = jdesc.unflatten_descriptor(jnp.asarray(jflat), B, NB, CAP, MT, CB)
    td = tdesc.unflatten_descriptor(torch.from_numpy(tflat), B, NB, CAP, MT,
                                    CB)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jd, td


@pytest.mark.parametrize("skip", [True, False])
def test_full_mode_decode_step_matches_reference(skip):
    jcfg, jparams = weights()["jax"]
    tcfg, tparams = weights()["torch"]
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(
        near_window=W, farview_cap=CAP, sv_chunk=CB * BT, enable_farview=True,
        skip_extent=skip))
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(
        near_window=W, farview_cap=CAP, sv_chunk=CB * BT, enable_farview=True,
        skip_extent=skip))
    shapes = treg.decode_pool_shapes(tcfg, batch=B, num_blocks=P,
                                     block_tokens=BT, max_chunks=MAXC)
    jshapes = jreg.decode_pool_shapes(jcfg, batch=B, num_blocks=P,
                                      block_tokens=BT, max_chunks=MAXC)
    assert {k: s for k, (s, _) in shapes.items()} \
        == {k: tuple(s.shape) for k, s in jshapes.items()}
    rng = np.random.default_rng(4)
    host = {k: rng.standard_normal(s).astype(np.float32)
            for k, (s, _) in shapes.items()}
    jpools = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in host.items()}
    tpools = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in host.items()}
    fields = _full_mode_fields(5)
    jd, td = _descriptors(fields)
    tokens = np.array([7, 100, 255, 3], np.int32)
    jlog, jpools, jfu = jreg.decode_step(jparams, jcfg, jnp.asarray(tokens),
                                         jpools, jd)
    tlog, tpools, tfu = treg.decode_step(tparams, tcfg,
                                         torch.from_numpy(tokens), tpools, td)
    g, w = _f32(tlog), _f32(jlog)
    row_ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(w)).max(-1, keepdims=True))
    assert (np.abs(g - w) <= LOGIT_ULPS * row_ulp).all(), np.abs(g - w).max()
    assert tfu.shape == (B, CAP) and tfu.dtype == torch.float32
    np.testing.assert_allclose(_f32(tfu), _f32(jfu), atol=UTIL_ATOL, rtol=0)
    u = _f32(tfu)
    assert u[0].min() > 0 and not u[1].any() and not u[3].any()
    assert u[2, 0] > 0 and u[2, 1] == 0 and u[2, 2] > 0
    # far pools: only (slot 0, entry 2) and (slot 2, entry 3) are written
    written = np.zeros((B, MAXC), bool)
    written[0, 2] = written[2, 3] = True
    for k in ("far_k", "far_v"):
        g, w = _f32(tpools[k]), _f32(jpools[k])
        np.testing.assert_array_equal(g[:, ~written], w[:, ~written])
        np.testing.assert_array_equal(g[:, ~written], _f32(torch.from_numpy(
            host[k]).to(torch.bfloat16))[:, ~written])
        diff = np.abs(g[:, written] - w[:, written])
        mag = np.maximum(np.abs(g[:, written]), np.abs(w[:, written]))
        assert (diff <= _bf16_ulp(mag)).all(), diff.max()
    # the K/V pools: the step's write, and nothing else, changed them
    for k in ("k", "v"):
        g, w = _f32(tpools[k]), _f32(jpools[k])
        mask = np.ones((P, BT), bool)
        act = fields["slot_active"] > 0
        mask[fields["write_block"][act], fields["write_offset"][act]] = False
        np.testing.assert_array_equal(g[:, mask], w[:, mask])


# ---------------------------------------------------------------------------
# engine: a live JAX full-mode run
# ---------------------------------------------------------------------------

def _record(eng):
    """Wrap the engine's policy: log every selection (step, slot, rid,
    tokens generated so far, n_chunks, the EMA it selected from, the
    table and the validity) and every utility readback."""
    log = {"select": [], "util": []}
    fv = eng.fv
    select, observe = fv.select, fv.observe_utility

    def rec_select(row):
        tbl, val = select(row)
        req = eng.sched.request_at(row)
        log["select"].append(dict(
            step=eng.steps_run, row=row, rid=req.rid,
            n_gen=len(req.generated), n=int(fv.n_chunks[row]),
            ema=fv.ema[row].copy(), table=tbl.copy(), valid=val.copy()))
        return tbl, val

    def rec_observe(far_util, far_table):
        log["util"].append(np.array(far_util, np.float32))
        observe(far_util, far_table)

    fv.select, fv.observe_utility = rec_select, rec_observe
    return log


def _trace(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, size=p).astype(np.int32), g)
            for p, g in LENS]


def run_full_pair(**kw):
    jcfg, jparams = weights()["jax"]
    tcfg, tparams = weights()["torch"]
    ekw = {**FULL, **kw}
    jeng = JEngine(jcfg, jparams, JEngineConfig(debug_logits=True, **ekw))
    teng = KVRMEngine(tcfg, tparams, EngineConfig(**ekw), device="cpu")
    logs = _record(jeng), _record(teng)
    for rid, (p, g) in enumerate(_trace(jcfg.vocab_size)):
        jeng.submit(JRequest(rid=rid, prompt=p, gen_len=g))
        teng.submit(Request(rid=rid, prompt=p.copy(), gen_len=g))
    jeng.run(max_steps=1000)
    teng.run(max_steps=1000)
    return jeng, teng, logs


def assert_control_plane_equal(jeng, teng):
    assert teng.steps_run == jeng.steps_run
    assert teng.frames_committed == jeng.frames_committed
    assert teng.pager.stats == jeng.pager.stats
    assert teng.pager.stats["trim_ops"] > len(LENS)      # chunks were trimmed
    teng.pager.check_invariants()
    assert teng.pager.reserved_blocks() == 0
    assert dataclasses.asdict(teng.transport.stats) \
        == dataclasses.asdict(jeng.transport.stats)
    ja, ta = jeng.audit(), teng.audit()
    for k in SHARED_AUDIT:
        assert ta[k] == ja[k], (k, ta[k], ja[k])
    assert ta["decode_kernel_launches"] == ta["farview_kernel_launches"] == 0
    np.testing.assert_array_equal(teng.fv.n_chunks, jeng.fv.n_chunks)
    assert (teng.max_chunks, teng.cap) == (jeng.max_chunks, jeng.cap)


def assert_streams(jeng, teng, exempt_after=None):
    """Tie-margin rule per rid; ``exempt_after[rid] = i`` compares only the
    first i tokens of that rid."""
    exempt_after = exempt_after or {}
    jfin = {r.rid: r for r in jeng.sched.finished}
    tfin = {r.rid: r for r in teng.sched.finished}
    assert sorted(jfin) == sorted(tfin) == list(range(len(LENS)))
    exact = 0
    for rid, jr in jfin.items():
        got, want = list(tfin[rid].generated), list(map(int, jr.generated))
        assert len(got) == len(want) == jr.gen_len
        n = exempt_after.get(rid, len(got))
        got, want = got[:n], want[:n]
        if got == want:
            exact += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        top2 = np.sort(np.asarray(jr.logit_trace[i], np.float32))[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, (
            f"rid {rid}: token {i} differs ({got[i]} vs {want[i]}) where the "
            f"reference's top-2 margin is {top2[1] - top2[0]}")
    return exact


def test_full_mode_matches_live_reference_cap_covers_every_chunk():
    jeng, teng, (jlog, tlog) = run_full_pair(farview_cap=8)
    assert teng.max_chunks == 7 and teng.cap == 8
    assert_control_plane_equal(jeng, teng)
    assert len(tlog["select"]) == len(jlog["select"]) > 0
    for j, t in zip(jlog["select"], tlog["select"]):
        for k in ("step", "row", "rid", "n"):
            assert t[k] == j[k], (k, t, j)
        np.testing.assert_array_equal(t["table"], j["table"])
        np.testing.assert_array_equal(t["valid"], j["valid"])
    assert max(r["n"] for r in tlog["select"]) == 5
    assert len(tlog["util"]) == len(jlog["util"]) == teng.steps_run
    exact = assert_streams(jeng, teng)
    assert exact >= len(LENS) - 2, f"only {exact} of {len(LENS)} streams exact"
    # while every stream agrees, the utility readback agrees too
    if exact == len(LENS):
        for t, j in zip(tlog["util"], jlog["util"]):
            np.testing.assert_allclose(t, j, atol=UTIL_ATOL, rtol=0)
    assert sum(u.sum() for u in tlog["util"]) > 0


def test_full_mode_matches_live_reference_cap_below_max_chunks():
    jeng, teng, (jlog, tlog) = run_full_pair(farview_cap=4)
    assert teng.max_chunks == 7 and teng.cap == 4
    assert_control_plane_equal(jeng, teng)
    assert len(tlog["select"]) == len(jlog["select"]) > 0
    diverged = {}                                  # row -> rid, from the first
    exempt = {}
    for j, t in zip(jlog["select"], tlog["select"]):
        for k in ("step", "row", "rid", "n"):
            assert t[k] == j[k], (k, t, j)
        np.testing.assert_array_equal(t["valid"], j["valid"])
        if diverged.get(t["row"]) == t["rid"]:
            continue
        if np.array_equal(t["table"], j["table"]):
            continue
        n = j["n"]
        scores = np.sort(j["ema"][:n] + 1e-6 * np.arange(n))[::-1]
        gap = scores[teng.cap - 1] - scores[teng.cap]
        assert n > teng.cap and gap < EMA_TIE, (
            f"far table of rid {t['rid']} differs at step {t['step']} where "
            f"the reference's top-cap EMA gap is {gap}")
        diverged[t["row"]] = t["rid"]
        exempt[t["rid"]] = t["n_gen"]
    # the EMA chose among more chunks than the cap
    assert max(r["n"] for r in tlog["select"]) > teng.cap
    assert_streams(jeng, teng, exempt)


def test_full_mode_ignores_prefill_chunk():
    """Full mode turns the chunked prefill executor off: prompts ride the
    decode step, the same steps and frames as without it."""
    tcfg, tparams = weights()["torch"]
    runs = []
    for chunk in (0, 16):
        eng = KVRMEngine(tcfg, tparams, EngineConfig(
            **{**FULL, "farview_cap": 8, "prefill_chunk": chunk}),
            device="cpu")
        for rid, (p, g) in enumerate(_trace(tcfg.vocab_size)[:4]):
            eng.submit(Request(rid=rid, prompt=p, gen_len=g))
        eng.run(max_steps=1000)
        a = eng.audit()
        assert a["prefill_chunk"] == 0 and a["prefill_chunks_run"] == 0
        assert a["chunk_kernel_launches"] == 0
        runs.append((eng.steps_run, eng.frames_committed, eng.pager.stats,
                     [list(r.generated) for r in eng.sched.finished]))
    assert runs[0] == runs[1]
    assert runs[0][0] > sum(p + g for p, g in LENS[:4]) // 4


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(host_pool_blocks=8),
                                dict(kv_oversubscribe=1.5),
                                dict(prefix_cache=True)],
                         ids=["quant", "host_tier", "oversubscribe",
                              "prefix_cache"])
def test_full_mode_exclusions_raise_the_reference_error(kw):
    jcfg, jparams = weights()["jax"]
    tcfg, tparams = weights()["torch"]
    ekw = {**FULL, **kw}
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jparams, JEngineConfig(**ekw))
    with pytest.raises(ValueError) as terr:
        KVRMEngine(tcfg, tparams, EngineConfig(**ekw), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_launcher_serves_full_mode_on_the_cpu():
    """``serve --mode full`` through ``serving.factory.build``: every
    request finishes, chunks are summarized and trimmed, nothing leaks."""
    from repro_torch.launch import serve
    out, engines = serve.main(
        ["--device", "cpu", "--mode", "full", "--requests", "6",
         "--max-seq", "128", "--near-window", "32", "--batch", "4",
         "--block-tokens", "8", "--prompt-len", "60:100",
         "--gen-len", "8:16"], return_engines=True)
    eng = engines[0]
    assert out["finished"] == 6 and out["audit"]["mode"] == "full"
    assert eng.fv is not None and eng.cap == 16 and eng.max_chunks == 3
    assert eng.pager.stats["trim_ops"] > 6                # summaries trimmed
    assert eng.pager.reserved_blocks() == 0
