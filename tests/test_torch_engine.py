"""The port's engine against a LIVE run of the JAX engine on the legacy trace
of tests/test_legacy_regression.py (reduced qwen2.5-32b, batch 4,
max_seq 64, block_tokens 8, pipeline_depth 0, greedy budget EOS).

Held exactly: ``steps_run``, ``frames_committed``, ``pager.stats`` and the
transport stats — in legacy greedy mode retirement depends on lengths only,
so the control plane must replay the reference step for step. Held under
the tie-margin rule: each rid's token stream equals the reference's, or
the first differing token falls where the reference's top-2 logit margin
is below ``TIE_MARGIN`` (the two frameworks round bf16 at different
places; an exact tie in bf16 can go either way). The reference's committed
digest is never used (it has drifted under the installed jax).

Weights are the reference's, carried over by ``params_from_reference``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these runs are small, and xdist workers running the
# reference suite beside them share the cores
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.core.engine import KVRMEngine as JEngine  # noqa: E402
from repro.core.scheduler import Request as JRequest  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.engine import EngineConfig, KVRMEngine  # noqa: E402
from repro_torch.core.scheduler import Request  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

LENS = [(5, 6), (17, 4), (3, 8), (33, 5), (9, 7), (21, 3),
        (4, 5), (6, 5), (8, 5)]
TIE_MARGIN = 5e-2
BASE = dict(batch=4, max_seq=64, block_tokens=8, pipeline_depth=0)
# audit keys the port shares with the reference that are not wall-clock
SHARED_AUDIT = ("mode", "steps", "prefill_chunk", "prefill_chunks_run",
                "single_commit_per_step", "frames_committed",
                "dma_groups_per_step", "avg_dma_bytes",
                "unmerged_groups_per_step", "train_overflows",
                "reserved_kv_bytes", "active_kv_bytes", "peak_reserved_kv",
                "peak_active_kv", "kernel_skip_extent", "kernel_blocks_total",
                "kernel_blocks_skipped", "greedy",
                "admit_blocked_no_slot", "admit_blocked_kv_watermark",
                "continuous_batching", "continuous_admits",
                "slot_idle_steps_saved", "admit_blocked_round_barrier",
                "cow_copies", "cow_groups", "cow_bytes", "kv_dtype")

_WEIGHTS = {}


def weights():
    if not _WEIGHTS:
        jcfg = jget_reduced("qwen2.5-32b")
        jparams = jreg.init_params(jax.random.PRNGKey(7), jcfg)
        _WEIGHTS["jax"] = (jcfg, jparams)
        _WEIGHTS["torch"] = (get_reduced("qwen2.5-32b"),
                             params_from_reference(
                                 jax.tree.map(np.asarray, jparams)))
    return _WEIGHTS


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p, _ in LENS]


def _legacy_trace(vocab):
    """[(prompt, gen_len, request kwargs)] of the legacy trace."""
    return [(p, g, {}) for (_, g), p in zip(LENS, _prompts(vocab))]


def run_pair(trace=_legacy_trace, **kw):
    """Run a trace through both engines with the same EngineConfig fields;
    returns (jax engine, port engine)."""
    w = weights()
    jcfg, jparams = w["jax"]
    tcfg, tparams = w["torch"]
    ekw = {**BASE, **kw}
    jeng = JEngine(jcfg, jparams, JEngineConfig(debug_logits=True, **ekw))
    teng = KVRMEngine(tcfg, tparams, EngineConfig(**ekw), device="cpu")
    for rid, (p, g, rkw) in enumerate(trace(jcfg.vocab_size)):
        jeng.submit(JRequest(rid=rid, prompt=p, gen_len=g, **rkw))
        teng.submit(Request(rid=rid, prompt=p.copy(), gen_len=g, **rkw))
    jeng.run(max_steps=500)
    teng.run(max_steps=500)
    return jeng, teng


def assert_parity(jeng, teng):
    assert teng.steps_run == jeng.steps_run
    assert teng.frames_committed == jeng.frames_committed
    if jeng.pager is not None:
        assert teng.pager.stats == jeng.pager.stats
        teng.pager.check_invariants()
        assert teng.pager.reserved_blocks() == 0
    assert dataclasses.asdict(teng.transport.stats) \
        == dataclasses.asdict(jeng.transport.stats)
    ja, ta = jeng.audit(), teng.audit()
    for k in SHARED_AUDIT:
        assert ta[k] == ja[k], (k, ta[k], ja[k])
    # no kernel exists on the CPU: the plain versions ran
    assert ta["decode_kernel_launches"] == 0
    assert ta["chunk_kernel_launches"] == 0

    jfin = {r.rid: r for r in jeng.sched.finished}
    tfin = {r.rid: r for r in teng.sched.finished}
    assert sorted(jfin) == sorted(tfin) == list(range(len(jeng.sched.requests)))
    exact = 0
    for rid, jr in jfin.items():
        got, want = list(tfin[rid].generated), list(map(int, jr.generated))
        assert len(got) == len(want) == jr.gen_len
        if got == want:
            exact += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        top2 = np.sort(np.asarray(jr.logit_trace[i], np.float32))[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, (
            f"rid {rid}: token {i} differs ({got[i]} vs {want[i]}) where the "
            f"reference's top-2 margin is {top2[1] - top2[0]}")
    return exact


@pytest.mark.parametrize("mode", ["paged_merge", "paged", "arena"])
def test_legacy_trace_matches_live_reference(mode):
    jeng, teng = run_pair(mode=mode)
    exact = assert_parity(jeng, teng)
    assert exact >= len(LENS) - 2, f"only {exact} of {len(LENS)} streams exact"


def test_round_based_admission_matches_live_reference():
    jeng, teng = run_pair(mode="paged_merge", continuous_batching=False)
    assert_parity(jeng, teng)
    assert teng.audit()["admit_blocked_round_barrier"] > 0


def _prefix_hint_trace(vocab):
    """A long-lived source (rid 0) and later requests that name it with the
    legacy ``prefix_of`` hint: 12 shared tokens (one full block + an
    unaligned tail that needs a COW copy) and 16 (two full blocks)."""
    rng = np.random.default_rng(2)
    tok = lambda n: rng.integers(0, vocab, size=n).astype(np.int32)
    src = tok(40)
    trace = [(src, 8, {})] + [(tok(16), 4, {}) for _ in range(3)]
    for share in (12, 16, 12, 16):
        trace.append((np.concatenate([src[:share], tok(6)]), 4,
                      dict(prefix_of=0, prefix_len=share)))
    return trace


def test_prefix_hint_alias_and_cow_match_live_reference():
    jeng, teng = run_pair(trace=_prefix_hint_trace, mode="paged_merge")
    assert_parity(jeng, teng)
    a = teng.audit()
    assert teng.pager.stats["alias_ops"] > 0 and a["cow_copies"] > 0


def test_unported_features_raise():
    tcfg, tparams = weights()["torch"]
    for kw, item in ((dict(pipeline_depth=1), "6b"), (dict(greedy=False), "6h"),
                     (dict(kv_dtype="int8"), "6f"),
                     (dict(host_pool_blocks=8), "6d"),
                     (dict(prefix_cache=True), "6e"),
                     (dict(mesh=object()), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            KVRMEngine(tcfg, tparams, EngineConfig(**{**BASE, **kw}),
                       device="cpu")
