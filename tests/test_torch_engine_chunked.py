"""The port's engine against a live JAX run of the legacy trace with the
chunked-prefill executor and with a sliding near window (the window slides
and blocks below it stay in the session until retirement). Same exact /
tie-margin rules as tests/test_torch_engine.py, whose harness this reuses.
"""
import pytest

pytest.importorskip("torch")

from test_torch_engine import LENS, assert_parity, run_pair  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=8),
    dict(near_window=16),
    dict(near_window=16, prefill_chunk=8),
    dict(prefill_chunk=8, kernel_skip_extent=False),
], ids=["chunk8", "window16", "window16-chunk8", "chunk8-noskip"])
def test_legacy_trace_variant_matches_live_reference(kw):
    jeng, teng = run_pair(mode="paged_merge", **kw)
    exact = assert_parity(jeng, teng)
    assert exact >= len(LENS) - 2, f"only {exact} of {len(LENS)} streams exact"
    a = teng.audit()
    if kw.get("prefill_chunk"):
        assert a["prefill_chunks_run"] > 0
    if kw.get("near_window"):
        assert teng.W == 16 and teng.NB == 3
