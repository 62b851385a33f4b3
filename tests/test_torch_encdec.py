"""The port's encoder-decoder family (reduced seamless-m4t-medium) against
the JAX package.

* ``models/common.py``: ``gelu`` and the gelu MLP bitwise equal to
  ``jax.nn.gelu`` / ``common.mlp_apply`` in bf16 (the same op sequence and
  roundings).
* ``models/encdec.py``: ``encode`` and ``cross_kv`` against
  ``repro.models.encdec`` at three encoder lengths; one decode step's
  logits and post-write pools against ``repro.models.registry.decode_step``
  with random cross pools and one slot whose enc_len is 0. The reference's
  encoder is compiled (``lax.scan``), where XLA may keep f32 between bf16
  ops; the port rounds each op to bf16. Encoder outputs and cross K/V are
  therefore held within ``DEEP_ULPS`` bf16 ulps of each token row's scale
  (max |x| over d_model, or over all heads of K or V); cross K/V computed
  from identical encoder outputs within one ulp. Logits within ``LOGIT_ULPS`` row-scale ulps; pool entries
  the step does not write are bitwise equal.
* ``models/registry.py`` and ``models/convert.py``: pool shapes,
  ``n_paged_layers`` and ``supports_chunked_prefill`` equal the reference's;
  every layer stack is unstacked.
* ``core/engine.py``: ``KVRMEngine`` in modes paged_merge / paged / arena
  at depth 0 (greedy budget EOS) against a LIVE run of the JAX engine on
  the same trace: requests with explicit ``enc_embeds`` of two lengths and
  requests on the rid-seeded default frames. Held exactly: ``steps_run``,
  frames, ``pager.stats``, the transport stats and the shared audit keys;
  token streams under the tie-margin rule of tests/test_torch_engine.py.
  The JAX engine runs at depth 0 with no host tier, the configuration
  ROADMAP queue 3 found deterministic on this jax (its async-dispatch
  flag is read once, when jax creates its CPU client, so a test module in
  a shared worker cannot switch it off for its own runs).
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
from repro.core.scheduler import Request as JRequest  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_config, get_reduced, with_depth  # noqa: E402
from repro_torch.core import descriptor as tdesc  # noqa: E402
from repro_torch.core.engine import EngineConfig, KVRMEngine  # noqa: E402
from repro_torch.core.scheduler import Request  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

from test_torch_engine import SHARED_AUDIT, TIE_MARGIN  # noqa: E402

ARCH = "seamless-m4t-medium"
DEEP_ULPS = 4
LOGIT_ULPS = 4
B, BT, NB = 4, 8, 3
W = (NB - 1) * BT
P = 1 + B * (NB + 2)
SE = 24                                  # cross pools' encoder capacity
ENGINE = dict(batch=4, max_seq=64, block_tokens=8, pipeline_depth=0)
# (prompt, generation, encoder frames; 0 = the engine's rid-seeded default)
TRACE = [(5, 6, 12), (17, 4, 0), (3, 8, 20), (9, 5, 12), (4, 7, 0),
         (6, 3, 20), (8, 5, 12)]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_reduced(ARCH)
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(near_window=W))
    tcfg = get_reduced(ARCH)
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(near_window=W))
    jparams = jreg.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16_ulp(mag):
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                     - 7), 0.0)


def _assert_row_ulps(got, want, n_ulps, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    mag = np.maximum(np.abs(got), np.abs(want)).max(axis=-1, keepdims=True)
    diff = np.abs(got - want)
    assert (diff <= n_ulps * _bf16_ulp(mag)).all(), \
        f"{what} beyond {n_ulps} row-scale bf16 ulps: max diff {diff.max()}"


# ---------------------------------------------------------------------------

def test_gelu_and_mlp_bitwise_equal_to_reference(models):
    jcfg, jparams, tcfg, tparams = models
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(
        np.float32) * 3
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    np.testing.assert_array_equal(_f32(tcm.gelu(tx)), _f32(jax.nn.gelu(jx)))
    np.testing.assert_allclose(_f32(tcm.gelu(tx.float())),
                               _f32(jax.nn.gelu(jx.astype(jnp.float32))),
                               atol=1e-6, rtol=1e-6)
    jl = jax.tree.map(lambda a: a[1], jparams["dec_layers"])
    tl = tparams["dec_layers"][1]
    np.testing.assert_array_equal(_f32(tcm.mlp_apply(tl["mlp"], tx, "gelu")),
                                  _f32(jcm.mlp_apply(jl["mlp"], jx, "gelu")))


def test_convert_unstacks_every_layer_stack(models):
    jcfg, jparams, tcfg, tparams = models
    assert set(tparams) == set(jparams)
    for stack in ("enc_layers", "dec_layers"):
        assert isinstance(tparams[stack], list)
        assert len(tparams[stack]) == 2
        np.testing.assert_array_equal(
            _f32(tparams[stack][1]["mlp"]["up"]["w"]),
            _f32(jparams[stack]["mlp"]["up"]["w"][1]))
    assert "cross_attn" in tparams["dec_layers"][0]
    ti = treg.init_params(tcfg, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, ti)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tparams))
    for a, b in zip(jax.tree.leaves(ti), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("s_enc", [8, 13, 40])
def test_encode_and_cross_kv_match_reference(models, s_enc):
    jcfg, jparams, tcfg, tparams = models
    e = np.random.default_rng(s_enc).standard_normal(
        (2, s_enc, 64)).astype(np.float32)
    jo = jed.encode(jparams, jcfg, jnp.asarray(e))
    to = ted.encode(tparams, tcfg, torch.from_numpy(e))
    assert to.shape == (2, s_enc, 64) and to.dtype == torch.bfloat16
    _assert_row_ulps(to, jo, DEEP_ULPS, "encoder output")
    jk, jv = jed.cross_kv(jparams, jcfg, jo)
    tk, tv = ted.cross_kv(tparams, tcfg, to)
    assert tk.shape == (2, 2, s_enc, 4, 16)
    # the scale of a token's whole K (V) row: every head's row is one
    # projection of the same encoder row, whose roundings it carries
    tok = lambda x: _f32(x).reshape(2, 2, s_enc, 64)
    _assert_row_ulps(tok(tk), tok(jk), DEEP_ULPS, "cross K")
    _assert_row_ulps(tok(tv), tok(jv), DEEP_ULPS, "cross V")
    # from the same encoder output: one projection, within one ulp
    sk, sv = ted.cross_kv(tparams, tcfg,
                          torch.from_numpy(_f32(jo)).to(torch.bfloat16))
    _assert_row_ulps(tok(sk), tok(jk), 1, "cross K (same input)")
    _assert_row_ulps(tok(sv), tok(jv), 1, "cross V (same input)")


def test_registry_matches_reference():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    kw = dict(batch=B, num_blocks=P, block_tokens=BT, enc_len=SE)
    jshapes = jreg.decode_pool_shapes(jcfg, **kw)
    tshapes = treg.decode_pool_shapes(tcfg, **kw)
    assert set(tshapes) == set(jshapes) == {"k", "v", "cross_k", "cross_v",
                                            "enc_len"}
    for name, (shape, dtype) in tshapes.items():
        assert shape == jshapes[name].shape, name
        assert str(dtype).split(".")[-1] == str(jshapes[name].dtype), name
    assert treg.n_paged_layers(tcfg) == jreg.n_paged_layers(jcfg) == 2
    full = get_config(ARCH)
    assert treg.n_paged_layers(full) == 12
    assert treg.n_paged_layers(with_depth(full, 3)) == 3
    assert with_depth(full, 3).enc_layers == 3
    assert treg.supports_chunked_prefill(tcfg) is False
    assert jreg.supports_chunked_prefill(jcfg) is False
    for arch in ("qwen2.5-32b",):
        assert treg.supports_chunked_prefill(get_reduced(arch)) == \
            jreg.supports_chunked_prefill(jget_reduced(arch)) is True
    assert treg.paged_payload_bytes_per_token(tcfg) == \
        jreg.paged_payload_bytes_per_token(jcfg)


def _decode_fields(seed):
    rng = np.random.default_rng(seed)
    t = np.array([0, 5, 20, 11], np.int32)
    act = np.array([1, 1, 1, 0], np.int32)
    wb = ((np.maximum(0, t + 1 - W) // BT) * BT).astype(np.int32)
    blocks = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB)
    wblk = blocks[np.arange(B), (t - wb) // BT]
    return dict(block_table=blocks.astype(np.int32), window_base=wb,
                seq_lens=t, slot_active=act, write_block=wblk.astype(np.int32),
                write_offset=(t % BT).astype(np.int32))


def _descriptors(fields):
    MT, CB, CAP = NB + 1, 1, 1
    D = tdesc.descriptor_flat_size(B, NB, CAP, MT, CB)
    jflat, tflat = np.zeros(D, np.int32), np.zeros(D, np.int32)
    jv = jdesc.flat_descriptor_views(jflat, B, NB, CAP, MT, CB)
    tv = tdesc.flat_descriptor_views(tflat, B, NB, CAP, MT, CB)
    for name, a in fields.items():
        getattr(jv, name)[...] = a
        getattr(tv, name)[...] = a
    return (jdesc.unflatten_descriptor(jnp.asarray(jflat), B, NB, CAP, MT, CB),
            tdesc.unflatten_descriptor(torch.from_numpy(tflat), B, NB, CAP,
                                       MT, CB))


def _pools(seed, cfg):
    """Random self-attention pools and cross pools; slot 1 has enc_len 0,
    and each slot's cross rows past its enc_len are zero (as the engine
    leaves them)."""
    rng = np.random.default_rng(seed)
    L, KV, hd = cfg.dec_layers, cfg.n_kv_heads, cfg.head_dim
    enc_len = np.array([SE, 0, 7, 13], np.int32)
    arrs = {k: rng.standard_normal((L, P, BT, KV, hd)).astype(np.float32)
            for k in ("k", "v")}
    live = (np.arange(SE)[None] < enc_len[:, None])[None, :, :, None, None]
    for k in ("cross_k", "cross_v"):
        arrs[k] = rng.standard_normal((L, B, SE, KV, hd)).astype(
            np.float32) * live
    jp = {k: jnp.asarray(a).astype(jnp.bfloat16) for k, a in arrs.items()}
    tp = {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in arrs.items()}
    jp["enc_len"], tp["enc_len"] = jnp.asarray(enc_len), torch.from_numpy(
        enc_len)
    return jp, tp


@pytest.mark.parametrize("skip", [True, False])
def test_decode_step_logits_and_pools(models, skip):
    jcfg, jparams, tcfg, tparams = models
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(near_window=W,
                                                       skip_extent=skip))
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(near_window=W,
                                                       skip_extent=skip))
    fields = _decode_fields(0)
    jd, td = _descriptors(fields)
    tokens = np.array([7, 100, 255, 3], np.int32)
    jpools, tpools = _pools(1, jcfg)
    cross_before = {k: tpools[k].clone() for k in ("cross_k", "cross_v",
                                                    "enc_len")}
    jlog, jpools, _ = jreg.decode_step(jparams, jcfg, jnp.asarray(tokens),
                                       jpools, jd)
    tlog, tpools, fu = treg.decode_step(tparams, tcfg,
                                        torch.from_numpy(tokens), tpools, td)
    assert fu is None
    assert tlog.shape == (B, 256) and tlog.dtype == torch.bfloat16
    assert np.isfinite(_f32(tlog)).all()
    _assert_row_ulps(tlog, jlog, LOGIT_ULPS, "logits")
    for k, before in cross_before.items():          # immutable
        assert torch.equal(tpools[k], before), k
    written = np.zeros((P, BT), bool)
    act = fields["slot_active"] > 0
    written[fields["write_block"][act], fields["write_offset"][act]] = True
    for k in ("k", "v"):
        got, want = _f32(tpools[k]), _f32(jpools[k])
        np.testing.assert_array_equal(got[:, ~written], want[:, ~written])
        _assert_row_ulps(got[:, written], want[:, written], DEEP_ULPS,
                         f"written {k} rows")


def test_cross_attention_with_no_encoder_rows_attends_nothing():
    """enc_len 0: every score masked, the safe softmax gives zero weights
    (no NaN), so the cross output is exactly zero."""
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(4)
    qx = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    ck = torch.from_numpy(rng.standard_normal((2, 6, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    out = ted._cross_attention(cfg, qx, ck, ck, torch.tensor([0, 6],
                                                             dtype=torch.int32))
    assert not out[0].float().abs().sum() and out[1].float().abs().sum() > 0


# ---------------------------------------------------------------------------
# the engine against a live JAX engine
# ---------------------------------------------------------------------------

def _trace(d_model):
    rng = np.random.default_rng(11)
    out = []
    for rid, (p, g, s) in enumerate(TRACE):
        prompt = rng.integers(0, 256, size=p).astype(np.int32)
        enc = (rng.standard_normal((1, s, d_model)).astype(np.float32)
               if s else None)
        out.append((rid, prompt, g, enc))
    return out


def _run_pair(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    ekw = {**ENGINE, **kw}
    jeng = JEngine(jcfg, jparams, JEngineConfig(debug_logits=True, **ekw))
    teng = KVRMEngine(tcfg, tparams, EngineConfig(**ekw), device="cpu")
    for rid, prompt, g, enc in _trace(jcfg.d_model):
        jr = JRequest(rid=rid, prompt=prompt, gen_len=g)
        tr = Request(rid=rid, prompt=prompt.copy(), gen_len=g)
        if enc is not None:
            jr.enc_embeds, tr.enc_embeds = enc, enc.copy()
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run(max_steps=500)
    teng.run(max_steps=500)
    return jeng, teng


@pytest.mark.parametrize("mode", ["paged_merge", "paged", "arena"])
def test_engine_matches_live_reference(models, mode):
    jeng, teng = _run_pair(models, mode=mode)
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
    assert ta["prefill_chunk"] == 0                   # prompts ride decode
    assert ta["encodes_run"] == len(TRACE)
    # no kernel exists on the CPU: the plain versions ran
    assert ta["prefill_kernel_launches"] == ta["decode_kernel_launches"] == 0
    # the last admissions' encoder lengths sit in the pools
    np.testing.assert_array_equal(teng.pools["enc_len"].numpy(),
                                  np.asarray(jeng.pools["enc_len"]))
    jfin = {r.rid: r for r in jeng.sched.finished}
    tfin = {r.rid: r for r in teng.sched.finished}
    assert sorted(jfin) == sorted(tfin) == list(range(len(TRACE)))
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
    assert exact >= len(TRACE) - 2, f"only {exact} of {len(TRACE)} exact"


def test_cross_pools_hold_the_admitted_encodings(models):
    """After one admission step the slot's cross rows equal ``cross_kv`` of
    its request's encoding, zeros past S_enc; enc_len is S_enc."""
    jcfg, jparams, tcfg, tparams = models
    tcfg = get_reduced(ARCH)
    eng = KVRMEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
    trace = _trace(tcfg.d_model)[:4]
    for rid, prompt, g, enc in trace:
        r = Request(rid=rid, prompt=prompt, gen_len=g)
        if enc is not None:
            r.enc_embeds = enc
        eng.submit(r)
    eng.step()
    for slot, (rid, _, _, enc) in enumerate(trace):
        if enc is None:
            enc = np.random.default_rng(rid).normal(size=(1, 8, 64)).astype(
                np.float32)
        se = enc.shape[1]
        ck, cv = ted.cross_kv(tparams, tcfg, ted.encode(
            tparams, tcfg, torch.from_numpy(enc)))
        assert int(eng.pools["enc_len"][slot]) == se
        for name, val in (("cross_k", ck), ("cross_v", cv)):
            assert torch.equal(eng.pools[name][:, slot, :se], val[:, 0])
            assert not eng.pools[name][:, slot, se:].any()
    assert eng.pools["cross_k"].shape == (2, 4, 64, 4, 16)


def test_unported_encdec_features_raise(models):
    jcfg, jparams, tcfg, tparams = models
    for kw, item in ((dict(mode="full"), "item 11"),
                     (dict(pipeline_depth=1), "6b")):
        with pytest.raises(NotImplementedError, match=item):
            KVRMEngine(get_reduced(ARCH), tparams,
                       EngineConfig(**{**ENGINE, **kw}), device="cpu")
    eng = KVRMEngine(get_reduced(ARCH), tparams, EngineConfig(**ENGINE),
                     device="cpu")
    r = Request(rid=0, prompt=np.arange(3, dtype=np.int32), gen_len=2)
    r.enc_embeds = np.zeros((1, 65, 64), np.float32)   # > max_seq 64
    eng.submit(r)
    with pytest.raises(ValueError, match="S_enc"):
        eng.step()
