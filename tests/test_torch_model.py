"""The port's dense model (decode step, chunked prefill step) against
``repro.models.registry`` on reduced qwen2.5-32b.

The reference's weights are carried over with ``params_from_reference``
(torch cannot draw jax's random numbers); pools and descriptors come from a
numpy seed and are handed to both sides.

Tolerances: logits atol 3e-2 (bf16 logits; the two frameworks take f32
sums in different orders, so a bf16 rounding can land one ulp apart);
pools: entries the step does not write are bitwise equal, layer 0's written
K/V rows (identical inputs) are within one bf16 ulp elementwise, and deeper
layers' rows — whose inputs passed through the previous layer's attention
and projections, where such one-ulp roundings occur — are within
``DEEP_ULPS`` bf16 ulps of each row's scale (max |x| over head_dim).
Integer paths (descriptor layout and views) are exact.
"""
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
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import descriptor as tdesc  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

B, BT, NB, C = 4, 8, 3, 8
W = (NB - 1) * BT
P = 1 + B * (NB + 2)
LOGIT_ATOL = 3e-2
DEEP_ULPS = 4


@pytest.fixture(scope="module")
def models():
    jcfg = jget_reduced("qwen2.5-32b")
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(near_window=W))
    tcfg = get_reduced("qwen2.5-32b")
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(near_window=W))
    jparams = jreg.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _pools(seed, cfg):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, P, BT, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jp = {"k": jnp.asarray(k).astype(jnp.bfloat16),
          "v": jnp.asarray(v).astype(jnp.bfloat16)}
    tp = {"k": torch.from_numpy(k).to(torch.bfloat16),
          "v": torch.from_numpy(v).to(torch.bfloat16)}
    return jp, tp


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bf16_ulp(mag):
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                     - 7), 0.0)


def _assert_pools_close(got, want, written):
    """got/want: (L, P, BT, KV, hd) pools after the step; written: boolean
    (P, BT) mask of the token slots the step wrote."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_array_equal(got[:, ~written], want[:, ~written])
    g, w = got[:, written], want[:, written]            # (L, N, KV, hd)
    diff = np.abs(g - w)
    mag = np.maximum(np.abs(g), np.abs(w))
    assert (diff[0] <= _bf16_ulp(mag[0])).all(), \
        f"layer 0 K/V beyond one bf16 ulp: max diff {diff[0].max()}"
    row_ulp = _bf16_ulp(mag.max(axis=-1, keepdims=True))
    assert (diff <= DEEP_ULPS * row_ulp).all(), \
        f"K/V rows beyond {DEEP_ULPS} row-scale ulps: max diff {diff.max()}"


def _decode_fields(seed):
    """A decode step's descriptor fields: engine window bases, distinct
    physical blocks per slot, the write slot at position t, slot 3 idle."""
    rng = np.random.default_rng(seed)
    t = np.array([0, 5, 20, 11], np.int32)
    act = np.array([1, 1, 1, 0], np.int32)
    wb = ((np.maximum(0, t + 1 - W) // BT) * BT).astype(np.int32)
    blocks = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB)
    wblk = blocks[np.arange(B), (t - wb) // BT]
    woff = t % BT
    return dict(block_table=blocks.astype(np.int32), window_base=wb,
                seq_lens=t, slot_active=act, write_block=wblk.astype(np.int32),
                write_offset=woff.astype(np.int32))


def _descriptors(fields):
    MT, CB, CAP = NB + 1, 1, 1
    D = jdesc.descriptor_flat_size(B, NB, CAP, MT, CB)
    assert D == tdesc.descriptor_flat_size(B, NB, CAP, MT, CB)
    jflat = np.zeros(D, np.int32)
    jv = jdesc.flat_descriptor_views(jflat, B, NB, CAP, MT, CB)
    tflat = np.zeros(D, np.int32)
    tv = tdesc.flat_descriptor_views(tflat, B, NB, CAP, MT, CB)
    for name, a in fields.items():
        getattr(jv, name)[...] = a
        getattr(tv, name)[...] = a
    np.testing.assert_array_equal(jflat, tflat)
    jd = jdesc.unflatten_descriptor(jnp.asarray(jflat), B, NB, CAP, MT, CB)
    td = tdesc.unflatten_descriptor(torch.from_numpy(tflat), B, NB, CAP, MT,
                                    CB)
    for a, b in zip(jd, td):                  # integer path: exact
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jd, td


def test_descriptor_layouts_match_reference():
    for b, nb, cap, mt, cb in [(1, 1, 1, 2, 1), (4, 3, 1, 4, 1),
                               (8, 33, 16, 34, 4), (3, 7, 2, 8, 2)]:
        assert (jdesc.descriptor_flat_size(b, nb, cap, mt, cb)
                == tdesc.descriptor_flat_size(b, nb, cap, mt, cb))
        assert jdesc._descriptor_layout(b, nb, cap, mt, cb) \
            == tdesc._descriptor_layout(b, nb, cap, mt, cb)
        for c in (1, 8, 64):
            assert jdesc.chunk_flat_size(b, c, nb) == tdesc.chunk_flat_size(
                b, c, nb)
            assert jdesc._chunk_layout(b, c, nb) == tdesc._chunk_layout(b, c,
                                                                        nb)


@pytest.mark.parametrize("skip", [True, False])
def test_decode_step_logits_and_pools(models, skip):
    jcfg, jparams, tcfg, tparams = models
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(near_window=W,
                                                       skip_extent=skip))
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(near_window=W,
                                                       skip_extent=skip))
    jd, td = _descriptors(_decode_fields(0))
    tokens = np.array([7, 100, 255, 3], np.int32)
    jpools, tpools = _pools(1, jcfg)
    jlog, jpools, _ = jreg.decode_step(jparams, jcfg, jnp.asarray(tokens),
                                       jpools, jd)
    tlog, tpools, _ = treg.decode_step(tparams, tcfg,
                                       torch.from_numpy(tokens), tpools, td)
    assert tlog.shape == (B, tcfg.vocab_size) and tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), atol=LOGIT_ATOL,
                               rtol=0)
    written = np.zeros((P, BT), bool)
    f = _decode_fields(0)
    act = f["slot_active"] > 0
    written[f["write_block"][act], f["write_offset"][act]] = True
    for k in ("k", "v"):
        _assert_pools_close(tpools[k], jpools[k], written)


def test_prefill_chunk_pools(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    start = np.array([0, 8, 13, 30], np.int32)
    nv = np.array([C, 5, C, 0], np.int32)
    wb = ((np.maximum(0, start + 1 - W) // BT) * BT).astype(np.int32)
    blocks = rng.permutation(np.arange(1, P))[:B * (NB + 2)].reshape(
        B, NB + 2).astype(np.int32)
    pos = start[:, None] + np.arange(C)[None]
    local = (pos - wb[:, None]) // BT
    wblk = np.take_along_axis(blocks, np.minimum(local, NB + 1), 1)
    wblk = np.where(np.arange(C)[None] < nv[:, None], wblk, 0).astype(np.int32)
    woff = np.where(wblk > 0, pos % BT, 0).astype(np.int32)
    fields = dict(tokens=rng.integers(0, 256, size=(B, C)).astype(np.int32),
                  start_pos=start, n_valid=nv, block_table=blocks[:, :NB],
                  window_base=wb, write_block=wblk, write_offset=woff)
    CD = tdesc.chunk_flat_size(B, C, NB)
    flat = np.zeros(CD, np.int32)
    views = tdesc.flat_chunk_views(flat, B, C, NB)
    for name, a in fields.items():
        getattr(views, name)[...] = a
    td = tdesc.unflatten_chunk_descriptor(torch.from_numpy(flat), B, C, NB)
    jd = jdesc.PrefillChunkDescriptor(**{k: jnp.asarray(v)
                                         for k, v in fields.items()})
    jpools, tpools = _pools(3, jcfg)
    jpools = jreg.prefill_chunk(jparams, jcfg, jpools, jd)
    tpools = treg.prefill_chunk(tparams, tcfg, tpools, td)
    written = np.zeros((P, BT), bool)
    ok = np.arange(C)[None] < nv[:, None]
    written[wblk[ok], woff[ok]] = True
    for k in ("k", "v"):
        _assert_pools_close(tpools[k], jpools[k], written)
