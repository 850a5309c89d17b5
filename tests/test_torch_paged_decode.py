"""The port's paged decode (plain version and wrapper) against the JAX one.

Inputs are made with numpy from a seed and fed to both packages.  The
port's ``paged_decode_reference`` is held at atol 1e-5 against the JAX
``paged_decode_reference`` and against the JAX Pallas kernel run in
interpret mode on the CPU (f32 both sides; sums in different orders), and
with a sliding window against JAX's masked dense attention (the
``qpos - kpos < window`` mask of the flax model's cache).
On CPU tensors the wrapper takes the plain path and launches nothing;
the CUDA kernel itself is checked against the plain version on the card
by ``chip_smoke.py``.  Its split-K algebra (per-split partial softmax
states merged by a combine step) is emulated here in numpy and held
against the plain version, as is the host's split rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.ops import paged_decode_pallas as jpd
from distributed_deep_learning_tpu.serve import quant
from distributed_deep_learning_tpu_torch.ops import paged_decode as tpd
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ATOL = 1e-5


def _inputs(seed, B=3, Hkv=2, G=1, D=16, N=12, bs=8, Bps=3,
            lens=(5, 24, 13)):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv, G, D)).astype(np.float32)
    kp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, Hkv, D)).astype(np.float32)
    tables = np.zeros((B, Bps), np.int32)      # tails stay on trash block 0
    ids = rng.permutation(np.arange(1, N))
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb], ids = ids[:nb], ids[nb:]
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


CASES = {"f32": dict(G=1), "gqa_g2": dict(G=2), "long_d": dict(D=64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_reference_and_interpret_kernel(case):
    q, kp, vp, tables, lens = _inputs(1, **CASES[case])
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    want_ref = np.asarray(jpd.paged_decode_reference(*jargs))
    want_kern = np.asarray(jpd.paged_flash_decode(*jargs, interpret=True))
    got = tpd.paged_decode_reference(*_t(q, kp, vp, tables, lens)).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    np.testing.assert_allclose(got, want_kern, atol=ATOL)


def test_int8_pools_match_jax_on_shared_quantized_input():
    q, kp, vp, tables, lens = _inputs(2, G=2)
    kq, vq = quant.quantize_rows(jnp.asarray(kp)), \
        quant.quantize_rows(jnp.asarray(vp))
    jargs = [jnp.asarray(q), kq, vq, jnp.asarray(tables), jnp.asarray(lens)]
    want_ref = np.asarray(jpd.paged_decode_reference(*jargs))
    want_kern = np.asarray(jpd.paged_flash_decode(*jargs, interpret=True))
    k8, ks, v8, vs = (np.array(x) for x in (kq.q, kq.s, vq.q, vq.s))
    assert k8.dtype == np.int8 and ks.shape == kp.shape[:3] + (1,)
    got = tpd.paged_flash_decode(
        *_t(q, k8, v8, tables, lens), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    np.testing.assert_allclose(got, want_kern, atol=ATOL)


@pytest.mark.parametrize("window", [1, 5, 13, 64])
def test_windowed_plain_decode_matches_jax_masked_attention(window):
    """The query at ``seq_len - 1`` sees key ``kpos`` iff ``kpos <
    seq_len`` and ``qpos - kpos < window``: JAX's dense attention over the
    gathered logical cache with that mask (GQA, valid pool holes)."""
    q, kp, vp, tables, lens = _inputs(13, G=2)
    rng = np.random.default_rng(14)
    valid = rng.random(kp.shape[:2]) > 0.3
    valid[tables[np.arange(3), (lens - 1) // 8], (lens - 1) % 8] = True
    got = tpd.paged_flash_decode(*_t(q, kp, vp, tables, lens),
                                 valid_pool=torch.from_numpy(valid),
                                 window=window).numpy()
    B, Hkv, G, D = q.shape
    L = tables.shape[1] * kp.shape[1]
    k = jnp.asarray(kp)[tables].reshape(B, L, Hkv, D)
    v = jnp.asarray(vp)[tables].reshape(B, L, Hkv, D)
    kpos = jnp.arange(L)[None, :]
    qpos = jnp.asarray(lens)[:, None] - 1
    mask = (kpos <= qpos) & (qpos - kpos < window) & \
        jnp.asarray(valid)[tables].reshape(B, L)
    s = jnp.einsum("bhgd,bthd->bhgt", jnp.asarray(q), k) / np.sqrt(D)
    s = jnp.where(mask[:, None, None, :], s, jpd.NEG_INF)
    want = np.asarray(jnp.einsum("bhgt,bthd->bhgd",
                                 jax.nn.softmax(s, axis=-1), v))
    np.testing.assert_allclose(got, want, atol=ATOL)
    if window >= L:            # a window past every slot changes nothing
        plain = tpd.paged_decode_reference(
            *_t(q, kp, vp, tables, lens), valid_pool=torch.from_numpy(valid))
        np.testing.assert_array_equal(got, plain.numpy())
    with pytest.raises(ValueError, match="window must be >= 1"):
        tpd.paged_flash_decode(*_t(q, kp, vp, tables, lens), window=0)


def test_zero_length_slot_is_finite_and_matches_jax():
    q, kp, vp, tables, lens = _inputs(3, lens=(0, 9, 1))
    got = tpd.paged_flash_decode(*_t(q, kp, vp, tables, lens)).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jpd.paged_decode_reference(
        *[jnp.asarray(a) for a in (q, kp, vp, tables, lens)]))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_valid_pool_masks_positions_like_a_dense_softmax():
    q, kp, vp, tables, lens = _inputs(4, G=2)
    rng = np.random.default_rng(5)
    valid = rng.random(kp.shape[:2]) > 0.3
    valid[tables[np.arange(3), (lens - 1) // 8], (lens - 1) % 8] = True
    got = tpd.paged_decode_reference(*_t(q, kp, vp, tables, lens),
                                     valid_pool=torch.from_numpy(valid))
    B, Hkv, G, D = q.shape
    for b in range(B):
        pos = np.arange(lens[b])
        phys, off = tables[b, pos // 8], pos % 8
        keep = valid[phys, off]
        k, v = kp[phys, off][keep], vp[phys, off][keep]    # (n, Hkv, D)
        s = np.einsum("hgd,nhd->hgn", q[b], k) / np.sqrt(D)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.einsum("hgn,nhd->hgd", p, v)
        np.testing.assert_allclose(got[b].numpy(), want, atol=ATOL)
    # an all-true pool changes nothing
    full = tpd.paged_decode_reference(
        *_t(q, kp, vp, tables, lens),
        valid_pool=torch.ones(kp.shape[:2], dtype=torch.bool))
    plain = tpd.paged_decode_reference(*_t(q, kp, vp, tables, lens))
    torch.testing.assert_close(full, plain, rtol=0, atol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    args = _t(*_inputs(6, G=2))
    before = tpd.paged_flash_decode.launches
    got = tpd.paged_flash_decode(*args)
    torch.testing.assert_close(got, tpd.paged_decode_reference(*args),
                               rtol=0, atol=0)
    assert tpd.paged_flash_decode.launches == before


def test_mismatched_quantization_raises_the_jax_message():
    q, kp, vp, tables, lens = _t(*_inputs(7))
    with pytest.raises(ValueError, match="agree on quantization"):
        tpd.paged_flash_decode(q, kp, vp, tables, lens,
                               k_scale=torch.ones(kp.shape[:3] + (1,)))
    with pytest.raises(ValueError, match="agree on quantization"):
        jpd.paged_flash_decode(*[jnp.asarray(t.numpy()) for t in
                                 (q, kp, vp, tables, lens)],
                               v_scale=jnp.ones(kp.shape[:3] + (1,)))


def _good_kernel_args():
    q, kp, vp, tables, lens = _t(*_inputs(8, D=32))
    return dict(q=q, k_pool=kp, v_pool=vp, block_tables=tables,
                seq_lens=lens, k_scale=None, v_scale=None,
                valid_pool=torch.ones(kp.shape[:2], dtype=torch.bool))


BAD_ARGS = {
    "head_dim": (lambda a: a.update(q=a["q"][..., :16].contiguous()),
                 "head_dim"),
    "group": (lambda a: a.update(q=torch.zeros(3, 2, 9, 32)), "group"),
    "q_dtype": (lambda a: a.update(q=a["q"].double()), "q dtype"),
    "pool_dtypes": (lambda a: a.update(v_pool=a["v_pool"].half()),
                    "pool dtypes"),
    "pool_shape": (lambda a: a.update(k_pool=a["k_pool"][:, :, :1]
                                      .contiguous(),
                                      v_pool=a["v_pool"][:, :, :1]
                                      .contiguous()), "pools must be"),
    "tables_dtype": (lambda a: a.update(block_tables=a["block_tables"]
                                        .long()), "block_tables"),
    "lens_dtype": (lambda a: a.update(seq_lens=a["seq_lens"].long()),
                   "seq_lens"),
    "contiguity": (lambda a: a.update(q=a["q"].transpose(0, 1)),
                   "contiguous"),
    "int8_without_scales": (lambda a: a.update(
        k_pool=a["k_pool"].to(torch.int8),
        v_pool=a["v_pool"].to(torch.int8)), "int8 pools need scales"),
    "valid_dtype": (lambda a: a.update(valid_pool=a["valid_pool"].int()),
                    "valid_pool"),
}


def test_kernel_argument_checks_accept_the_engine_layout():
    tpd._check_kernel_args(**_good_kernel_args())


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_argument_checks_reject(case):
    edit, match = BAD_ARGS[case]
    args = _good_kernel_args()
    edit(args)
    with pytest.raises(ValueError, match=match):
        tpd._check_kernel_args(**args)


# --- split-K: the kernel's algebra, emulated in numpy ------------------------

def _split_k(q, kp, vp, tables, lens, splits, k_scale=None, v_scale=None,
             valid=None, window=None):
    """What the CUDA kernel computes, step by step: each slot's ``Bps``
    logical blocks cut into runs of ``per = ceil(Bps / splits)``; a block
    walks its run clipped to ``[lo, seq_len)`` (``lo = seq_len - window``
    with a window, else 0) and keeps (m, l, acc) in f32, masked positions
    skipped (a split with none live keeps m = -1e30, l = 0); the combine
    merges the splits that cover ``[lo, seq_len)`` with ``c = exp(m_s -
    max m)``, ``out = sum(acc_s c) / max(sum(l_s c), 1e-30)``.  Returns
    ``(B, Hkv, G, D)`` f32."""
    B, Hkv, G, D = q.shape
    bs, Bps = kp.shape[1], tables.shape[1]
    per = -(-Bps // splits)
    run = per * bs
    out = np.zeros((B, Hkv, G, D), np.float32)
    for b in range(B):
        n = min(max(int(lens[b]), 0), Bps * bs)
        lo = max(0, n - window) if window else 0
        parts = []
        for sp in range(lo // run, -(-n // run)):   # the live splits only
            m = np.full((Hkv, G), -1e30, np.float32)
            l = np.zeros((Hkv, G), np.float32)
            acc = np.zeros((Hkv, G, D), np.float32)
            for t in range(max(lo, sp * run), min(n, (sp + 1) * run)):
                phys, off = tables[b, t // bs], t % bs
                if valid is not None and not valid[phys, off]:
                    continue
                k = kp[phys, off].astype(np.float32)
                v = vp[phys, off].astype(np.float32)
                if k_scale is not None:
                    k, v = k * k_scale[phys, off], v * v_scale[phys, off]
                s = np.einsum("hgd,hd->hg", q[b], k) / np.float32(D ** 0.5)
                mx = np.maximum(m, s)
                c, p = np.exp(m - mx), np.exp(s - mx)
                l = l * c + p
                acc = acc * c[..., None] + p[..., None] * v[:, None, :]
                m = mx
            parts.append((m, l, acc))
        if not parts:
            continue                                # no live split: zeros
        mx = np.max([m for m, _, _ in parts], axis=0)
        den = sum(l * np.exp(m - mx) for m, l, _ in parts)
        num = sum(a * np.exp(m - mx)[..., None] for m, _, a in parts)
        out[b] = num / np.maximum(den, 1e-30)[..., None]
    return out


def _quantize(x):
    scale = np.abs(x).max(-1, keepdims=True).clip(1e-8) / 127.0
    return (np.clip(np.round(x / scale), -127, 127).astype(np.int8),
            scale.astype(np.float32))


#: Bps 8 of bs 4: an empty slot, a slot shorter than one split, one ending
#: on the 3-split boundary (12 = 3 blocks x 4) and on the 8-split ones, one
#: whose end falls inside a split, and a full one
SPLIT_LENS = (0, 2, 12, 27, 32)
SPLIT_CASES = {"f32": {}, "valid_holes": {"holes": True},
               "int8_scales": {"int8": True}, "window_5": {"window": 5},
               "window_13_holes": {"window": 13, "holes": True}}


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_k_partials_merge_to_the_plain_version(case, splits):
    spec = SPLIT_CASES[case]
    q, kp, vp, tables, lens = _inputs(11, B=5, G=2, N=40, bs=4, Bps=8,
                                      lens=SPLIT_LENS)
    kw, emu = {}, {}
    if spec.get("int8"):
        (kp, ks), (vp, vs) = _quantize(kp), _quantize(vp)
        kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        emu = dict(k_scale=ks, v_scale=vs)
    if spec.get("holes"):
        valid = np.random.default_rng(12).random(kp.shape[:2]) > 0.3
        for b, n in enumerate(lens):      # the query's own position is valid
            if n:
                valid[tables[b, (n - 1) // 4], (n - 1) % 4] = True
        kw["valid_pool"] = torch.from_numpy(valid)
        emu["valid"] = valid
    if spec.get("window"):
        kw["window"] = emu["window"] = spec["window"]
    got = _split_k(q, kp, vp, tables, lens, splits, **emu)
    want = tpd.paged_decode_reference(*_t(q, kp, vp, tables, lens),
                                      **kw).numpy()
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)
    assert np.all(got[~live] == 0)        # the empty slot: finite zeros


@pytest.mark.parametrize("shape", [
    (8, 12, 64, 16, 132),    # the serving slice's 8 slots
    (2, 12, 64, 16, 132),    # f32_long: two slots of 1024 positions
    (64, 12, 64, 16, 132),   # many slots: one or two long runs each
    (3, 2, 3, 8, 132),       # the CPU tests' shape
    (1, 1, 64, 1, 4),        # one position a block
])
def test_split_rule_covers_each_table_from_the_shapes_alone(shape):
    B, Hkv, Bps, bs, sms = shape
    splits, per = tpd.decode_splits(*shape)
    assert 1 <= splits <= Bps and 1 <= per <= Bps
    assert (splits - 1) * per < Bps <= splits * per    # no empty run
    if per < Bps and tpd.RUN_STEP % bs == 0:
        assert per * bs % tpd.RUN_STEP == 0   # whole steps of the 8 warps
    if per > max(1, tpd.RUN_STEP // bs):      # not cut finer than a step
        assert B * Hkv * splits >= tpd.WAVES * sms // 2


def test_kernel_source_names_what_it_replaces_and_builds_at_first_use():
    src = tpd._SOURCE.read_text()
    assert "paged_decode_pallas.py" in src and "_decode_kernel" in src
    assert "split-K" in src and "3.35 TB/s" in src
    assert "compute_90a" in " ".join(tpd.NVCC_FLAGS)
    # importing the module built nothing (no nvcc here)
    assert tpd._library.cache_info().currsize == 0
