"""The port's flash attention against the JAX Pallas kernels.

On CPU tensors the port's ``flash_attention`` runs the kernels' plain
versions (``flash_attention_reference`` forward, ``flash_backward_reference``
backward); the JAX side runs the Pallas kernels in interpret mode with
8-row blocks.  Same seeded numpy inputs on both sides; forward at atol
1e-5, LSE against ``_flash_fwd``'s, gradients (one VJP with a seeded
cotangent) at atol 1e-4.  The CUDA kernels themselves are held against
the same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.ops import attention_pallas as jap
from distributed_deep_learning_tpu_torch.ops import attention as tat
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

B, H, T, D = 2, 4, 24, 16
BLOCK = 8

#: name -> (Tq, Tk, Hkv, causal, padded, window)
CASES = {
    "non_causal": (T, T, H, False, False, None),
    "causal": (T, T, H, True, False, None),
    "padding": (T, T, H, False, True, None),
    "padding_causal": (T, T, H, True, True, None),
    "window_5": (T, T, H, True, False, 5),
    "gqa_hkv2": (T, T, 2, True, True, None),
    "cross_causal_top_left": (8, 24, H, True, False, None),
    "cross_non_causal": (8, 24, H, False, True, None),
    "ragged_t20": (20, 20, H, True, True, None),
}


def _inputs(Tq, Tk, Hkv, padded, seed=0, fully_padded_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    valid = None
    if padded or fully_padded_row:
        valid = np.ones((B, Tk), bool)
        valid[1, Tk - Tk // 3:] = False       # a right-padded row
        if fully_padded_row:
            valid[1] = False
    return q, k, v, g, valid


def _jax_run(q, k, v, g, valid, causal, window):
    def fwd(q, k, v):
        return jap.flash_attention(
            q, k, v, causal=causal,
            key_valid=None if valid is None else jnp.asarray(valid),
            block_q=BLOCK, block_k=BLOCK, window=window, interpret=True)

    out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _jax_lse(q, k, v, valid, causal, window):
    def bhtd(x):
        return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(
            -1, x.shape[1], x.shape[3])

    kvalid = None if valid is None else \
        jnp.asarray(valid, jnp.float32)[:, None, :]
    _, lse = jap._flash_fwd(bhtd(q), bhtd(k), bhtd(v), kvalid,
                            1.0 / np.sqrt(D), causal, BLOCK, BLOCK, True,
                            window)
    return np.asarray(lse).reshape(B, H, q.shape[1])


def _torch_run(q, k, v, g, valid, causal, window):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    kv = None if valid is None else torch.tensor(valid)
    out = tat.flash_attention(qt, kt, vt, causal=causal, key_valid=kv,
                              window=window)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_lse_and_grads_match_pallas(case):
    Tq, Tk, Hkv, causal, padded, window = CASES[case]
    q, k, v, g, valid = _inputs(Tq, Tk, Hkv, padded, seed=len(case))
    for counter in (tat.flash_forward, tat.flash_backward_dq,
                    tat.flash_backward_dkv):
        counter.launches = 0
    out, grads = _torch_run(q, k, v, g, valid, causal, window)
    jout, jgrads = _jax_run(q, k, v, g, valid, causal, window)
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=0)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    kv = None if valid is None else torch.tensor(valid)
    _, lse = tat.flash_forward(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), kv, causal=causal,
                               sm_scale=1.0 / np.sqrt(D), window=window)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(q, k, v, valid, causal, window),
                               atol=1e-5, rtol=0)
    # CPU tensors take the plain versions: no kernel was launched
    assert (tat.flash_forward.launches, tat.flash_backward_dq.launches,
            tat.flash_backward_dkv.launches) == (0, 0, 0)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_padded_row_is_finite_with_zero_grads(causal):
    q, k, v, g, valid = _inputs(T, T, H, False, seed=7,
                                fully_padded_row=True)
    out, grads = _torch_run(q, k, v, g, valid, causal, None)
    assert np.isfinite(out).all()
    for got in grads:
        assert np.all(got[1] == 0.0)
    # the other batch row still matches the kernels
    jout, jgrads = _jax_run(q, k, v, g, valid, causal, None)
    np.testing.assert_allclose(out[0], jout[0], atol=1e-5, rtol=0)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
        assert np.all(want[1] == 0.0)


def test_bf16_plain_version_keeps_dtypes():
    q, k, v, g, valid = _inputs(T, T, 2, True, seed=3)
    qt, kt, vt = (torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
                  for x in (q, k, v))
    out = tat.flash_attention(qt, kt, vt, causal=True,
                              key_valid=torch.tensor(valid))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.tensor(g)).sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 for x in (qt, kt, vt))
    ref = tat.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                              causal=True, key_valid=torch.tensor(valid))
    assert (out.float() - ref).abs().max() < 5e-2


@pytest.mark.parametrize("kw,match", [
    ({"window": 4}, "requires causal"),
    ({"window": 0, "causal": True}, "must be >= 1"),
    ({"hkv": 3}, "multiple"),
])
def test_bad_arguments_raise(kw, match):
    hkv = kw.pop("hkv", H)
    q = torch.zeros(1, 8, H, D)
    k = torch.zeros(1, 8, hkv, D)
    with pytest.raises(ValueError, match=match):
        tat.flash_attention(q, k, k, **kw)


def test_non_cuda_device_raises_not_falls_back():
    q = torch.zeros(1, 8, H, D, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tat.flash_forward(q, q, q, None, causal=True, sm_scale=0.25,
                          window=None)


#: bf16: both sides round P (forward, dV) and dS (dQ, dK) to bf16 inside
#: and every output once more; their f32 sums differ in order and in the
#: running max at which P was rounded.  So they may differ by one bf16
#: spacing at the largest magnitude, 2^-7 of max|ref| (8 significant bits):
#: measured at most 4.6e-3 of max|ref| here, 6.9e-3 without the rounding
#: of P and dS in the plain versions.
BF16_REL_TOL = 2.0 ** -7


@pytest.mark.parametrize("case", ["causal", "padding_causal", "gqa_hkv2",
                                  "window_5", "non_causal"])
def test_bf16_plain_version_matches_pallas_on_bf16_inputs(case):
    Tq, Tk, Hkv, causal, padded, window = CASES[case]
    q, k, v, g, valid = _inputs(Tq, Tk, Hkv, padded, seed=len(case))
    kv = None if valid is None else torch.tensor(valid)
    qt, kt, vt = (torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    out = tat.flash_attention(qt, kt, vt, causal=causal, key_valid=kv,
                              window=window)
    out.backward(torch.tensor(g).to(torch.bfloat16))

    def fwd(q, k, v):
        return jap.flash_attention(
            q, k, v, causal=causal,
            key_valid=None if valid is None else jnp.asarray(valid),
            block_q=BLOCK, block_k=BLOCK, window=window, interpret=True)

    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
    jout, vjp = jax.vjp(fwd, *bf[:3])
    want = [jout, *vjp(bf[3])]
    for name, got, ref in zip(("out", "dq", "dk", "dv"),
                              (out, qt.grad, kt.grad, vt.grad), want):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), ref,
                                   atol=BF16_REL_TOL * np.abs(ref).max(),
                                   rtol=0, err_msg=name)


def _tf32(x):
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_3xtf32_split_keeps_f32_accuracy():
    """Why the f32 kernels may use the tensor cores: each operand is split
    into a TF32 ``hi`` and a TF32 residual ``lo``, and a product is
    ``hi.hi + hi.lo + lo.hi`` summed in f32 (TF32 products are exact in
    f32).  On a seeded q.k^T the error stays within 1e-6 of max|ref|, far
    inside the kernels' 1e-4 limit; one TF32 pass is ~3e-4 off."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 64)).astype(np.float32)
    k = rng.standard_normal((64, 64)).astype(np.float32)
    ref = q.astype(np.float64) @ k.T.astype(np.float64)
    qh, kh = _tf32(q), _tf32(k)
    ql, kl = _tf32(q - qh), _tf32(k - kh)
    assert np.all(np.abs(q - qh) <= np.abs(q) * 2.0 ** -11)
    three = (ql @ kh.T + qh @ kl.T) + qh @ kh.T            # f32 sums
    one = qh @ kh.T
    scale = np.abs(ref).max()
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 <= 1e-6, err3
    assert 1e-4 <= err1 <= 1e-3, err1


@pytest.mark.parametrize("q_offset,window", [(0, None), (16, None),
                                             (-8, None), (24, 12),
                                             (-4, 6), (40, 8)])
def test_q_offset_plain_versions_equal_a_dense_band(q_offset, window):
    """Query ``i`` at position ``i + q_offset``: the forward's output and
    LSE, and the backward's gradients (from the global LSE and delta), on
    the rows that see a key, equal plain softmax attention under the band
    ``0 <= i + q_offset - j < window``; a row that sees none gets zero
    gradients."""
    rng = np.random.default_rng(11)
    B, Tq, Tk, H, Hkv, D = 2, 24, 32, 4, 2, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, Tq, H, D), (B, Tk, Hkv, D),
                               (B, Tk, Hkv, D), (B, Tq, H, D)))
    qp = torch.arange(Tq)[:, None] + q_offset
    kp = torch.arange(Tk)[None, :]
    band = (qp >= kp) & ((qp - kp < window) if window else True)
    seen = band.any(1)
    kw = dict(causal=True, sm_scale=D ** -0.5, window=window,
              q_offset=q_offset)
    out, lse = tat.flash_forward(q, k, v, None, **kw)

    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qq,
                     kk.repeat_interleave(H // Hkv, 2)) * D ** -0.5
    s = s.masked_fill(~band, float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    ref = torch.einsum("bhqk,bkhd->bqhd", p,
                       vv.repeat_interleave(H // Hkv, 2))
    (ref * do).sum().backward()
    rows = seen.nonzero()[:, 0]
    torch.testing.assert_close(out[:, rows], ref.detach()[:, rows],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        lse[:, :, rows], torch.logsumexp(s.detach(), -1)[:, :, rows],
        rtol=1e-5, atol=1e-5)
    out = torch.where(seen[None, :, None, None], out, 0.0)
    dq, dk, dv = tat.flash_backward_parts(q, k, v, None, do, lse,
                                          tat._delta(out, do), **kw)
    for got, want in ((dq, qq.grad), (dk, kk.grad), (dv, vv.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (dq[:, ~seen] == 0).all()
