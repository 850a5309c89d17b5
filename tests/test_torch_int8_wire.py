"""The int8 migration wire against JAX's, exactly.

``BlockMigrator(wire="int8")`` carries floating KV as int8 codes with one
f32 scale a block row.  JAX's migrator takes the row's amax, the scale
and ``x / scale`` in the leaf's own dtype (``collectives.quantize``) and
dequantizes as ``codes.astype(dtype) * scale``.  The port must give the
same payload (``b_int8``, ``scales`` and the untouched leaves' buffers)
and the same scattered pools, bit for bit, over f32 and bf16 pools and
bf16 pools at rest under an f32 model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.serve import migrate as jmig
from distributed_deep_learning_tpu_torch.serve import migrate as tmig
from distributed_deep_learning_tpu_torch.serve import paged as tpaged
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

SRC_IDS, DST_IDS = [3, 5, 8, 1], [4, 2, 6, 7]


def _pools(kv_dtype, dtype, seed):
    """Two layers of 10 blocks of 4 positions, 2 KV heads of width 16:
    unit-normal K/V at several magnitudes a block, random validity."""
    g = torch.Generator().manual_seed(seed)
    pools = tpaged.build_pools(2, 10, 4, 2, 16, dtype=dtype, device="cpu",
                               kv_dtype=kv_dtype)
    for layer in pools:
        for t in layer.values():
            if t.dtype == torch.bool:
                t.copy_(torch.rand(t.shape, generator=g) > 0.3)
            else:
                mag = torch.logspace(-3, 2, t.shape[0])
                x = torch.randn(t.shape, generator=g) * mag.view(
                    -1, *([1] * (t.dim() - 1)))
                t.copy_(x.to(t.dtype))
    return pools


def _np(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _jax_pools(pools):
    return [{k: jnp.asarray(_np(v)) for k, v in layer.items()}
            for layer in pools]


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX array (bf16 as its int16 pattern)."""
    if isinstance(x, torch.Tensor):
        x = _np(x.contiguous())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


CASES = [(None, torch.float32), (None, torch.bfloat16),
         ("bf16", torch.float32)]


@pytest.mark.parametrize("kv_dtype,dtype", CASES,
                         ids=["f32", "bf16", "bf16_at_rest"])
def test_int8_payload_equals_jax(kv_dtype, dtype):
    pools = _pools(kv_dtype, dtype, 0)
    port = tmig.BlockMigrator(len(SRC_IDS), wire="int8")
    ref = jmig.BlockMigrator(len(SRC_IDS), wire="int8")
    got = port._gather(pools, torch.tensor(SRC_IDS))
    want = ref._gather(_jax_pools(pools), np.asarray(SRC_IDS, np.int32))
    assert sorted(got) == sorted(want)
    assert {"b_int8", "scales"} <= set(got)
    for key in want:
        a, b = _bits(got[key]), _bits(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("kv_dtype,dtype", CASES,
                         ids=["f32", "bf16", "bf16_at_rest"])
def test_int8_scattered_pools_equal_jax(kv_dtype, dtype):
    src, dst = _pools(kv_dtype, dtype, 0), _pools(kv_dtype, dtype, 1)
    jsrc, jdst = _jax_pools(src), _jax_pools(dst)
    port = tmig.BlockMigrator(len(SRC_IDS), wire="int8")
    ref = jmig.BlockMigrator(len(SRC_IDS), wire="int8")
    out = port.migrate(src, dst, SRC_IDS, DST_IDS)
    jout = ref.migrate(jsrc, jdst, SRC_IDS, DST_IDS)
    assert port.stats.wire_bytes == ref.stats.wire_bytes
    for layer, jlayer in zip(out, jout):
        for name, t in layer.items():
            np.testing.assert_array_equal(_bits(t), _bits(jlayer[name]),
                                          err_msg=name)
