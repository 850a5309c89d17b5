"""The port's hot weight reload against JAX's: publish, watch, verify,
quarantine, canary, promote and roll back.

Both packages publish the same weights (a small ``gpt``, 2 layers of d 32
over a vocabulary of 64, carried across from JAX) in the manifest schema
(``format``, ``step``, ``n_leaves``, per-leaf CRC32, shape, dtype and
finiteness); a truncated, a bit-flipped, a NaN and a wrong-geometry
publication must get the same verdict from both, and the canary must
promote and roll back where JAX's does, with the same restarts and the
same tokens.  ``--publish-weights`` publishes every durable save.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import reload as jrel
from distributed_deep_learning_tpu.serve import supervisor as jsup
from distributed_deep_learning_tpu.serve.bench import make_trace
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve import reload as trel
from distributed_deep_learning_tpu_torch.serve import supervisor as tsup
from distributed_deep_learning_tpu_torch.utils.chaos import ChaosPlan
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    CheckpointCorruption
from distributed_deep_learning_tpu_torch.utils.failures import \
    MonitorUnhealthy
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=48)
ENGINE = dict(max_slots=3, kv_block_size=8, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _models():
    jm = jtr.CausalLM(**MODEL)
    params = jm.init(jax.random.key(2), jnp.ones((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm


def _port_params():
    return {k: v.detach().clone() for k, v in _models()[2].state_dict()
            .items()}


def _trace():
    return make_trace(6, vocab_size=MODEL["vocab_size"], seed=0,
                      prompt_lens=(3, 10), new_tokens=(4, 10))


def _tokens(out):
    return {uid: np.asarray(t).tolist() for uid, t in out["results"].items()}


def _verdict(load):
    """``"ok"`` or the kind of corruption a load raised."""
    try:
        load()
    except Exception as e:  # noqa: BLE001 - both packages' corruption
        msg = str(e)
        assert type(e).__name__ == "CheckpointCorruption", msg
        for kind in ("unreadable payload", "non-finite", "finite",
                     "geometry", "leaves", "mismatch"):
            if kind in msg:
                return kind
        return msg
    return "ok"


DAMAGE = {
    "intact": lambda path: None,
    "truncated": lambda path: open(path, "r+b").truncate(
        os.path.getsize(path) // 2),
    "bitflipped": lambda path: ChaosPlan.bitflip_file(path, seed=0),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damaged_publication_verdict_matches_jax(damage, tmp_path):
    _, params, _ = _models()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrel.publish_weights(jd, 1, params)
    trel.publish_weights(td, 1, _port_params())
    for d, mod in ((jd, jrel), (td, trel)):
        DAMAGE[damage](mod._weights_path(d, 1))
    jv = _verdict(lambda: jrel.load_verified(jd, 1, params))
    tv = _verdict(lambda: trel.load_verified(td, 1, _port_params()))
    # a bit flipped in the zip's bytes: where it lands (a leaf's bytes,
    # a zip header) differs between the two payloads, so the kind may
    # differ; the verdict (refused) may not
    assert (tv != "ok") == (jv != "ok")
    if damage != "bitflipped":
        assert tv == jv
    assert (tv == "ok") == (damage == "intact")


def test_nan_and_wrong_geometry_verdicts_match_jax(tmp_path):
    _, params, _ = _models()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrel.publish_weights(jd, 1, jax.tree.map(
        lambda x: np.full_like(x, np.nan), params))
    trel.publish_weights(td, 1, {k: torch.full_like(v, float("nan"))
                                 for k, v in _port_params().items()})
    jv = _verdict(lambda: jrel.load_verified(jd, 1, params))
    tv = _verdict(lambda: trel.load_verified(td, 1, _port_params()))
    assert tv == jv == "non-finite"
    # wrong geometry: a model of another width against the engine's
    small = dict(MODEL, d_model=16, mlp_dim=32)
    jm2 = jtr.CausalLM(**small)
    jp2 = jax.tree.map(np.asarray, jm2.init(
        jax.random.key(3), jnp.ones((1, 4), jnp.int32))["params"])
    tm2 = ttr.CausalLM(**small)
    tm2.load_state_dict(ttr.load_flax_params(jp2))
    jrel.publish_weights(jd, 2, jp2)
    trel.publish_weights(td, 2, tm2.state_dict())
    jv = _verdict(lambda: jrel.load_verified(jd, 2, params))
    tv = _verdict(lambda: trel.load_verified(td, 2, _port_params()))
    assert tv != "ok" and jv != "ok"
    assert tv == jv


def test_publish_round_trip_manifest_and_torn_publish(tmp_path):
    d = str(tmp_path)
    assert trel.latest_published(d) is None
    params = _port_params()
    trel.publish_weights(d, 3, params)
    manifest = json.load(open(trel._manifest_path(d, 3)))
    assert manifest["format"] == jrel.WEIGHTS_FORMAT
    assert (manifest["step"], manifest["n_leaves"]) == (3, len(params))
    assert set(manifest["leaves"]["/" + next(iter(params))]) == {
        "crc32", "shape", "dtype", "finite"}
    got = trel.load_verified(d, 3, params)
    assert list(got) == list(params)
    for k in params:
        assert torch.equal(got[k], params[k])
    np.savez(os.path.join(d, "weights-00000009.npz"),
             leaf_00000=np.zeros(1))
    assert trel.latest_published(d) == 3        # torn: invisible
    trel.quarantine_weights(d, 3, "crc mismatch")
    assert trel.latest_published(d) is None
    names = os.listdir(os.path.join(d, "quarantine"))
    assert "weights-00000003.reason.json" in names


def test_bf16_publication_round_trips(tmp_path):
    params = {k: v.to(torch.bfloat16) for k, v in _port_params().items()}
    trel.publish_weights(str(tmp_path), 1, params)
    got = trel.load_verified(str(tmp_path), 1, params)
    assert all(torch.equal(got[k], params[k]) for k in params)


def test_watcher_tolerates_flaky_io(tmp_path):
    from unittest import mock

    w = trel.WeightWatcher(str(tmp_path / "nope"), io_error_tolerance=2)
    assert w.poll() is None and w.healthy
    w = trel.WeightWatcher(str(tmp_path), io_error_tolerance=2)
    with mock.patch("os.listdir", side_effect=OSError("disk on fire")):
        assert w.poll() is None and w.healthy
        assert w.poll() is None and not w.healthy
    assert isinstance(w.failure, MonitorUnhealthy)
    w.reset()
    trel.publish_weights(str(tmp_path), 5, _port_params())
    assert w.poll() == 5
    w.mark(5)
    assert w.poll() is None


@functools.lru_cache(maxsize=None)
def _engines():
    """One engine a package, reset before each use (JAX's compiled once)."""
    jm, params, tm = _models()
    return (jeng.PagedEngine(jm, params, **ENGINE),
            teng.PagedEngine(tm, device="cpu", **ENGINE))


def _reload_both(tmp_path, publish, seen=()):
    """Each package's supervised engine with a reload manager watching a
    directory ``publish(d, pkg)`` filled; returns both outputs."""
    outs = []
    for pkg, rel, sup, eng in (("jax", jrel, jsup, _engines()[0]),
                               ("torch", trel, tsup, _engines()[1])):
        eng.reset()
        d = str(tmp_path / pkg)
        publish(d, pkg)
        rm = rel.ReloadManager(d, canary_slots=1, canary_ticks=2,
                               min_compare=2)
        rm.watcher.seen.update(seen)
        outs.append((sup.ServeSupervisor(eng, reload=rm).run(_trace()), d))
    return outs


def test_canary_promote_and_rollback_match_jax(tmp_path):
    jm, params, tm = _models()
    zeros = jax.tree.map(np.zeros_like, params)

    def publish(d, pkg, bad=True):
        if pkg == "jax":
            jrel.publish_weights(d, 1, params)
            if bad:
                jrel.publish_weights(d, 2, zeros)
        else:
            trel.publish_weights(d, 1, _port_params())
            if bad:
                trel.publish_weights(d, 2, {k: torch.zeros_like(v) for k, v
                                            in _port_params().items()})

    # the zeroed candidate (the newest step) rolls back
    (jout, jd), (tout, td) = _reload_both(tmp_path / "rb", publish,
                                          seen={1})
    for key in ("swaps", "rollbacks", "rejected"):
        assert tout["stats"]["reload"][key] == jout["stats"]["reload"][key]
    assert tout["stats"]["reload"]["rollbacks"] == 1
    assert tout["stats"]["restarts"] == jout["stats"]["restarts"] == 1
    assert tout["stats"]["faults"][0]["kind"] == "CanaryRollback"
    assert tout["stats"]["faults"][0]["rolled_back"]
    assert _tokens(tout) == _tokens(jout)
    assert any(n.startswith("weights-00000002")
               for n in os.listdir(os.path.join(td, "quarantine")))
    # step 1 (the live weights): the canary agrees and promotes
    (jout, _), (tout, _) = _reload_both(
        tmp_path / "pr", lambda d, pkg: publish(d, pkg, bad=False))
    assert tout["stats"]["reload"]["swaps"] == \
        jout["stats"]["reload"]["swaps"] == 1
    assert tout["stats"]["restarts"] == jout["stats"]["restarts"] == 0
    assert [e["action"] for e in tout["stats"]["reload"]["events"]] == \
        [e["action"] for e in jout["stats"]["reload"]["events"]]
    assert _tokens(tout) == _tokens(jout)


def test_canary_keeps_one_tick_copy_and_promotes_in_place():
    _, _, tm = _models()
    eng = teng.PagedEngine(tm, device="cpu", **ENGINE)
    ptrs = {k: v.data_ptr() for k, v in eng.model.state_dict().items()}
    eng.begin_canary(_port_params(), slots=[0])
    canary = eng._canary_model
    with pytest.raises(RuntimeError, match="already active"):
        eng.begin_canary(_port_params(), slots=[0])
    summary = eng.end_canary(promote=True)
    assert summary["canary_slots"] == [0] and eng.weight_swaps == 1
    eng.begin_canary(_port_params(), slots=[1])
    assert eng._canary_model is canary          # one copy, one tick
    eng.end_canary(promote=False)
    assert {k: v.data_ptr() for k, v in eng.model.state_dict().items()} \
        == ptrs
    with pytest.raises(ValueError, match="every slot"):
        eng.begin_canary(_port_params(), slots=[0, 1, 2])
    with pytest.raises(RuntimeError, match="no canary"):
        eng.end_canary(promote=True)


def test_checkpointer_publishes_each_durable_save(tmp_path):
    """``--publish-weights``: a training run's saves reach a directory a
    reload manager watches, verified."""
    from distributed_deep_learning_tpu_torch.workloads import northstar

    data = tmp_path / "pub"
    os.environ["DDL_DATA_LIMIT"] = "48"
    try:
        northstar.main(["-d", "cpu", "-l", "1", "-s", "16", "-e", "2",
                        "-b", "8", "--checkpoint-dir",
                        str(tmp_path / "ck"), "--publish-weights",
                        str(data)])
    finally:
        del os.environ["DDL_DATA_LIMIT"]
    steps = sorted(int(n[8:16]) for n in os.listdir(data)
                   if n.endswith(".manifest.json"))
    assert steps == [1, 2] and trel.latest_published(str(data)) == 2
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        Checkpointer
    saved = torch.load(os.path.join(tmp_path / "ck", "ckpt-2.pt"),
                       weights_only=False)["params"]
    got = trel.load_verified(str(data), 2, saved)
    assert all(torch.equal(got[k], saved[k].cpu()) for k in saved)
    assert Checkpointer(tmp_path / "ck2", publish_dir=None).publish_dir \
        is None
    with pytest.raises(CheckpointCorruption):
        trel.load_verified(str(data), 7, saved)


@pytest.mark.parametrize("weight_dtype", ["int8", "bf16"])
def test_quantized_engine_swaps_and_canaries(weight_dtype, tmp_path):
    """A quantized engine takes full-precision publications: its
    ``params`` are the served weights dequantized under the model's own
    names, a swap quantizes before copying in place, and a canary of
    the same weights promotes with the same tokens."""
    _, _, tm = _models()
    eng = teng.PagedEngine(tm, device="cpu", weight_dtype=weight_dtype,
                           **ENGINE)
    assert list(eng.params) == list(tm.state_dict())
    ref = eng.run(_trace())
    ptrs = {k: v.data_ptr() for k, v in eng.model.state_dict().items()}
    eng.swap_params(_port_params())
    assert {k: v.data_ptr() for k, v in eng.model.state_dict().items()} \
        == ptrs
    trel.publish_weights(str(tmp_path), 1, _port_params())
    rm = trel.ReloadManager(str(tmp_path), canary_slots=1, canary_ticks=2,
                            min_compare=2)
    out = tsup.ServeSupervisor(eng, reload=rm).run(_trace())
    assert (rm.swaps, rm.rollbacks, rm.rejected) == (1, 0, 0)
    assert _tokens(out) == _tokens(ref)
