"""The explicit collectives of ``parallel/collectives.py`` against the JAX
package's: the wire formats equal JAX's exactly (values at exact halves
included); on four spawned gloo ranks the ring all-gather and
reduce-scatter equal the plain collectives and JAX's ``shard_map`` ones
bit for bit, as ``gather_matmul`` does; the analytic wire bytes are
JAX's; and through the CLI on ``--mesh data=2,fsdp=2``, the explicit
FSDP step with ``method="none"`` trains as FSDP2's ``--zero fsdp`` does
(1e-5), and ``--comm int8 --comm-overlap`` follows JAX's
``make_fsdp_step_fns`` over 3 steps within one quantization step, its
residuals too.  Every rank-side case runs in one spawn of four ranks."""

import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_deep_learning_tpu.parallel import collectives as jcoll
from distributed_deep_learning_tpu.runtime.shmap import shard_map
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.parallel import collectives as coll
from distributed_deep_learning_tpu_torch.runtime.bootstrap import (
    host_store, hosted_env)
from test_torch_zero import check_history, jax_init
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
S = 4
MESH = ["-m", "data", "-r", "4", "-d", "cpu", "-e", "1", "--mesh",
        "data=2,fsdp=2", "--zero", "fsdp"]
GPT = MESH + ["-l", "2", "-s", "64", "-b", "8"]
#: wide enough that the kernels are split (>= 2^14 entries); SGD makes a
#: parameter's gap the gradients' (a step of Adam is a sign where g ~ 0)
MLP = MESH + ["-l", "2", "-s", "512", "-b", "16", "--optimizer", "sgd",
              "--lr", "0.05"]
LIMIT = "96"


def blocks(seed: int = 3) -> np.ndarray:
    """Exact data: small integers, so every sum is exact in f32."""
    return np.random.default_rng(seed).integers(-8, 9, (S * 4, 16)) \
        .astype(np.float32)


def matmul_operands():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((S * 4, 8)).astype(np.float32),
            rng.standard_normal((8, 6)).astype(np.float32))


#: one rank: the ring/plain collectives on its blocks, then the CLI cases
#: (a case may train the explicit FSDP with method "none")
RANK = r"""
import contextlib, io, os, sys
import numpy as np
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.runtime.bootstrap import join
from distributed_deep_learning_tpu_torch.parallel import collectives as coll
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    whole_state_dict
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec

rank, blob = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
join("gloo", rank, 4)  # the launcher's store
spec = torch.load(blob, weights_only=False)
g = dist.group.WORLD
x = torch.from_numpy(spec["blocks"])
a, b = (torch.from_numpy(t) for t in spec["matmul"])
ops = {}
for method in ("none", "bf16", "int8"):
    for overlap in (False, True):
        key = f"{method}_{int(overlap)}"
        ops["ag_" + key] = coll.all_gather(x[rank * 4:(rank + 1) * 4], g,
                                           method=method, overlap=overlap)
        ops["rs_" + key] = coll.reduce_scatter(x * (1.0 + rank), g,
                                               method=method, overlap=overlap)
        ops["mm_" + key] = coll.gather_matmul(a[rank * 4:(rank + 1) * 4], b,
                                              g, method=method,
                                              overlap=overlap)
out = {"ops": ops}
real = tbase.train_setup
for name, case in spec["cases"].items():
    prune = case.get("prune")
    if prune and rank == 0:            # an interrupted run's directory
        directory, last = prune
        for f in os.listdir(directory):
            stem = f.split(".")[0]
            if "-" in stem and stem.split("-")[-1].isdigit() and \
                    int(stem.split("-")[-1]) > last:
                os.remove(os.path.join(directory, f))
    dist.barrier()
    def setup(*args, _force=case.get("force_none"), **kw):
        got = real(*args, **kw)
        if _force:
            got[0].comm.method = "none"
        return got
    tbase.train_setup = setup
    cfg = tconfig.parse_args(case["argv"], case["workload"])
    with contextlib.redirect_stdout(io.StringIO()):
        state, hist = tbase.run_workload(get_spec(case["workload"]), cfg,
                                         init_state_dict=case["init"])
    out[name] = {
        "hist": [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist],
        "params": whole_state_dict(state.model),
        "residual": {k: v.clone() for k, v in
                     (state.comm_residual or {}).items()},
        "wire": state.comm.wire_stats() if hasattr(state.comm, "wire_stats")
        else None}
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


def run_ranks(spec: dict, tmp: Path) -> list:
    blob = tmp / "spec.pt"
    torch.save(spec, blob)
    store = host_store()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **hosted_env(store),
               DDL_DATA_LIMIT=LIMIT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(blob)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(S)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(f"{blob}.{r}") for r in range(S)]


def jax_run(workload: str, argv: list):
    """The JAX CLI's final state and phase history."""
    os.environ["DDL_DATA_LIMIT"] = LIMIT
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state, hist = jbase.run_workload(
                jget(workload), jconfig.parse_args(argv, workload=workload))
    finally:
        del os.environ["DDL_DATA_LIMIT"]
    return state, [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist]


def jax_ops() -> dict:
    """JAX's ring collectives on a 4-device ``data`` axis, on the same
    blocks (one program a method)."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("data",))
    x = jnp.asarray(blocks())
    a, b = (jnp.asarray(t) for t in matmul_operands())
    out = {}
    for method in ("none", "bf16", "int8"):
        ring = dict(size=S, method=method, overlap=True)

        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P("data"), P(), P("data"), P()),
                 out_specs=(P(), P("data"), P()), check_vma=False)
        def run(blk, full, ablk, y):
            c = full * (1.0 + jax.lax.axis_index("data"))
            return (jcoll.all_gather(blk, "data", **ring),
                    jcoll.reduce_scatter(c, "data", **ring),
                    jcoll.gather_matmul(ablk, y, "data", **ring))

        ag, rs, mm = run(x, x, a, b)
        out[f"ag_{method}_1"] = np.asarray(ag)
        out[f"rs_{method}_1"] = np.asarray(rs).reshape(S, 4, 16)
        out[f"mm_{method}_1"] = np.asarray(mm)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    gpt_init, mlp_init = jax_init("gpt", GPT), jax_init("mlp", MLP)
    comm = ["--comm", "int8", "--comm-overlap"]
    ck = {z: ["--checkpoint-dir", str(tmp / z), "--checkpoint-every", "1"]
          for z in ("fsdp2", "comm")}
    cases = {
        "fsdp2": {"workload": "gpt", "argv": GPT + ck["fsdp2"],
                  "init": gpt_init},
        "explicit_none": {"workload": "gpt", "init": gpt_init,
                          "argv": GPT + ["--comm", "bf16"],
                          "force_none": True},
        "gpt_int8": {"workload": "gpt", "argv": GPT + comm,
                     "init": gpt_init},
        "mlp_int8": {"workload": "mlp", "argv": MLP + comm,
                     "init": mlp_init},
        "comm_whole": {"workload": "gpt", "argv": GPT + comm + ck["comm"],
                       "init": gpt_init},
        "comm_resumed": {"workload": "gpt", "init": gpt_init,
                         "argv": GPT + comm + ck["comm"] + ["--resume"],
                         "prune": (str(tmp / "comm"), 2)},
    }
    spec = {"blocks": blocks(), "matmul": matmul_operands(),
            "cases": cases}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, spec, tmp)
        want = {"ops": jax_ops(),
                "gpt_int8": jax_run("gpt", cases["gpt_int8"]["argv"]),
                "mlp_int8": jax_run("mlp", cases["mlp_int8"]["argv"])}
        return ranks.result(), want, tmp


# --- wire formats: one process ---------------------------------------------

def halves() -> np.ndarray:
    """amax 127 (scale exactly 1), values at exact halves, and noise."""
    rng = np.random.default_rng(7)
    x = np.concatenate([[127.0, -126.5, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                         3.5, 64.5, -64.5],
                        rng.uniform(-127, 127, 53)]).astype(np.float32)
    return x.reshape(8, 8)


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_wire_formats_equal_jax(method):
    x = halves()
    res = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)
    wire, scale = coll.quantize(torch.from_numpy(x), method)
    jwire, jscale = jcoll.quantize(jnp.asarray(x), method)
    np.testing.assert_array_equal(wire.float().numpy(),
                                  np.asarray(jwire, np.float32))
    assert (scale is None) == (jscale is None)
    if scale is not None:
        assert float(scale) == float(jscale)
    np.testing.assert_array_equal(
        coll.dequantize(wire, scale, method, torch.float32).numpy(),
        np.asarray(jcoll.dequantize(jwire, jscale, method, jnp.float32)))
    w, s, r = coll.ef_quantize(torch.from_numpy(x), torch.from_numpy(res),
                               method)
    jw, js, jr = jcoll.ef_quantize(jnp.asarray(x), jnp.asarray(res), method)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw, np.float32))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_int8_rounds_half_to_even():
    wire, scale = coll.quantize(torch.from_numpy(halves()), "int8")
    assert float(scale) == 1.0
    assert wire.flatten()[:11].tolist() == [127, -126, 0, 2, 2, 0, -2, -2,
                                            4, 64, -64]


@pytest.mark.parametrize("op,method,shape,size", [
    ("all_gather", "none", (64, 32), 4), ("all_gather", "int8", (64, 32), 4),
    ("reduce_scatter", "bf16", (256, 48), 8),
    ("reduce_scatter", "int8", (256, 48), 2),
    ("kv_migrate", "int8", (4, 16, 8), 2),
    ("kv_migrate", "none", (4, 16, 8), 2)])
def test_wire_bytes_equal_jax(op, method, shape, size):
    assert coll.wire_bytes(op, method, shape, size) == \
        jcoll.wire_bytes(op, method, shape, size)


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_fsdp_wire_stats_equal_jax(method):
    shapes = [(512, 48), (512, 512), (7, 512), (100,)]
    dims = [0, 0, 1, -1]
    tree = {f"l{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
    dtree = {f"l{i}": d for i, d in enumerate(dims)}
    assert coll.fsdp_wire_stats(shapes, dims, 4, method) == \
        jcoll.fsdp_wire_stats(tree, dtree, 4, method)
    assert coll.tree_wire_bytes("all_gather", method, list(tree.values()),
                                4) == \
        jcoll.tree_wire_bytes("all_gather", method, tree, 4)


# --- four ranks -------------------------------------------------------------

@pytest.mark.parametrize("op", ["ag", "rs", "mm"])
@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_rings_equal_plain_and_jax(op, method, runs):
    ranks, want, _ = runs
    for rank, r in enumerate(ranks):
        ring = r["ops"][f"{op}_{method}_1"].numpy()
        plain = r["ops"][f"{op}_{method}_0"].numpy()
        jax_ = want["ops"][f"{op}_{method}_1"]
        if op == "rs":
            jax_ = jax_[rank]
        if op == "mm":       # products round as their operands' order does
            np.testing.assert_allclose(ring, plain, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(ring, jax_, rtol=1e-5, atol=1e-5)
            continue
        np.testing.assert_array_equal(ring, plain)
        np.testing.assert_array_equal(ring, jax_)


def test_explicit_fsdp_none_trains_as_fsdp2(runs):
    ranks, _, _ = runs
    for r in ranks:
        check_history(r["explicit_none"]["hist"], r["fsdp2"]["hist"],
                      "explicit none")


def test_explicit_fsdp_wire_stats_are_jax_rule(runs):
    ranks, want, _ = runs
    stats = ranks[0]["mlp_int8"]["wire"]
    state = want["mlp_int8"][0]
    from distributed_deep_learning_tpu.parallel.zero import leaf_shard_spec

    dims = jax.tree.map(lambda p: next(
        (i for i, e in enumerate(leaf_shard_spec(p, 2)) if e is not None),
        -1), state.params)
    assert stats == jcoll.fsdp_wire_stats(state.params, dims, 2, "int8")


def _numpy(sd: dict) -> dict:
    return {k: torch.as_tensor(v).numpy() for k, v in sd.items()}


def _step_tol(res) -> dict:
    """One quantization step a leaf: |residual| <= scale / 2."""
    return {k: 2.0 * float(np.abs(v).max()) + 1e-7 for k, v in res.items()}


def test_int8_overlap_follows_jax_fsdp_step(runs):
    ranks, want, _ = runs
    state, hist = want["mlp_int8"]
    check_history(ranks[0]["mlp_int8"]["hist"], hist, "mlp int8",
                  rtol=1e-4)
    jparams = _numpy(tmlp.load_flax_variables(
        {"params": jax.tree.map(np.asarray, state.params)}))
    for rank, r in enumerate(ranks):
        jres = _numpy(tmlp.load_flax_variables({"params": jax.tree.map(
            lambda a: np.asarray(a)[rank], state.comm_residual)}))
        step = _step_tol(jres)
        for k, v in jres.items():
            got = r["mlp_int8"]["residual"][k].numpy()
            assert np.abs(got - v).max() <= step[k], k
            # a parameter moves by lr x the mean of the ranks' steps
            gap = np.abs(r["mlp_int8"]["params"][k].numpy() - jparams[k])
            assert gap.max() <= 3 * 0.05 * step[k] + 1e-6, k
    assert any(np.abs(v.numpy()).max() > 0
               for v in ranks[0]["mlp_int8"]["residual"].values())


def test_gpt_int8_overlap_history_follows_jax_cli(runs):
    ranks, want, _ = runs
    check_history(ranks[0]["gpt_int8"]["hist"], want["gpt_int8"][1],
                  "gpt int8", rtol=1e-4)
    for r in ranks[1:]:
        assert r["gpt_int8"]["hist"] == ranks[0]["gpt_int8"]["hist"]


def test_comm_resume_is_bit_identical_and_saves_fsdps_leaves(runs):
    """A ``--comm int8`` checkpoint holds the whole leaves of a ``--zero
    fsdp`` one, plus every rank's residual on a leading axis; a mid-epoch
    resume restores each rank's own and trains on bit for bit."""
    ranks, _, tmp = runs
    for r in ranks:
        whole, resumed = r["comm_whole"], r["comm_resumed"]
        assert resumed["hist"] == whole["hist"]
        for part in ("params", "residual"):
            for k, v in whole[part].items():
                torch.testing.assert_close(resumed[part][k], v, rtol=0,
                                           atol=0, msg=k)

    def manifest(name):
        last = max((tmp / name).glob("manifest-*.json"),
                   key=lambda p: int(p.stem.split("-")[1]))
        return json.loads(last.read_text())["leaves"]

    fsdp, comm = manifest("fsdp2"), manifest("comm")
    residual = {k for k in comm if "comm_residual" in k}
    assert residual
    assert {k: (v.get("shape"), v.get("dtype")) for k, v in comm.items()
            if k not in residual} == \
        {k: (v.get("shape"), v.get("dtype")) for k, v in fsdp.items()}
    for k in residual:
        assert comm[k]["shape"][0] == S
