"""Tensor (Megatron) parallelism against the JAX package's rules and the
replicated model.

* The port's rules, mapped through ``load_flax_params``'s name table,
  split the same leaves on the same logical axis as JAX's
  ``param_specs(..., transformer_tp_rules())`` (and ``moe_param_rules``):
  each rank's JAX shard, carried across, is the port's shard.
* ``validate_divisibility`` raises JAX's message for the same leaf.
* On two spawned gloo ranks (``--mesh model=2``), the split ``CausalLM``
  (GQA, RoPE, the flash kernels' plain versions on the local heads),
  ``BertEncoder`` and the seq2seq model give the replicated model's
  logits, loss and gradients (gathered whole) within 1e-5, and so does
  the vocab-parallel fused cross-entropy (``CausalLM.loss``, and at a
  block that leaves each rank's last block padded).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_deep_learning_tpu.parallel import tensor_parallel as jtp
from distributed_deep_learning_tpu.runtime.mesh import build_mesh as jmesh
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models.moe import MoELM
from distributed_deep_learning_tpu_torch.models.transformer import (
    BertEncoder, CausalLM, Seq2SeqAdapter, TransformerSeq2Seq,
    load_flax_params)
from distributed_deep_learning_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy
from distributed_deep_learning_tpu_torch.parallel import \
    tensor_parallel as ttp
from distributed_deep_learning_tpu_torch.runtime.bootstrap import (
    host_store, hosted_env)
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 180.0
WORKLOADS = {"gpt": ["-l", "2", "-s", "128"],
             "bert": ["-l", "1", "-s", "128"],
             "transformer": ["-l", "1", "-s", "128"],
             "moe": ["-l", "2", "-s", "64"]}


def _jax_params(workload, argv):
    jcfg = jconfig.parse_args(argv, workload=workload)
    jspec = jget(workload)
    dataset = jspec.build_dataset(jcfg)
    params = jax.jit(jspec.build_model(jcfg, dataset).init)(
        jax.random.key(0), jspec.example_input(jcfg, dataset))["params"]
    return jspec, jcfg, dataset, jax.tree.map(np.asarray, params)


def _jax_shard(params, specs, axis, index, parts):
    """Rank ``index``'s shard of every leaf under JAX's specs."""
    def cut(leaf, spec):
        for d, name in enumerate(spec):
            if name == axis:
                n = leaf.shape[d] // parts
                leaf = np.take(leaf, range(index * n, (index + 1) * n), d)
        return leaf
    return jax.tree.map(cut, params, specs,
                        is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_rules_split_the_leaves_jax_splits(workload):
    argv = WORKLOADS[workload] + ["-d", "cpu"]
    jspec, jcfg, dataset, params = _jax_params(workload, argv)
    axis = "expert" if workload == "moe" else "model"
    jspecs = jtp.param_specs(params, jspec.tp_rules(jcfg))
    tcfg = tconfig.parse_args(argv, workload)
    tspec = tget(workload)
    model = tspec.build_model(tcfg, dataset)
    tspecs = ttp.param_specs(model, tspec.tp_rules(tcfg))
    whole = load_flax_params(params)
    assert set(whole) == set(dict(model.named_parameters()))
    assert {a for _, a in tspecs.values()} == {axis}
    split = [k for k, v in whole.items()
             if not torch.equal(load_flax_params(
                 _jax_shard(params, jspecs, axis, 0, 2))[k], v)]
    assert sorted(split) == sorted(tspecs), workload
    for index in range(2):
        want = load_flax_params(_jax_shard(params, jspecs, axis, index, 2))
        for k, v in whole.items():
            if k in tspecs:
                dim, _ = tspecs[k]
                n = v.shape[dim] // 2
                v = v.narrow(dim, index * n, n)
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
        # the JAX name of every port parameter
        flat = {"/".join(str(p.key) for p in kp)
                for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
        assert {ttp.flax_path(model, k) for k in whole} == flat


@pytest.mark.parametrize("argv,axis,size", [
    (["-l", "1", "-s", "64", "--kv-heads", "1"], "model", 2),
    (["-l", "1", "-s", "128"], "model", 4),
    (["-l", "1", "-s", "192"], "model", 2),
])
def test_divisibility_raises_jax_message(argv, axis, size):
    argv = argv + ["-d", "cpu"]
    jspec, jcfg, dataset, params = _jax_params("gpt", argv)
    mesh = jmesh({axis: size}, jax.devices()[:size])
    model = tget("gpt").build_model(tconfig.parse_args(argv, "gpt"),
                                    dataset)
    try:
        jtp.validate_divisibility(params, mesh, jspec.tp_rules(jcfg))
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        ttp.validate_divisibility(model, {axis: size},
                                  ttp.transformer_tp_rules())
        return
    with pytest.raises(ValueError) as got:
        ttp.validate_divisibility(model, {axis: size},
                                  ttp.transformer_tp_rules())
    assert str(got.value) == want


# --- the split forward and backward on two ranks ------------------------------

#: one rank: each model split over a {"model": 2} mesh, its outputs, loss
#: and whole gradients saved
RANK = r"""
import sys
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.runtime.bootstrap import join
from distributed_deep_learning_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy
from distributed_deep_learning_tpu_torch.parallel.shards import whole
from distributed_deep_learning_tpu_torch.parallel.tensor_parallel import (
    apply_tensor_parallel, transformer_tp_rules)
from distributed_deep_learning_tpu_torch.runtime.mesh import (
    MeshLayout, build_mesh)
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy

rank, world, blob = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
join("gloo", rank, world)  # the launcher's store
layout = MeshLayout.of(build_mesh({"model": world}, "cpu", world))
out = {}
for name, case in torch.load(blob, weights_only=False).items():
    model = case["model"]
    apply_tensor_parallel(model, transformer_tp_rules(), layout)
    model.train()
    logits = model(case["x"])
    loss = TokenCrossEntropy()(logits, case["y"])
    res = {"logits": logits.detach(), "loss": loss.detach()}
    if case.get("fused"):
        model.with_logits = False
        h = model(case["x"])
        fused = model.loss(h[:, :-1], case["x"][:, 1:])
        res["fused"] = fused.detach()
        loss = loss + fused
    if "fused_block" in case:
        block, t = case["fused_block"]
        tok = model.tok
        fused = fused_linear_cross_entropy(
            h[:, :-1], tok.weight, t, -1, block, group=tok.group,
            vocab_start=tok.vocab_start)
        res["fused_block"] = fused.detach()
        loss = loss + fused
    loss.backward()
    res["grads"] = {k: whole(p, p.grad) for k, p in model.named_parameters()}
    res["heads"] = [(m.num_heads, m.kv_heads) for m in model.modules()
                    if hasattr(m, "kv_heads")]
    out[name] = res
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


def _cases():
    g = torch.Generator().manual_seed(0)
    V = 62
    x = torch.randint(1, V, (4, 12), generator=g)
    x[1, 9:] = 0
    y = torch.where(torch.rand(4, 12, generator=g) < 0.5, x.roll(-1, 1), 0)
    gpt = CausalLM(vocab_size=V, num_layers=2, d_model=32, num_heads=4,
                   num_kv_heads=2, mlp_dim=64, max_len=16, pos_embedding="rope",
                   with_logits=True, attention="flash")
    bert = BertEncoder(vocab_size=V, num_layers=1, d_model=32, num_heads=2,
                       mlp_dim=64, max_len=16)
    s2s = Seq2SeqAdapter(TransformerSeq2Seq(vocab_size=V, num_layers=1,
                                            d_model=32, num_heads=2,
                                            mlp_dim=64, max_len=16), 6)
    cases = {}
    for name, model in (("gpt", gpt), ("bert", bert), ("seq2seq", s2s)):
        model.reset_parameters(g)
        cases[name] = {"model": model, "x": x, "y": y}
    cases["seq2seq"]["y"] = y[:, 6:]
    cases["gpt"]["fused"] = True
    # 31 rows a rank in blocks of 8: each rank's last block is padded, and
    # ids 9-52 hold targets on both sides of the ranks' boundary at 31
    cases["gpt"]["fused_block"] = (8, (torch.arange(44) + 9).view(4, 11))
    return cases


def _spawn(blob):
    store = host_store()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **hosted_env(store))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "2", str(blob)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(f"{blob}.{r}") for r in range(2)]


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    cases = _cases()
    blob = tmp_path_factory.mktemp("tp") / "cases.pt"
    torch.save(cases, blob)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn, blob)
        want = {}
        for name, case in cases.items():
            model = case["model"].train()
            logits = model(case["x"])
            loss = TokenCrossEntropy()(logits, case["y"])
            res = {"logits": logits.detach(), "loss": loss.detach()}
            if case.get("fused"):
                model.with_logits = False
                h = model(case["x"])
                fused = model.loss(h[:, :-1], case["x"][:, 1:])
                res["fused"] = fused.detach()
                loss = loss + fused
            if "fused_block" in case:
                block, t = case["fused_block"]
                fused = fused_linear_cross_entropy(
                    h[:, :-1], model.tok.weight, t, -1, block)
                res["fused_block"] = fused.detach()
                loss = loss + fused
            loss.backward()
            res["grads"] = {k: p.grad for k, p in model.named_parameters()}
            want[name] = res
        return ranks.result(), want


@pytest.mark.parametrize("name", ["gpt", "bert", "seq2seq"])
def test_split_model_matches_replicated(name, split_runs):
    ranks, want = split_runs
    ref = want[name]
    for r in ranks:
        got = r[name]
        scale = float(ref["logits"].abs().max())
        torch.testing.assert_close(got["logits"], ref["logits"], rtol=0,
                                   atol=1e-5 * scale)
        torch.testing.assert_close(got["loss"], ref["loss"], rtol=1e-5,
                                   atol=0)
        if "fused" in ref:
            torch.testing.assert_close(got["fused"], ref["fused"],
                                       rtol=1e-5, atol=0)
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        for k, g in ref["grads"].items():
            torch.testing.assert_close(got["grads"][k], g, rtol=0,
                                       atol=1e-5 * top, msg=k)
    # the attention ran on this rank's heads: H/2, and GQA's Hkv/2
    heads = {"gpt": (2, 1), "bert": (1, 1), "seq2seq": (1, 1)}[name]
    assert set(ranks[0][name]["heads"]) == {heads}


def test_vocab_parallel_ce_with_padded_blocks(split_runs):
    """The vocab-parallel fused cross-entropy where a rank's rows are not
    a multiple of the block: a target just past a rank's rows is not
    picked from its padded last block."""
    ranks, want = split_runs
    ref = want["gpt"]["fused_block"]
    assert torch.isfinite(ref) and float(ref) < 10
    for r in ranks:
        torch.testing.assert_close(r["gpt"]["fused_block"], ref, rtol=1e-5,
                                   atol=0)


def test_moe_rules_leave_the_router_replicated():
    model = MoELM(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
                  mlp_dim=64, num_experts=4)
    specs = ttp.param_specs(model, tget("moe").tp_rules(None))
    assert sorted(specs) == ["layers.1.moe.w_in", "layers.1.moe.w_out"]
    assert all(v == (0, "expert") for v in specs.values())
