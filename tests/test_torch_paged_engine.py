"""The port's PagedEngine against the JAX PagedEngine on the same trace.

Both engines serve the same seeded ``make_load`` trace (a shared prefix
that ends mid-block, so prefix hits AND copy-on-write happen) on the same
weights, carried across with ``load_flax_params``; the port runs on the
CPU, where its decode attention is the kernel's plain version.  Greedy
tokens must be identical and the paging counters equal, also on a
sliding-window model whose window is shorter than the prompts.  Also: the
unported options raise, and the port imports nothing of JAX.
"""

import ast
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import load as jload
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve import load as tload

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=64)
ENGINE = dict(max_slots=4, kv_block_size=8, prefill_chunk=8, max_len=64)
LOAD = dict(n_requests=10, arrival="poisson", rate=1.5,
            prompt_short=(3, 10), prompt_long=(14, 24), long_frac=0.3,
            shared_prefix_len=12, shared_frac=0.6, new_tokens=(2, 10))


@functools.lru_cache(maxsize=None)
def _models(bf16=False, **kw):
    """The JAX model, its params and the port's model on them; ``bf16``:
    both compute in bf16 (f32 parameters)."""
    jm = jtr.CausalLM(**{**MODEL, **kw},
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
    params = jm.init(jax.random.key(11), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**{**MODEL, **kw},
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm


def _traces(seed=0, pad_inside=False):
    jt = jload.make_load(jload.LoadSpec(**LOAD), MODEL["vocab_size"], seed)
    tt = tload.make_load(tload.LoadSpec(**LOAD), MODEL["vocab_size"], seed)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.uid, a.max_new_tokens, a.arrival_tick) == \
            (b.uid, b.max_new_tokens, b.arrival_tick)
    if pad_inside:
        # pad id 0 inside two prompts: masked through cached_valid (JAX)
        # and the valid pool (port)
        for r in (jt, tt):
            r[1].prompt[2] = 0
            r[4].prompt[len(r[4].prompt) // 2] = 0
    return jt, tt


def _serve_both(pad_inside=False, **model_kw):
    jm, params, tm = _models(**model_kw)
    jt, tt = _traces(pad_inside=pad_inside)
    jout = jeng.PagedEngine(jm, params, **ENGINE).run(jt)
    tout = teng.PagedEngine(tm, device="cpu", **ENGINE).run(tt)
    return jout, tout


CASES = {"shared_prefix": {}, "pad_inside_prompt": {"pad_inside": True},
         "rope_gqa": {"pos_embedding": "rope", "num_kv_heads": 2},
         # a bf16-compute model: pools in bf16, as the JAX pools take the
         # decode model's cache dtype
         "bf16": {"bf16": True},
         # prompts of up to 36 tokens against a 6-position window: the
         # chunk prefill's mask and the decode attention's lower bound
         "window": {"attention_window": 6}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine(case):
    jout, tout = _serve_both(**CASES[case])
    assert jout["errors"] == tout["errors"] == {}
    assert sorted(jout["results"]) == sorted(tout["results"])
    for uid, toks in jout["results"].items():
        np.testing.assert_array_equal(tout["results"][uid], toks,
                                      err_msg=f"request {uid}")
    js, ts = jout["stats"], tout["stats"]
    for key in ("prefill_chunks", "decode_ticks", "generated_tokens"):
        assert ts[key] == js[key], key
    for key in ("prefix_hit_rate", "cow_copies", "blocks_peak_in_use",
                "indexed_blocks"):
        assert ts["paged"][key] == js["paged"][key], key
    assert ts["paged"]["prefix_hit_rate"] > 0
    assert ts["paged"]["cow_copies"] > 0
    assert ts["paged_decode_launches"] == 0     # CPU: the plain version
    assert ts["kv_cache_bytes"] > 0


def test_bench_record_on_cpu():
    rec = tbench.paged_serving_bench(
        device="cpu", model_kw=MODEL, load_kw=LOAD, max_slots=4,
        kv_block_size=8, prefill_chunk=8)
    assert rec["errors"] == 0
    pe = rec["paged_engine"]
    assert pe["prefix_hit_rate"] > 0 and pe["decode_ticks"] > 0
    for uid, n in rec["budgets"].items():
        toks = rec["results"][uid]
        assert len(toks) == n
        assert all(1 <= t < MODEL["vocab_size"] for t in toks)
    plain = tbench.paged_serving_bench(
        device="cpu", model_kw=MODEL, load_kw=LOAD, max_slots=4,
        kv_block_size=8, prefill_chunk=8, decode_attention="plain")
    assert plain["results"] == rec["results"]


def test_serve_cli_prints_one_record(capsys):
    from distributed_deep_learning_tpu_torch.serve.__main__ import main

    rc = main(["--paged", "--device", "cpu", "--requests", "4",
               "--layers", "1", "--d-model", "32", "--heads", "4",
               "--mlp-dim", "64", "--vocab", "61", "--max-len", "64",
               "--kv-block-size", "8", "--prefill-chunk", "8",
               "--prompt-max", "20", "--new-max", "8",
               "--shared-prefix-len", "8"])
    assert rc == 0
    import json
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["errors"] == 0 and "results" not in rec
    assert rec["engine_v1"]["errors"] == 0 and "results_v1" not in rec
    # without --paged: the slot engine against generate()
    rc = main(["--device", "cpu", "--requests", "4", "--max-slots", "2",
               "--prompt-min", "2", "--prompt-max", "8", "--new-min", "2",
               "--new-max", "6", "--layers", "1", "--d-model", "32",
               "--heads", "2", "--mlp-dim", "64", "--vocab", "64",
               "--max-len", "32", "--stagger", "1"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert rec["errors"] == 0 and "results" not in rec
    assert rec["engine"]["decode_captures"] == 0
    assert rec["engine"]["tokens_per_sec"] > 0
    assert rec["naive"]["tokens_per_sec"] > 0 and rec["speedup"] is not None
    assert 0 < rec["engine"]["mean_slot_occupancy"] <= 2


@pytest.mark.parametrize("kw,match", [
    ({"preempt": True}, "spill_dir requires preempt"),
    ({"migrate": "device"}, "migrate must be"),
])
def test_unported_options_raise(kw, match):
    """Preemption and the device spill construct (item 13 ported them);
    their misuses raise with JAX's messages."""
    _, _, tm = _models()
    eng = teng.PagedEngine(tm, device="cpu", **kw)
    assert eng._preempt == kw.get("preempt", False)
    assert eng.migrate_kind == kw.get("migrate", "host")
    bad = ({"spill_dir": "d"} if "preempt" in kw else {"migrate": "disk"})
    with pytest.raises(ValueError, match=match):
        teng.PagedEngine(tm, device="cpu", **bad)


def test_window_and_telemetry_raise():
    """A windowed model is served (its window on every path); telemetry
    and an unknown decode attention are refused."""
    win = ttr.CausalLM(**MODEL, attention_window=8)
    assert teng.PagedEngine(win, device="cpu").window == 8
    _, _, tm = _models()
    eng = teng.PagedEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="telemetry"):
        eng.run([], telemetry=object())
    with pytest.raises(ValueError, match="decode_attention"):
        teng.PagedEngine(tm, device="cpu", decode_attention="flash")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: nothing to refuse")
    _, _, tm = _models()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        teng.PagedEngine(tm, **ENGINE)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tbench.build_model(0, **MODEL)


# --- the port imports nothing of JAX ----------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributed_deep_learning_tpu")


def _port_files():
    return sorted((ROOT / "distributed_deep_learning_tpu_torch").rglob(
        "*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import distributed_deep_learning_tpu_torch\n"
            "import distributed_deep_learning_tpu_torch.serve.bench\n"
            "import distributed_deep_learning_tpu_torch.serve.cache\n"
            "import distributed_deep_learning_tpu_torch.serve.graphs\n"
            "import distributed_deep_learning_tpu_torch.serve.quant\n"
            "import distributed_deep_learning_tpu_torch.serve.spec\n"
            "import distributed_deep_learning_tpu_torch.ops.fused_ce\n"
            "import distributed_deep_learning_tpu_torch.train.state\n"
            "import distributed_deep_learning_tpu_torch.serve.__main__\n"
            "import distributed_deep_learning_tpu_torch.__main__\n"
            "import distributed_deep_learning_tpu_torch.workloads.northstar\n"
            "import distributed_deep_learning_tpu_torch.ops.attention\n"
            "import distributed_deep_learning_tpu_torch.data.loader\n"
            "import distributed_deep_learning_tpu_torch.train.loop\n"
            "import distributed_deep_learning_tpu_torch.native\n"
            "import distributed_deep_learning_tpu_torch.workloads.mlp\n"
            "import distributed_deep_learning_tpu_torch.workloads.cnn\n"
            "import distributed_deep_learning_tpu_torch.workloads.lstm\n"
            "import distributed_deep_learning_tpu_torch.workloads.mnist\n"
            "import distributed_deep_learning_tpu_torch.data.mnist\n"
            "import distributed_deep_learning_tpu_torch.utils.torch_migrate\n"
            "import distributed_deep_learning_tpu_torch.models.resnet\n"
            "import distributed_deep_learning_tpu_torch.data.packed\n"
            "import distributed_deep_learning_tpu_torch.data.imagefolder\n"
            "import distributed_deep_learning_tpu_torch.parallel.partition\n"
            "import distributed_deep_learning_tpu_torch.parallel.staging\n"
            "import distributed_deep_learning_tpu_torch.parallel.mpmd\n"
            "import distributed_deep_learning_tpu_torch.parallel."
            "spmd_pipeline\n"
            "import distributed_deep_learning_tpu_torch.parallel."
            "pipeline_transformer\n"
            "import distributed_deep_learning_tpu_torch.models.pipelined_lm\n"
            "import distributed_deep_learning_tpu_torch.models.moe\n"
            "import distributed_deep_learning_tpu_torch.serve.fleet\n"
            "import distributed_deep_learning_tpu_torch.serve.reload\n"
            "import distributed_deep_learning_tpu_torch.serve.autoscaler\n"
            "import distributed_deep_learning_tpu_torch.utils.chaos\n"
            "from distributed_deep_learning_tpu_torch.workloads import "
            "get_spec\n"
            "for w in ('resnet', 'transformer', 'bert', 'moe', 'gpt'):\n"
            "    get_spec(w)\n"
            "distributed_deep_learning_tpu_torch.native.get_lib()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "# the card's installation has no Pillow: only an ImageFolder\n"
            "# decode may import it\n"
            "assert 'PIL' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
