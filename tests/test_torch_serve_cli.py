"""The training CLI's post-train serving (``--generate``, ``--serve``,
``--serve --paged``) against the JAX package's, on the CPU.

Both packages train the same 3-step ``gpt`` run from the JAX init (the
port through ``init_state_dict``) once for the file (the serving flags
change nothing before the post-train hook), then each serving case runs
that hook on its flags: the logged ``generate``
lines must be equal, and the ``serve:``/``serve(paged):`` lines must agree
on everything but speed and the compile counts, which the port logs as
``decode captures=N`` (0 on the CPU).  Also: the port's serve trace is
JAX's for the same seed and config, an impossible ``--generate`` is
refused before training, and the serving flags parse and are checked as
the JAX CLI's are: among them the speculation and quantization flags
(``--draft``, ``--spec-k``, ``--kv-dtype``, ``--weight-dtype``), on the
training CLI and on the serving bench's.
"""

import dataclasses
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import northstar as tns

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ARGV = ["-l", "2", "-s", "32", "-e", "1", "-b", "8", "-d", "cpu"]


def _jax_init(argv):
    cfg = jconfig.parse_args(argv, workload="gpt")
    dataset = jns.GPT_SPEC.build_dataset(cfg)
    params = jax.jit(jns.GPT_SPEC.build_model(cfg, dataset).init)(
        jax.random.key(cfg.seed),
        jnp.zeros((1, dataset.features.shape[1]), jnp.int32))["params"]
    return ttr.load_flax_params(jax.tree.map(np.asarray, params))


def _lines(text, prefix):
    return [ln.strip('"') for ln in text.splitlines()
            if ln.startswith(f'"{prefix}')]


#: the parts of a serve line the two packages must share: everything up
#: to the speed, and after it what the engines counted
_SERVE = re.compile(r"(serve(?:\(paged\))?: \d+ requests, \d+ tokens) at "
                    r"[\d.]+ tok/s, (.*?)(?:, compiles .*|, decode "
                    r"captures=.*)$")


SPEC_FLAGS = ["--draft", "1", "--spec-k", "3"]
QUANT_FLAGS = ["--kv-dtype", "int8", "--weight-dtype", "int8"]


@pytest.fixture(scope="module")
def trained():
    """The 3-step run through each package's runner, once: ``{package:
    (state, dataset)}`` as the runner hands them to its ``post_train``
    hook (JAX's CLI and the port's from JAX's init)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DDL_DATA_LIMIT", "35")
    argv = ARGV + ["--generate", "4"]
    out = {}
    try:
        for name, base, ns, config, kw in (
                ("jax", jbase, jns, jconfig, {}),
                ("port", tbase, tns, tconfig,
                 {"init_state_dict": _jax_init(argv)})):
            def keep(cfg, state, logger, dataset, _name=name):
                out[_name] = (state, dataset)

            base.run_workload(dataclasses.replace(ns.GPT_SPEC,
                                                  post_train=keep),
                              config.parse_args(argv, "gpt"), **kw)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("serve", [
    ["--serve"], ["--serve", "--paged"], ["--serve", "--paged", *SPEC_FLAGS],
    ["--serve", "--paged", *QUANT_FLAGS],
    ["--serve", "--kv-dtype", "bf16", "--weight-dtype", "int8"]],
    ids=["slot", "paged", "paged_spec", "paged_int8", "slot_quant"])
def test_post_train_serving_matches_jax(serve, trained, monkeypatch,
                                        capsys):
    from distributed_deep_learning_tpu.utils.logging import \
        PhaseLogger as JLogger
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger as TLogger

    monkeypatch.setenv("DDL_DATA_LIMIT", "35")
    argv = ARGV + ["--generate", "4", *serve]
    capsys.readouterr()
    jns.GPT_SPEC.post_train(jconfig.parse_args(argv, "gpt"),
                            *trained["jax"][:1], JLogger(),
                            trained["jax"][1])
    theirs = capsys.readouterr().out
    tns.GPT_SPEC.post_train(tconfig.parse_args(argv, "gpt"),
                            *trained["port"][:1], TLogger(),
                            trained["port"][1])
    mine = capsys.readouterr().out
    gen = _lines(mine, "generate ")
    assert len(gen) == 2 and gen == _lines(theirs, "generate ")
    assert all(len(re.search(r"continuation=\[(.*)\]", ln).group(1)
                     .split(",")) == 4 for ln in gen)
    tag = "serve(paged): " if "--paged" in serve else "serve: "
    (line,), (ref,) = _lines(mine, tag), _lines(theirs, tag)
    assert _SERVE.match(line).groups() == _SERVE.match(ref).groups(), \
        (line, ref)
    assert "decode captures=0" in line
    if "--draft" in serve:
        # the same proposals accepted: the acceptance rates are equal
        assert re.search(r"spec acceptance [\d.]+", line).group() == \
            re.search(r"spec acceptance [\d.]+", ref).group()
        assert "draft captures=0 verify captures=0" in line    # CPU
        parsed = chip_smoke._one(chip_smoke._SERVE_SPEC_LINE, mine, tag)
        assert parsed[0] == chip_smoke.SERVE_REQUESTS
    elif "--paged" in serve:
        assert line.endswith("launches=0")             # the plain decode
    # chip_smoke.py's phase 15 reads these lines on the card
    assert len(chip_smoke._GENERATE_LINE.findall(mine)) == 2
    pattern = chip_smoke._SERVE_PAGED_LINE if "--paged" in serve \
        else chip_smoke._SERVE_SLOT_LINE
    parsed = chip_smoke._one(pattern, mine, tag)
    assert parsed[0] == chip_smoke.SERVE_REQUESTS


def _capture(pkg_bench, runner, monkeypatch):
    """Replace ``pkg_bench.runner`` with one that records the trace and
    the engine arguments it is given, then stops the caller."""
    seen = []

    def fake(model, *args, **kw):
        trace = args[-1]    # JAX: (model, params, trace); port: (model, trace)
        seen.append(([(r.uid, r.prompt.tolist(), r.max_new_tokens,
                       r.arrival_tick, r.slo_ttft_ms, r.slo_e2e_ms)
                      for r in trace], kw))
        raise StopIteration

    monkeypatch.setattr(pkg_bench, runner, fake)
    return seen


@pytest.mark.parametrize("flags", [
    ["--serve"], ["--serve", "--generate", "5", "--max-slots", "3"],
    ["--serve", "--paged", "--kv-block-size", "8", "--slo-ttft-ms", "50"],
    ["--serve", "--paged", "--draft", "1", "--spec-k", "2", "--kv-dtype",
     "int8", "--weight-dtype", "bf16"],
    ["--serve", "--paged", "--draft", "9"],
], ids=["slot", "slot_generate", "paged_slo", "paged_spec_quant",
        "paged_draft_out_of_range"])
def test_serve_trace_equals_jax(flags, monkeypatch):
    argv = ARGV + ["--seed", "7", *flags]
    runner = "run_paged" if "--paged" in flags else "run_engine"
    got = {}
    for name, bench, ns, config in (
            ("jax", jbench, jns, jconfig), ("port", tbench, tns, tconfig)):
        seen = _capture(bench, runner, monkeypatch)
        cfg = config.parse_args(argv, "gpt")
        dataset = ns.GPT_SPEC.build_dataset(cfg)
        model = ns.GPT_SPEC.build_model(cfg, dataset)
        if name == "jax":
            state = type("S", (), {"params": model.init(
                jax.random.key(0),
                jnp.zeros((1, dataset.features.shape[1]), jnp.int32))})()
        else:
            state = type("S", (), {"model": model})()
        logged = []
        logger = type("Log", (), {"info": lambda self, m: logged.append(m)})
        with pytest.raises(StopIteration):
            ns._gpt_serve(cfg, state, logger(), dataset)
        got[name] = seen[0]
        got[f"{name}_log"] = logged
    assert got["port"][0] == got["jax"][0]
    assert len(got["port"][0]) == max(2 * cfg.max_slots, 8)
    for key in ("max_slots", "max_len", "kv_block_size", "prefill_chunk",
                "draft_layers", "spec_k", "kv_dtype", "weight_dtype"):
        assert got["port"][1].get(key) == got["jax"][1].get(key), key
    # an out-of-range --draft is logged and dropped by both
    assert got["port_log"] == got["jax_log"]


def test_generate_too_long_raises_before_training(monkeypatch):
    def no_training(*a, **kw):
        raise AssertionError("trained before the --generate check")

    monkeypatch.setattr(tbase, "fit", no_training)
    cfg = tconfig.parse_args(ARGV + ["--generate", "57"], "gpt")
    with pytest.raises(ValueError, match="at most 56 tokens fit"):
        tbase.run_workload(tns.GPT_SPEC, cfg)
    # the JAX runner refuses the same run with the same message
    with pytest.raises(ValueError, match="at most 56 tokens fit"):
        jns._gpt_pre_check(jconfig.parse_args(ARGV + ["--generate", "57"],
                                              "gpt"),
                           jns.GPT_SPEC.build_dataset(cfg))


@pytest.mark.parametrize("flag", ["--generate", "--serve"])
def test_spec_without_post_train_refuses(flag):
    spec = dataclasses.replace(tns.GPT_SPEC, post_train=None)
    argv = ARGV + ([flag, "4"] if flag == "--generate" else [flag])
    with pytest.raises(ValueError, match="gpt only"):
        tbase.run_workload(spec, tconfig.parse_args(argv, "gpt"))


def test_config_serve_flags():
    """As the JAX CLI's (``tests/test_serve.py::test_config_serve_flags``)."""
    cfg = tconfig.parse_args(["--serve", "--max-slots", "4",
                              "--prefill-buckets", "8,32"], workload="gpt")
    assert cfg.serve and cfg.max_slots == 4
    assert cfg.prefill_buckets == (8, 32)
    assert tconfig.parse_args([], workload="gpt").serve is False
    with pytest.raises(SystemExit, match="prefill-buckets"):
        tconfig.parse_args(["--prefill-buckets", "8,x"], workload="gpt")


def test_serve_defaults_match_jax():
    mine, theirs = tconfig.parse_args([], "gpt"), jconfig.parse_args([],
                                                                     "gpt")
    for field in ("generate_tokens", "serve", "max_slots", "prefill_buckets",
                  "paged", "kv_block_size", "prefill_chunk", "slo_ttft_ms",
                  "slo_e2e_ms", "draft", "spec_k", "kv_dtype",
                  "weight_dtype"):
        assert getattr(mine, field) == getattr(theirs, field), field
    cfg = tconfig.parse_args(["--paged", "--kv-block-size", "8",
                              "--prefill-chunk", "16", "--slo-ttft-ms", "5",
                              "--slo-e2e-ms", "9", "--generate", "3"], "gpt")
    assert (cfg.paged, cfg.kv_block_size, cfg.prefill_chunk, cfg.slo_ttft_ms,
            cfg.slo_e2e_ms, cfg.generate_tokens) == (True, 8, 16, 5.0, 9.0, 3)


@pytest.mark.parametrize("argv,match", [
    (["--max-slots", "0"], "max-slots"),
    (["--kv-block-size", "0"], "kv-block-size"),
    (["--prefill-chunk", "0"], "prefill-chunk"),
    (["--slo-ttft-ms", "0"], "slo-ttft-ms"),
    (["--slo-e2e-ms", "-1"], "slo-e2e-ms"),
    (["--prefill-buckets", "8,8"], "duplicate"),
    (["--prefill-buckets", "16,8"], "ascending"),
    (["--prefill-buckets", "0,8"], ">= 1"),
    (["--draft", "-1"], "--draft -1: must be >= 0"),
    (["--draft", "1"], "--draft requires --paged"),
    (["--paged", "--spec-k", "0"], "--spec-k 0: must be >= 1"),
    (["--kv-dtype", "fp4"], "unknown --kv-dtype 'fp4'"),
    (["--weight-dtype", "int4"], "unknown --weight-dtype 'int4'"),
    (["--kv-dtype", "int8"], "--kv-dtype int8 requires --paged"),
])
def test_serve_flag_checks_mirror_jax(argv, match):
    for config in (tconfig, jconfig):
        with pytest.raises(SystemExit, match=match):
            config.parse_args(argv, workload="gpt")


@pytest.mark.parametrize("argv", [
    ["--paged", "--draft", "2", "--spec-k", "3"],
    ["--paged", "--kv-dtype", "int8", "--weight-dtype", "bf16"],
    ["--kv-dtype", "bf16", "--weight-dtype", "int8"]],
    ids=["spec", "paged_quant", "slot_quant"])
def test_serving_option_flags_parse_as_jax(argv):
    mine, theirs = tconfig.parse_args(argv, "gpt"), \
        jconfig.parse_args(argv, "gpt")
    for field in ("paged", "draft", "spec_k", "kv_dtype", "weight_dtype"):
        assert getattr(mine, field) == getattr(theirs, field), field


def test_serving_options_are_no_longer_refused():
    for flag in ("--draft", "--spec-k", "--kv-dtype", "--weight-dtype"):
        assert not any(f.rstrip("=") == flag for f in tconfig.UNPORTED_FLAGS)
    assert 3 not in tconfig.ROADMAP_ITEMS and 7 not in tconfig.ROADMAP_ITEMS


@pytest.mark.parametrize("argv,match", [
    (["--kv-dtype", "int8"], "--kv-dtype int8 requires --paged"),
    (["--kv-dtype", "fp4"], "unknown --kv-dtype 'fp4'"),
    (["--paged", "--weight-dtype", "int4"], "unknown --weight-dtype"),
])
def test_serve_bench_cli_rejects_as_jax(argv, match, capsys):
    """``python -m distributed_deep_learning_tpu_torch.serve`` refuses
    what ``scripts/serve_bench.py`` refuses, with its message."""
    from distributed_deep_learning_tpu_torch.serve.__main__ import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu", *argv])
    assert re.search(match, capsys.readouterr().err)


def test_serve_bench_cli_speculates_over_int8(capsys):
    import json

    from distributed_deep_learning_tpu_torch.serve.__main__ import main

    rc = main(["--paged", "--device", "cpu", "--requests", "4",
               "--max-slots", "2", "--draft", "1", "--spec-k", "2",
               "--kv-dtype", "int8", "--weight-dtype", "int8",
               "--layers", "2", "--d-model", "32", "--heads", "2",
               "--mlp-dim", "64", "--vocab", "64", "--max-len", "64",
               "--prompt-max", "12", "--new-max", "8",
               "--shared-prefix-len", "4", "--skip-v1"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["errors"] == 0
    assert (rec["kv_dtype"], rec["weight_dtype"]) == ("int8", "int8")
    pe = rec["paged_engine"]
    assert pe["spec"]["enabled"] and pe["spec"]["k"] == 2
    assert pe["spec"]["proposed"] == 2 * pe["spec"]["rounds"]
    assert rec["weight_drift"]["declared_bound"] > 0
