"""``chip_smoke.py``'s parts that run without a card.

The script needs an NVIDIA card for every phase, but its ``ptxas``
report parser and check (phase 6) are plain text work: they are held
here against short stored ``nvcc -Xptxas=-v`` logs, and the builder's
keeping of each library's report against a stand-in ``nvcc``.  The
script imports only the
standard library at module level, so importing it here loads no torch
kernel and needs no card.
"""

import ast
import inspect
import sys
from concurrent.futures import Future
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: the shape of ``ptxas -v`` output on sm_90a: one tensor-core dQ
#: instantiation, bf16 at head dim 64, and one paged decode instantiation
#: whose second bf16 argument is a mangling substitution
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PKhS4_PKfS8_PS2_NS_5ShapeE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PKhS4_PKfS8_PS2_NS_5ShapeE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 134 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16S1_Li64EEEvPKT_PKT0_S7_PKfS9_PKhPKiSD_PS2_Pfiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16S1_Li64EEEvPKT_PKT0_S7_PKfS9_PKhPKiSD_PS2_Pfiiiiiif
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 20480 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120paged_combine_kernelIfEEvPKfPKiPT_iiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120paged_combine_kernelIfEEvPKfPKiPT_iiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, 400 bytes cmem[0]
"""


def test_ptxas_summary_parses_the_dq_kernel():
    got = chip_smoke.ptxas_summary(PTXAS_LOG, chip_smoke.FLASH_KERNELS)
    assert got == {("flash_dq_kernel", "bf16", 64): (134, 0, 0, 0)}


def test_ptxas_summary_parses_the_decode_kernels():
    got = chip_smoke.ptxas_summary(PTXAS_LOG, chip_smoke.DECODE_KERNELS)
    assert got == {
        ("paged_decode_kernel", "bf16", "bf16", 64): (96, 16, 12, 8),
        ("paged_combine_kernel", "f32"): (22, 0, 0, 0)}


_TYPES = {"f32": "f", "bf16": "13__nv_bfloat16", "int8": "a"}


def _entry(kernel, args, regs=96, frame=0, spill=0):
    """One instantiation's lines of a ``ptxas -v`` report."""
    mangled = ("_ZN12_GLOBAL__N_1" + kernel + "I"
               + "".join(f"Li{a}E" if isinstance(a, int) else _TYPES[a]
                         for a in args) + "EEvPKT_")
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\nptxas info    : Function properties for {mangled}\n"
            f"    {frame} bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\nptxas info    : Used {regs} "
            "registers, used 1 barriers\n")


def _reports(flash_drop=0, flash_spill=False, decode_drop=0):
    """Full reports of both libraries: every flash (kernel, dtype, D) and
    every decode (q, pool, D) split kernel and combine, some decode split
    kernels with the small spill they keep."""
    flash = [_entry(k, (dt, d), spill=8 * (flash_spill and d == 128))
             for k in chip_smoke.FLASH_KERNELS for dt in ("f32", "bf16")
             for d in (16, 32, 64, 128)]
    decode = [_entry("paged_decode_kernel", (qt, kt, d), frame=16 * (d > 32),
                     spill=36 * (d > 32))
              for qt in ("f32", "bf16") for kt in ("f32", "bf16", "int8")
              for d in (32, 64, 128)]
    decode += [_entry("paged_combine_kernel", (qt,)) for qt in ("f32", "bf16")]
    return ("".join(flash[flash_drop:]), "".join(decode[decode_drop:]))


def test_check_ptxas_passes_a_full_report_and_prints_every_line(capsys):
    chip_smoke.check_ptxas(*_reports())
    out = capsys.readouterr().out
    assert "flash tensor-core: 24 of 24 instantiations parsed, 0 with" in out
    assert "paged decode: 20 of 20 instantiations parsed, 12 with" in out
    assert out.count("registers, stack frame") == 44


@pytest.mark.parametrize("broken,match", [
    (dict(flash_spill=True), "stack frame or spill in"),
    (dict(flash_drop=1), "23 of 24"),
    (dict(decode_drop=1), "19 of 20"),
])
def test_check_ptxas_raises_on_spill_or_missing_instantiations(broken, match):
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.check_ptxas(*_reports(**broken))


def test_a_library_built_before_returns_its_ptxas_report(tmp_path,
                                                         monkeypatch):
    """Phase 6 reads the report of a library an earlier run built."""
    from distributed_deep_learning_tpu_torch.ops import build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\necho "ptxas info    : Used 22 registers"\n')
    fake.chmod(0o755)
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    first = build.build_library(source)
    fake.unlink()                          # a second build would now fail
    assert build.build_library(source) == first
    assert "Used 22 registers" in first[1] and first[0].exists()


@pytest.mark.parametrize("text,want", [
    ("fLi16EE", ("f32", 16)),
    ("faLi128EE", ("f32", "int8", 128)),
    ("13__nv_bfloat16aLi32EE", ("bf16", "int8", 32)),
])
def test_template_args_decode_types_and_integers(text, want):
    assert chip_smoke._template_args(text) == want


def test_chip_smoke_imports_only_the_standard_library_at_the_top():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            top.add((node.module or "").split(".")[0])
    assert top and top <= set(sys.stdlib_module_names) | {"__future__"}, top


def _served_tiny():
    """A tiny seeded CausalLM, a trace and what the slot engine served on
    the CPU."""
    from distributed_deep_learning_tpu_torch.serve.bench import (build_model,
                                                                 make_trace)
    from distributed_deep_learning_tpu_torch.serve.engine import ServeEngine

    model = build_model(3, "cpu", vocab_size=61, num_layers=2, d_model=32,
                        num_heads=4, mlp_dim=64, max_len=48)
    reqs = make_trace(6, vocab_size=61, seed=4, prompt_lens=(2, 12),
                      new_tokens=(3, 10))
    with chip_smoke._served_runs() as runs:
        ServeEngine(model, device="cpu", max_slots=3).run(iter(reqs))
    return model, reqs, runs


def test_served_runs_records_the_trace_and_output():
    model, reqs, runs = _served_tiny()
    (run,) = runs
    assert run["engine"] == "ServeEngine" and run["model"] is model
    assert [r.uid for r in run["requests"]] == [r.uid for r in reqs]
    assert run["geometry"] == dict(max_slots=3, max_len=48)
    assert set(run["out"]["results"]) == {r.uid for r in reqs}


def test_served_margins_pass_served_tokens_and_fail_shuffled_ones():
    """Greedy tokens served on the CPU are the plain forward's argmax on
    their prefix; tokens from another request are far outside the limit."""
    model, reqs, runs = _served_tiny()
    results = runs[0]["out"]["results"]
    gap, agree = chip_smoke.served_margins(model, reqs, results)
    assert gap == 0.0 and agree == 1.0
    uids = [r.uid for r in reqs]
    shuffled = {u: (list(results[v]) * 10)[:len(results[u])]
                for u, v in zip(uids, uids[1:] + uids[:1])}
    gap, agree = chip_smoke.served_margins(model, reqs, shuffled)
    assert gap > chip_smoke.SERVE_GAP_TOL and agree < 0.5


#: phase -> the chip_smoke function that runs it (phases 16-20 and the
#: CLI's speculative int8 leg, which rides on phase 15)
NEW_PHASES = {16: "phase_fused_head", 17: "phase_optimizers",
              18: "phase_quant_serving", 19: "phase_spec",
              20: "phase_window", 15: "phase_cli_spec_quant",
              21: "phase_workloads", 22: "phase_workload_variants",
              23: "phase_workload_checkpoint", 24: "phase_resnet",
              25: "phase_zoo_lm", 26: "phase_zoo_lm", 27: "phase_staged",
              28: "phase_pipeline", 29: "phase_pipeline_zoo",
              30: "phase_moe", 31: "phase_sharded", 32: "phase_comm",
              33: "phase_grid", 34: "phase_resilience",
              35: "phase_serving_resilience", 36: "phase_disagg",
              37: "phase_obs", 38: "phase_remat", 39: "phase_tune",
              40: "phase_reshard", 41: "phase_scripts"}


@pytest.mark.parametrize("phase", sorted(NEW_PHASES))
def test_new_phases_are_listed_and_selectable(phase, monkeypatch):
    """Each new phase is in the docstring's list and in the default run,
    and ``--phases`` selects it (the card's work stubbed out here)."""
    doc = chip_smoke.__doc__
    assert f"\n{phase}. " in doc
    called = []

    def stub(name, value=None):
        def fn(*args, **kw):
            called.append(name)
            return value
        return fn

    rec = {"results": {}}
    built = Future()
    built.set_result(None)
    for name, value in (
            ("phase_device", None),
            ("start_builds", {"flash_attention": built,
                              "paged_decode": built}),
            ("phase_kernel", {}), ("phase_serve", (rec, 0)),
            ("phase_quant_serving", 0), ("phase_spec", 0),
            ("phase_window", 0), ("_write_tokens", ROOT),
            ("phase_train_bf16", (None, None, None)),
            ("phase_post_train_serving", 0),
            ("phase_cli_spec_quant", {"launches": 0}),
            ("phase_fused_head", {}), ("phase_optimizers", {}),
            ("phase_workloads", {}), ("phase_workload_variants", {}),
            ("phase_workload_checkpoint", None), ("phase_resnet", {}),
            ("phase_zoo_lm", {"flash": {"launches": {}}}),
            ("phase_staged", {}), ("phase_pipeline", ({}, {})),
            ("phase_pipeline_zoo", {}), ("phase_moe", {}),
            ("phase_sharded", {}),
            ("phase_comm", {"comm": {}, "seq": {}}),
            ("phase_grid", {}), ("phase_resilience", {}),
            ("phase_serving_resilience", {}), ("phase_disagg", {}),
            ("phase_obs", {}), ("phase_remat", {}), ("phase_tune", {}),
            ("phase_tune_oom", None), ("phase_reshard", {}),
            ("phase_scripts", {"seconds": 0.0, "launches": {}})):
        monkeypatch.setattr(chip_smoke, name, stub(name, value))
    assert chip_smoke.main(["--phases", str(phase)]) == 0
    assert NEW_PHASES[phase] in called
    assert "range(1, 42)" in inspect.getsource(chip_smoke.main)


def test_served_margins_hold_a_speculative_int8_weight_engine():
    """``_served_runs`` records an engine's serving copy (int8 weights),
    and what the speculative engine served is that copy's plain argmax on
    every prefix."""
    import torch

    from distributed_deep_learning_tpu_torch.serve import quant
    from distributed_deep_learning_tpu_torch.serve.bench import (build_model,
                                                                 make_trace)
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    model = build_model(3, "cpu", vocab_size=61, num_layers=2, d_model=32,
                        num_heads=4, mlp_dim=64, max_len=48)
    reqs = make_trace(5, vocab_size=61, seed=4, prompt_lens=(2, 12),
                      new_tokens=(3, 10))
    with chip_smoke._served_runs() as runs:
        PagedEngine(model, device="cpu", max_slots=3, kv_block_size=8,
                    prefill_chunk=8, max_len=40, draft_layers=1, spec_k=3,
                    weight_dtype="int8").run(reqs)
    (run,) = runs
    assert isinstance(run["model"].layers[0].mlp_in, quant.QuantDense)
    assert run["geometry"]["kv_dtype"] == str(torch.float32)
    gap, agree = chip_smoke.served_margins(run["model"], reqs,
                                           run["out"]["results"])
    assert gap == 0.0 and agree == 1.0


@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
def test_optimizer_hold_tells_a_zero_learning_rate_from_the_recipe(
        opt, monkeypatch):
    """Phase 17's hold on the CPU at a small width (d 128, so Adafactor
    factors the MLP): the recipe's steps repeat exactly, and the planted
    control (learning rate 0) lies beyond the hold's limit."""
    monkeypatch.setattr(chip_smoke, "FULL_MODEL", dict(
        vocab_size=256, num_layers=2, d_model=128, num_heads=4, mlp_dim=256,
        max_len=64))

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    want = chip_smoke._optimizer_params(opt, chip_smoke.OPT_LR, "cpu")
    again = chip_smoke._optimizer_params(opt, chip_smoke.OPT_LR, "cpu")
    zero = chip_smoke._optimizer_params(opt, "0", "cpu")
    assert gap(again, want) == 0.0
    assert gap(zero, want) > 100 * chip_smoke.OPT_HOLD_ATOL


def test_first_loss_check_with_a_cpu_stand_in(monkeypatch):
    """Phase 21's card-vs-CPU check on the CPU: a CLI run stands in for
    the card's, and its first train-step loss meets the CPU rebuild of
    that step within ``FIRST_LOSS_TOL``; a planted wrong loss (10 times
    the tolerance off) fails the check."""
    from distributed_deep_learning_tpu_torch.__main__ import main

    monkeypatch.setenv("DDL_DATA_LIMIT", "128")
    argv = ["-l", "1", "-s", "8", "-b", "16"]
    want = chip_smoke.first_step_loss("mlp", argv, "cpu")
    _, hist = main(["mlp", *argv, "-e", "1", "-d", "cpu"])
    tol = chip_smoke.FIRST_LOSS_TOL
    assert chip_smoke.check_first_loss(
        "stand-in", hist[0].step_losses[0], want, tol) <= tol
    with pytest.raises(RuntimeError, match="first loss"):
        chip_smoke.check_first_loss("planted", want * (1 + 10 * tol), want,
                                    tol)


def test_moe_first_step_reads_the_logged_loss_and_the_routing(monkeypatch):
    """Phase 30's first-step reading on a CPU stand-in: the task loss of
    the seeded model's first batch equals the first loss the CLI logs
    (the load-balance term, positive, stays out of it), and the router
    logits give each routed layer's dropped share at the run's capacity;
    no device number is taken on the CPU."""
    from distributed_deep_learning_tpu_torch.__main__ import main

    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = ["-l", "2", "-s", "32", "-b", "8"]
    first = chip_smoke.moe_first_step(argv, "cpu")
    _, hist = main(["moe", *argv, "-e", "1", "-d", "cpu"])
    chip_smoke.check_first_loss("stand-in", hist[0].step_losses[0],
                                first["loss"], chip_smoke.DATA_FIRST_LOSS_TOL)
    assert first["aux"] > 0 and first["peak"] is None
    assert first["shape"] == (8 * 64, 8, 2 * 8 * 64 // 8)
    assert len(first["dropped"]) == 1
    assert 0 < first["dropped"][0] < 1          # capacity binds
    with pytest.raises(RuntimeError, match="first loss"):
        chip_smoke.check_first_loss("planted: the objective logged",
                                    first["loss"] + first["aux"],
                                    first["loss"],
                                    chip_smoke.DATA_FIRST_LOSS_TOL)


def test_prefetch_ab_helpers_stop_their_threads():
    """Item 18's A/B reads batches through ``_cycle`` over a prefetching
    loader; closing it stops the loader's thread."""
    import threading

    state, step, train = chip_smoke._step_setup(
        "mlp", ["-l", "1", "-s", "8", "-b", "16"], "cpu", prefetch=2)
    batches = chip_smoke._cycle(train)
    n = len(train)
    seen = [next(batches) for _ in range(n + 2)]   # into a second pass
    step(state, *seen[-1])
    batches.close()
    for t in threading.enumerate():
        if t.name == "prefetch":
            t.join(10.0)
            assert not t.is_alive()


def test_step_setup_data_step_is_the_sequential_step_at_world_1():
    """Phase 30's ``-m data`` profiler window steps through
    ``DistributedDataParallel`` as the runner wraps the model; at world 1
    (gloo here) its first step's loss and update are the sequential
    step's."""
    import torch

    from distributed_deep_learning_tpu_torch.runtime import bootstrap

    argv = ["-l", "2", "-s", "32", "-b", "8"]
    runs = {}
    for data in (True, False):
        _, created = bootstrap.initialize("cpu") if data else (None, False)
        try:
            state, step, train = chip_smoke._step_setup("moe", argv, "cpu",
                                                        data=data)
            x, y = next(train.iter_batches())
            loss = step(state, x, y)[1]["loss"].item()
            runs[data] = loss, [p.detach().clone()
                                for p in state.model.parameters()]
        finally:
            if created:
                bootstrap.shutdown()
    assert abs(runs[True][0] - runs[False][0]) <= \
        chip_smoke.DATA_FIRST_LOSS_TOL * abs(runs[False][0])
    for got, want in zip(runs[True][1], runs[False][1]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def _zoo_launches(monkeypatch, tmp_path, planted):
    """A small ``transformer`` epoch on the CPU through the CLI with
    phase 25's tokens.npy, the flash wrappers replaced by stand-ins that
    count as the kernels' wrappers do (on the CPU the wrappers run the
    plain versions uncounted); ``planted`` routes every cross-attention
    through dense attention.  Returns (launches, expected launches)."""
    from distributed_deep_learning_tpu_torch.__main__ import main
    from distributed_deep_learning_tpu_torch.models import transformer as ttf
    from distributed_deep_learning_tpu_torch.ops import attention as fa

    def forward(q, k, v, key_valid, **kw):
        forward.launches += 1
        return fa.flash_attention_reference(q, k, v, key_valid=key_valid,
                                            **kw)

    def backward(*args, **kw):
        dq.launches += 1
        dkv.launches += 1
        return fa.flash_backward_reference(*args, **kw)

    def dq():
        pass

    def dkv():
        pass

    forward.launches = dq.launches = dkv.launches = 0
    monkeypatch.setattr(fa, "flash_forward", forward)
    monkeypatch.setattr(fa, "flash_backward", backward)
    if planted:
        real = ttf.TransformerLayer.attends

        def attends(layer, attention, self_valid=None, cross_valid=None):
            attend, cross = real(layer, attention, self_valid, cross_valid)
            if cross is None:
                return attend, None
            return attend, lambda q, k, v: ttf.attend_qkv(
                "dense", layer.cross_attn, q, k, v, causal=False,
                key_valid=cross_valid)

        monkeypatch.setattr(ttf.TransformerLayer, "attends", attends)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    data = chip_smoke._write_zoo_tokens("transformer")
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    main(["transformer", "-l", "2", "-s", "32", "-e", "1", "-b", "4",
          "--attention", "flash", "-d", "cpu", "--data-dir", str(data)])
    got = {"flash_forward": forward.launches,
           "flash_backward_dq": dq.launches,
           "flash_backward_dkv": dkv.launches}
    return got, chip_smoke.expected_launches(
        chip_smoke.ZOO_ATTENTIONS["transformer"] * 2,
        chip_smoke.split_steps(32, 4))


def test_zoo_launch_check_holds_and_fails_a_dense_cross_attention(
        monkeypatch, tmp_path):
    """Phase 25's launch-count check on a CPU stand-in: three flash
    attentions a layer a step pass it; the planted fault (cross-attention
    through dense attention) leaves a third of them out and fails it."""
    got, want = _zoo_launches(monkeypatch, tmp_path, planted=False)
    assert want["flash_forward"] == 3 * 2 * sum(chip_smoke.split_steps(32,
                                                                       4))
    chip_smoke.check_launches("stand-in", got, want)
    got, want = _zoo_launches(monkeypatch, tmp_path, planted=True)
    with pytest.raises(RuntimeError, match="flash kernels"):
        chip_smoke.check_launches("planted", got, want)


@pytest.mark.parametrize("workload", ["resnet", "mnist"])
def test_layer_keyed_maps_the_sequential_model_onto_the_stages(workload):
    """Phase 27's mapping: the sequential model's state dict, keyed by
    ``layer_state_dict`` and split by ``from_sequential``, holds exactly the
    staged model's keys, and a staged model made from the same seed holds
    the same tensors (so the phase's ``-m model`` vs ``-m sequential``
    comparison starts from one set of weights)."""
    import torch

    from distributed_deep_learning_tpu_torch.parallel.staging import (
        StagedModel, layer_state_dict)
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.workloads import get_spec

    cfg = parse_args([*chip_smoke.STAGED_WORKLOADS[workload], "-d", "cpu"],
                     workload=workload)
    spec = get_spec(workload)
    dataset = spec.build_dataset(cfg)
    seq = spec.build_model(cfg, dataset)
    seq.reset_parameters(torch.Generator().manual_seed(0))
    layers = spec.build_layers(cfg, dataset)
    staged = StagedModel.from_layers(layers, spec.partitioner(len(layers),
                                                              2), 2)
    staged.reset_parameters(torch.Generator().manual_seed(0))
    mapped = staged.from_sequential(layer_state_dict(seq))
    assert set(mapped) == set(staged.state_dict())
    for k, v in staged.state_dict().items():
        torch.testing.assert_close(mapped[k], v, rtol=0, atol=0, msg=k)


def test_pipeline_gradient_gap_finds_a_dropped_microbatch():
    """Phase 28's gradient agreement on the CPU at a small width: gpipe's
    and interleaved's trunk gradients, per layer in the model's order
    (``_global_layers``), lie within ``PIPE_GRAD_TOL``; the interleaved
    step with the last microbatch's trunk gradient left out lies beyond
    it."""
    import torch

    from distributed_deep_learning_tpu_torch.models.pipelined_lm import \
        PipelinedLM
    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy
    from distributed_deep_learning_tpu_torch.train.state import (Optimizer,
                                                                 TrainState)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns
    from distributed_deep_learning_tpu_torch.workloads.base import \
        _make_1f1b_train_step

    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, 50, (4, 12), generator=g)
    targets = torch.randint(1, 50, (4, 12), generator=g)

    def grads(n_chunks, drop_last=False):
        model = PipelinedLM(vocab_size=50, num_layers=4, d_model=32,
                            num_heads=4, mlp_dim=64, n_stages=2,
                            microbatch_size=1, n_chunks=n_chunks,
                            max_len=12, causal=True)
        model.reset_parameters(torch.Generator().manual_seed(1))
        tx = Optimizer("sgd", 0.0)
        state = TrainState(model=model, tx=tx,
                           optimizer=tx.build(model.named_parameters()))
        if n_chunks == 1:
            step = make_step_fns(TokenCrossEntropy())[0]
        else:
            step = _make_1f1b_train_step(model, TokenCrossEntropy(), 1,
                                         interleaved=True)
        if drop_last:
            chip_smoke.drop_last_microbatch(model, 4)
        step(state, tokens, targets)
        return chip_smoke._global_layers(model.trunk, {
            k: p.grad.clone() for k, p in model.trunk.stacked().items()})

    want = grads(1)
    assert chip_smoke._max_gap(grads(2), want) <= chip_smoke.PIPE_GRAD_TOL
    assert chip_smoke._max_gap(grads(2, drop_last=True), want) > \
        chip_smoke.PIPE_GRAD_TOL


def test_dense_walk_holds_the_flash_trunk_and_restores_it():
    """Phase 28's independent reference on the CPU: the unpipelined walk
    of a flash-attention ``PipelinedLM`` with its trunk switched to dense
    attention gives the flash walk's loss within phases 25-26's limit,
    and the trunk attends by flash again afterwards."""
    import torch

    from distributed_deep_learning_tpu_torch.models.pipelined_lm import \
        PipelinedLM
    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, 50, (4, 12), generator=g)
    targets = torch.randint(1, 50, (4, 12), generator=g)
    model = PipelinedLM(vocab_size=50, num_layers=4, d_model=32, num_heads=4,
                        mlp_dim=64, n_stages=2, microbatch_size=1,
                        max_len=12, causal=True, attention="flash")
    model.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        flash = TokenCrossEntropy()(model.eval().apply_sequential(tokens),
                                    targets).item()
    dense = chip_smoke.dense_walk(model, tokens, targets)
    assert abs(dense - flash) <= chip_smoke.FIRST_LOSS_TOL * abs(flash)
    assert {b.attention for b in model.trunk.stage.blocks} == {"flash"}


@pytest.mark.parametrize("schedule,chunks", [("gpipe", 1), ("1f1b", 1),
                                             ("interleaved", 2),
                                             ("interleaved", 3)])
def test_grid_launches_sum_to_one_process(schedule, chunks):
    """Phase 33's per-rank launch counts: a data coordinate's stages sum
    to what one process walking every stage launches (phase 28's
    ``PIPE_FORWARDS`` rule for 1F1B and interleaved)."""
    stages, layers, m = 2, 12, 4
    ranks = [chip_smoke.grid_launches(schedule, s, stages, chunks, layers,
                                      m) for s in range(stages)]
    total = {k: sum(r[k] for r in ranks) for k in ranks[0]}
    fwd = 1 if schedule == "gpipe" else 2 - Fraction(1, stages * chunks)
    assert total == {"flash_forward": int(fwd * layers * m),
                     "flash_backward_dq": layers * m,
                     "flash_backward_dkv": layers * m}
    assert ranks[0]["flash_backward_dq"] == ranks[1]["flash_backward_dq"]


def test_one_shot_hook_fires_on_its_step_once():
    """Phase 34's injected activations: the hook replaces one module's
    output on the named step only, once, and is removed afterwards."""
    import torch

    lin = torch.nn.Linear(3, 3)
    step = {"n": 0}
    outs = []
    with chip_smoke.one_shot_hook(lin, lambda: step["n"], 2,
                                  lambda o: o * float("nan")) as fired:
        for step["n"] in (1, 2, 2, 3):
            outs.append(bool(torch.isnan(lin(torch.ones(3))).any()))
    assert outs == [False, True, False, False] and fired == [2]
    assert not lin._forward_hooks


def test_full_run_kernels_line_carries_grid_and_resilience_launches(
        monkeypatch, capsys):
    """With every phase run (the card's work stubbed out), the kernels
    line gives each flash kernel phase 33's launches by case and phase
    34's, and the last line is the contract's; the usage lines name the
    two phases' ``--phases`` call."""
    import json

    import torch

    assert "--phases 1,7,33,34" in chip_smoke.__doc__
    built = Future()
    built.set_result(None)
    flash = {"flash_forward": 1, "flash_backward_dq": 2,
             "flash_backward_dkv": 3}
    runs = {"case": {"launches": flash}}
    values = {
        "start_builds": {"flash_attention": built, "paged_decode": built},
        "phase_kernel": {}, "phase_serve": ({"results": {}}, 0),
        "phase_flash_kernels": {},
        "phase_train_flash": (None, flash, None),
        "phase_train_bf16": (None, flash, None),
        "phase_data_parallel": (None, None),
        "phase_post_train_serving": 0,
        "phase_cli_spec_quant": {"launches": 0},
        "phase_zoo_lm": runs, "phase_pipeline": ({}, runs),
        "phase_pipeline_zoo": {}, "phase_moe": runs, "phase_sharded": runs,
        "phase_comm": {"comm": runs, "seq": runs},
        "phase_grid": {"1f1b f32 2 ranks": {"launches": flash}},
        "phase_resilience": {"launches": flash},
        "phase_obs": flash, "phase_disagg": {"at_rest": 4, "int8": 4},
        "phase_tune": {"autotune": flash},
        "phase_reshard": {"(a) data=3": flash},
        "phase_scripts": {"seconds": 1.0,
                          "launches": {**flash, "paged_flash_decode": 5}},
        "_write_tokens": ROOT}
    for name in [n for n in dir(chip_smoke) if n.startswith("phase_")] + \
            ["start_builds", "_write_tokens", "start_ranks"]:
        value = values.get(name)
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _v=value, **k: _v)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "card", "count": 1}}
    kernels = {k["name"]: k for k in json.loads(lines[-2])["kernels"]}
    for name, n in flash.items():
        assert kernels[name]["grid_launches"] == {"1f1b f32 2 ranks": n}
        assert kernels[name]["resilience_launches"] == n
        assert kernels[name]["obs_launches"] == n
        assert kernels[name]["tune_launches"] == {"autotune": n}
        assert kernels[name]["reshard_launches"] == {"(a) data=3": n}
    assert kernels["paged_flash_decode"]["disagg_launches"] == {
        "at_rest": 4, "int8": 4}
    for name, n in {**flash, "paged_flash_decode": 5}.items():
        assert kernels[name]["scripts_launches"] == n


def test_phase_35_rides_on_phase_4_and_completes_36_phases(monkeypatch):
    """Phases 35 and 36 run inside phase 4's block (its model and trace),
    after phase 20 and before the model leaves the card; phases 37-40
    run after the training phases, in turn; the complete run is phases
    1-40 and their launches land on the kernels' entries."""
    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_window(rec)") < src.index(
        "phase_serving_resilience(rec)") < src.index(
        "phase_disagg()") < src.index("_full_width.cache_clear()") < \
        src.index("phase_resilience(") < src.index("phase_obs(tokens)") < \
        src.index("phase_remat()") < src.index("phase_tune(tokens)") < \
        src.index("phase_tune_oom(tokens)") < \
        src.index("phase_reshard(tokens)")
    assert '"resilience_serve_launches"' in src
    assert '"disagg_launches"' in src and '"obs_launches"' in src
    assert '"tune_launches"' in src and '"reshard_launches"' in src
    assert "set(range(1, 42))" in src


def _tiny_paged():
    from distributed_deep_learning_tpu_torch.serve.bench import (build_model,
                                                                 make_trace)
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    model = build_model(0, "cpu", vocab_size=61, num_layers=2, d_model=32,
                        num_heads=4, mlp_dim=64, max_len=64)
    eng = PagedEngine(model, device="cpu", max_slots=3, kv_block_size=8,
                      prefill_chunk=8)
    trace = make_trace(4, vocab_size=61, seed=1, prompt_lens=(3, 12),
                       new_tokens=(3, 8))
    return model, eng, trace


def test_phase_35_margins_chunk_logits_and_tick_count():
    """The phase's instruments on a tiny CPU engine: the tick counter
    counts the engine's decode ticks, the recorder a margin for every
    decoded token, and the chunk prefill's logits are the plain
    forward's."""
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.serve.supervisor import \
        ServeSupervisor

    model, eng, trace = _tiny_paged()
    marg = chip_smoke._Margins(keep_rows=True)
    with chip_smoke._tick_calls() as calls:
        out = ServeSupervisor(eng, fleet_hook=marg).run(list(trace))
    assert calls["n"] == out["stats"]["engine"]["decode_ticks"] > 0
    for r in trace:
        assert sorted(marg.margin[r.uid]) == list(range(
            1, len(out["results"][r.uid])))
    delta = chip_smoke._delta_and_first_margins(eng, trace, out["results"],
                                                marg)
    assert 0 <= delta < 1e-4
    r = trace[0]
    stream = np.concatenate([r.prompt, out["results"][r.uid]]).astype(
        np.int64)
    got = chip_smoke._chunk_logits(eng, stream)
    with torch.no_grad():
        want = model.logits_from(model.cached_forward(
            torch.as_tensor(stream)[None], model.init_cache(1, 64)))[0]
    if model.pad_id is not None:
        want[:, model.pad_id] = -torch.inf       # as the tick masks it
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_phase_35_replay_rule_holds_near_ties_and_fails_the_rest():
    """The determinism rule's check: a request may part from the
    fault-free run only first at a near-tie past its pre-fault tokens;
    a move at rest must not part at all; zero loss throughout."""
    marg = chip_smoke._Margins()
    marg.margin = {0: {0: 5.0, 1: 0.01, 2: 3.0}, 1: {0: 4.0, 1: 2.0}}
    ref = {"results": {0: [1, 2, 3], 1: [4, 5]}}

    def out(r0, r1, lost=0):
        return {"results": {0: r0, 1: r1}, "errors": {},
                "stats": {"requests_lost": lost}}

    assert chip_smoke._hold_replay("same", out([1, 2, 3], [4, 5]), ref, marg,
                                   0.1, exact=True) == (0, 0.0)
    # request 0 parts at its token 1, a near-tie (0.01 < 0.1)
    assert chip_smoke._hold_replay("tie", out([1, 9, 9], [4, 5]), ref, marg,
                                   0.1, before={0: 1})[0] == 1
    for kw, r0 in (({}, [1, 2, 9]),              # token 2: margin 3.0
                   ({"exact": True}, [1, 9, 9]),  # at rest: exact
                   ({"before": {0: 2}}, [1, 9, 9])):  # a kept token moved
        with pytest.raises(RuntimeError, match="parts from"):
            chip_smoke._hold_replay("bad", out(r0, [4, 5]), ref, marg, 0.1,
                                    **kw)
    with pytest.raises(RuntimeError, match="lost"):
        chip_smoke._hold_replay("lost", out([1, 2, 3], [4, 5], lost=1), ref,
                                marg, 0.1)
    with pytest.raises(RuntimeError, match="twice"):
        chip_smoke._hold_replay("again", out([1, 2, 3], [4, 5]), ref, marg,
                                0.1, again=out([1, 2, 3], [4, 6]))


def test_phase_36_logit_delta_stops_at_the_first_parting():
    """The largest |dlogit| between two runs counts only the positions up
    to each request's first parting."""
    import torch

    a, b = chip_smoke._Margins(keep_rows=True), \
        chip_smoke._Margins(keep_rows=True)
    a.rows = {0: {1: torch.tensor([1.0, 2.0]), 2: torch.tensor([0.0, 0.0]),
                  3: torch.tensor([5.0, 5.0])}}
    b.rows = {0: {1: torch.tensor([1.5, 2.0]), 2: torch.tensor([0.0, 0.25]),
                  3: torch.tensor([-5.0, 5.0])}}
    ref = {"results": {0: [7, 8, 9, 10]}}
    out = {"results": {0: [7, 8, 3, 10]}}    # parts at token 2
    assert chip_smoke._logit_delta(a, b, ref, out) == 0.5
    assert chip_smoke._logit_delta(a, b, ref, ref) == 10.0


def test_phase_36_holds_each_wire_to_a_limit_read_apart_from_it():
    """A run may part from the unified one only at a near-tie, and its
    largest |dlogit| (the parting row included) must stay within a limit
    that does not come from the run itself: a parting whose row moved by
    more than the limit fails, however small the margin."""
    import torch

    a, b = chip_smoke._Margins(keep_rows=True), \
        chip_smoke._Margins(keep_rows=True)
    a.margin = {0: {0: 5.0, 1: 4.0, 2: 0.3}}
    a.rows = {0: {1: torch.tensor([1.0, 2.0]), 2: torch.tensor([0.3, 0.0])}}
    b.rows = {0: {1: torch.tensor([1.0, 2.0]), 2: torch.tensor([0.0, 0.2])}}
    ref = {"results": {0: [7, 8, 9]}}
    parted = {"results": {0: [7, 8, 3]}, "errors": {}}
    assert chip_smoke._hold_disagg("same", ref | {"errors": {}}, ref, a, b,
                                   0.5, 1.0) == pytest.approx(0.3)
    assert chip_smoke._hold_disagg("tie", parted, ref, a, b, 0.5,
                                   1.0) == pytest.approx(0.3)
    with pytest.raises(RuntimeError, match="exceeds"):
        chip_smoke._hold_disagg("moved", parted, ref, a, b, 0.1, 1.0)
    with pytest.raises(RuntimeError, match="parts from"):
        chip_smoke._hold_disagg("wide", parted, ref, a, b, 0.5, 0.2)


def test_phase_37_step_window_spans_train_steps_2_to_4(tmp_path):
    """Two flash forwards a train step: the window runs from step 2's
    first to step 5's, and the card is busy for the union of the kernels
    inside it (overlaps counted once, the edges clipped)."""
    import json

    fwd = [0, 10, 100, 110, 200, 210, 300, 310, 400, 410]
    ev = [{"cat": "kernel", "name": "flash_fwd_kernel", "ts": t, "dur": 5}
          for t in fwd]
    ev += [{"cat": "kernel", "name": "gemm", "ts": 150, "dur": 20},
           {"cat": "kernel", "name": "gemm", "ts": 160, "dur": 20},
           {"cat": "kernel", "name": "gemm", "ts": 395, "dur": 10},
           {"cat": "cpu_op", "name": "aten::mm", "ts": 120, "dur": 500}]
    path = tmp_path / "trace.2.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy, window = chip_smoke._step_window(path, layers=2)
    assert window == 0.3                      # 100 .. 400 us
    assert busy == pytest.approx((6 * 5 + 30 + 5) / 1e3)


def test_phase_37_reads_kernels_and_idle_share_from_a_chrome_trace(
        tmp_path):
    import json

    path = tmp_path / "trace.1.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "flash_fwd_kernel<float>", "ts": 100,
         "dur": 30},
        {"cat": "kernel", "name": "ampere_sgemm", "ts": 150, "dur": 50},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 500},
        {"cat": "kernel", "name": "flash_dq_kernel<float>", "ts": 180,
         "dur": 20}]}))
    names, busy, window = chip_smoke._trace_kernels(path)
    assert names == {"flash_fwd_kernel<float>", "ampere_sgemm",
                     "flash_dq_kernel<float>"}
    assert (busy, window) == (0.1, 0.1)


def test_remat_steps_keep_the_losses_of_the_run_without_remat():
    """Phase 38's step runs on a CPU stand-in: ``cnn`` (BatchNorm) under
    each policy repeats the losses of the run without remat within
    ``REMAT_TOL`` (bit for bit here); no device number on the CPU."""
    argv = ["-l", "1", "-s", "2", "-b", "8"]
    plain = chip_smoke.remat_steps("cnn", argv, None, device="cpu")
    assert plain[2] is None and len(plain[0]) == chip_smoke.REMAT_STEPS
    for policy in chip_smoke.REMAT_CASES[1:]:
        losses, _, _ = chip_smoke.remat_steps("cnn", argv, policy,
                                              device="cpu")
        assert chip_smoke._loss_gap(losses, plain[0]) <= \
            chip_smoke.REMAT_TOL
        assert losses == plain[0]


def test_tune_launch_check_holds_on_a_cpu_stand_in(monkeypatch, tmp_path):
    """Phase 39's launch accounting on the CPU: a small ``gpt -m data
    --autotune --plan`` through the CLI, its flash calls counted by
    stand-ins (the wrappers run their plain versions uncounted here),
    equals each trial's step calls (first step, FLOP count, warm-up,
    timed steps) times its plan's kernels a step (remat recomputes the
    forward, accumulation runs each microbatch), plus the epoch's under
    the chosen plan; one trial's calls less fails the check."""
    from distributed_deep_learning_tpu_torch.__main__ import main
    from distributed_deep_learning_tpu_torch.ops import attention as fa
    from distributed_deep_learning_tpu_torch.tune import Plan, load_plan

    def forward(q, k, v, key_valid, **kw):
        forward.launches += 1
        return fa.flash_attention_reference(q, k, v, key_valid=key_valid,
                                            **kw)

    def backward(*args, **kw):
        backward.launches += 1
        return fa.flash_backward_reference(*args, **kw)

    forward.launches = backward.launches = 0
    monkeypatch.setattr(fa, "flash_forward", forward)
    monkeypatch.setattr(fa, "flash_backward", backward)
    rng = np.random.default_rng(0)
    np.save(tmp_path / "tokens.npy",
            rng.integers(1, 61, (32, 17)).astype(np.int32))
    path = str(tmp_path / "p.json")
    # the lattice's plans take --attention auto (dense on the CPU); the
    # hand-set baseline keeps flash and rides every rung
    main(["gpt", "-m", "data", "-l", "2", "-s", "32", "-e", "1", "-b", "4",
          "--attention", "flash", "-d", "cpu", "--data-dir", str(tmp_path),
          "--autotune", "--plan", path])
    plan, record = load_plan(path)
    trials = [(Plan.from_dict(t["plan"]), t)
              for t in record["search"]["trials"]]
    assert {(p.attention, p.remat) for p, _ in trials} >= {
        ("flash", False), ("auto", True)}
    want = {}
    for p, t in trials:
        want = chip_smoke._add(want, chip_smoke._plan_launches(
            p, chip_smoke._trial_calls(t, chip_smoke.TUNE_WARMUP),
            layers=2, device="cpu"))
        if p.attention == "flash":
            # the FLOP count's backward: on the card its counted ops call
            # the dQ and dK/dV wrappers, on the CPU their plain versions
            # (not the stand-ins)
            for k in ("flash_backward_dq", "flash_backward_dkv"):
                want[k] -= 2 * p.grad_accum
    fwd = (2 if plan.remat else 1) * plan.grad_accum
    epoch = chip_smoke.expected_launches(2, chip_smoke.split_steps(32, 4),
                                         fwd, plan.grad_accum)
    if plan.attention != "flash":
        epoch = {k: 0 for k in epoch}
    want = chip_smoke._add(want, epoch)
    got = {"flash_forward": forward.launches,
           "flash_backward_dq": backward.launches,
           "flash_backward_dkv": backward.launches}
    chip_smoke.check_launches("stand-in", got, want)
    with pytest.raises(RuntimeError, match="flash kernels"):
        chip_smoke.check_launches("planted", got, chip_smoke._add(
            want, chip_smoke._plan_launches(Plan(attention="flash"), 1,
                                            layers=2, device="cpu")))


def test_restored_parts_check_holds_and_fails_a_planted_moment(tmp_path):
    """Phase 40's in-place check on the CPU: a state restored from a
    checkpoint equals its saved whole tensors part by part; one Adam
    moment nudged after the restore fails it."""
    import torch

    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        Checkpointer

    def state(seed):
        s = create_train_state(MLP(8, hidden_size=4), seed,
                               Optimizer("adam", 1e-3), device="cpu")
        s.optimizer.zero_grad()
        s.model(torch.ones(2, 8)).sum().backward()
        s.apply_gradients()
        return s

    ck = Checkpointer(tmp_path)
    ck.save(1, state(0))
    whole = torch.load(tmp_path / "ckpt-1.pt", weights_only=True)
    got = ck.restore(state(1))
    assert chip_smoke.restored_parts_exact(got, whole)
    moment = next(iter(got.optimizer.state.values()))["exp_avg"]
    moment.view(-1)[0] += 1e-3
    assert not chip_smoke.restored_parts_exact(got, whole)


def _counted_flash(monkeypatch):
    """Stand-ins for the flash wrappers that count their calls (on the CPU
    the wrappers run their plain versions uncounted)."""
    from distributed_deep_learning_tpu_torch.ops import attention as fa

    def forward(q, k, v, key_valid, **kw):
        forward.launches += 1
        return fa.flash_attention_reference(q, k, v, key_valid=key_valid,
                                            **kw)

    def backward(*args, **kw):
        backward.launches += 1
        return fa.flash_backward_reference(*args, **kw)

    forward.launches = backward.launches = 0
    monkeypatch.setattr(fa, "flash_forward", forward)
    monkeypatch.setattr(fa, "flash_backward", backward)
    return lambda: {"flash_forward": forward.launches,
                    "flash_backward_dq": backward.launches,
                    "flash_backward_dkv": backward.launches}


@pytest.mark.parametrize("example", ["05", "04"])
def test_phase_41_launch_check_holds_on_a_cpu_stand_in(example, monkeypatch):
    """Phase 41's predictions for the CLI examples on the CPU: example
    05's argv (each rank of ``data=1,model=2`` runs every layer, so one
    process stands in for a rank) and example 04's pipeline, each with
    the flash attention the card's ``auto`` picks, counted by stand-ins,
    give ``_cli_launches`` and ``pipeline_cli_launches``; an epoch fewer
    fails the check."""
    import contextlib
    import io

    from distributed_deep_learning_tpu_torch.__main__ import main

    counted = _counted_flash(monkeypatch)
    monkeypatch.setenv("DDL_DATA_LIMIT", str(chip_smoke.P41_ROWS))
    if example == "05":
        argv = ["gpt", "-l", "2", "-s", "64", "-e", "2", "-b", "16",
                "-m", "data"]
        want = chip_smoke._cli_launches(2)
        short = chip_smoke._cli_launches(2, epochs=1)
    else:
        argv = ["gpt", "-l", "4", "-s", "64", "-e", "2", "-b", "16",
                "-m", "pipeline", "--nstages", "4", "--pipeline-schedule",
                "1f1b"]
        want = chip_smoke.pipeline_cli_launches()
        monkeypatch.setattr(chip_smoke, "P41_EPOCHS", 1)
        short = chip_smoke.pipeline_cli_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv + ["--attention", "flash", "-d", "cpu"])
    got = counted()
    chip_smoke.check_launches("stand-in", got, want)
    with pytest.raises(RuntimeError, match="flash kernels"):
        chip_smoke.check_launches("planted", got, short)


def test_phase_41_runs_the_scripts_and_examples_it_names():
    """Phase 41 drives every script and example the docstring names
    through ``main(argv)``, the multi-rank ones in ``P41_RANK_CALLS``, the
    serving bench at phase 4's width; the ranks' launches start before
    phase 23."""
    import importlib

    src = inspect.getsource(chip_smoke.phase_scripts)
    for name in ("serve_bench", "obs_report", "disagg_bench", "autotune",
                 "data_soak", "01_train_mlp_library_api",
                 "04_pipelined_gpt_cli", "06_elastic_mid_epoch_resume",
                 "08_profiling_toolkit"):
        assert f'"{name}"' in src
    for pkg, name, _ in chip_smoke.P41_RANK_CALLS:
        assert callable(importlib.import_module(
            f"distributed_deep_learning_tpu_torch.{pkg}.{name}").main)
    serve = chip_smoke.P41_SERVE
    for flag, value in (("--layers", "12"), ("--d-model", "768"),
                        ("--vocab", "32768"), ("--max-len", "1024"),
                        ("--requests", "16"), ("--max-slots", "8")):
        assert serve[serve.index(flag) + 1] == value
    assert str(chip_smoke.FULL_MODEL["d_model"]) in serve
    assert "host_store" in inspect.getsource(chip_smoke._spawn)
    src = inspect.getsource(chip_smoke.main)
    assert src.index("start_ranks(") < src.index(
        "phase_workload_checkpoint()") < src.index("phase_sharded(")


@pytest.mark.parametrize("phases, want", [
    ({41}, {2: ["P41_RANK "]}),
    ({33}, {2: ["GRID "], 4: ["GRID "]}),
    ({31, 32}, {2: ["TWO_RANK ", "SEQ_RANK "]}),
    ({31, 32, 33, 41}, {2: ["TWO_RANK ", "SEQ_RANK ", "GRID ", "P41_RANK "],
                        4: ["GRID "]}),
])
def test_rank_jobs_are_one_launch_a_world(phases, want):
    """The ranks' work of the phases asked for, and only theirs, in one
    launch a world; phases 31 and 32's CLI legs share one job; every job
    names a rank script of the module that compiles and makes no group of
    its own (``RANK_JOBS`` made it)."""
    import json

    jobs = chip_smoke.rank_jobs(phases, ROOT)
    assert {w: [tag for tag, _, _ in js] for w, js in jobs.items()} == want
    for js in jobs.values():
        for tag, name, args in js:
            script = getattr(chip_smoke, name)
            compile(script, name, "exec")
            assert "bootstrap import join" not in script
            assert "init_process_group" not in script
            assert all(isinstance(a, str) for a in args)
    if 31 in phases:
        legs = json.loads(jobs[2][0][2][0])
        assert set(legs) == set(chip_smoke.sharded_legs(ROOT)) | set(
            chip_smoke.comm_legs(ROOT))
    if 33 in phases:
        for world, cases in chip_smoke.grid_cases(ROOT).items():
            grid = [a for tag, _, a in jobs[world] if tag == "GRID "][0]
            assert json.loads(grid[0]) == cases


def test_rank_records_open_a_worlds_gate_once(monkeypatch, tmp_path):
    """The first read of a world's records opens its gate and collects
    every job's records; later reads take them from there."""
    import json

    gate = tmp_path / "world2.go"
    jobs = [["A ", "TWO_RANK", []], ["B ", "SEQ_RANK", []]]
    outs = [(0, f"A {json.dumps({'r': r})}\nB {json.dumps([r])}\n"
                f"JOB_SECONDS {json.dumps({'A ': 1.0, 'B ': 2.0})}\n")
            for r in range(2)]
    collected = []

    def collect(launch, timeout):
        assert gate.exists()
        collected.append(launch)
        return outs

    monkeypatch.setattr(chip_smoke, "_collect", collect)
    monkeypatch.setattr(chip_smoke, "LAUNCHES",
                        {2: ("launch", gate, jobs)})
    monkeypatch.setattr(chip_smoke, "RECORDS", {})
    assert chip_smoke.rank_records(2, "A ") == [{"r": 0}, {"r": 1}]
    assert chip_smoke.rank_records(2, "B ") == [[0], [1]]
    assert chip_smoke.rank_records(2, "JOB_SECONDS ")[0]["B "] == 2.0
    assert collected == ["launch"] and not chip_smoke.LAUNCHES
