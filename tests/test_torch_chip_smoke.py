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
from pathlib import Path

import pytest

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
              20: "phase_window", 15: "phase_cli_spec_quant"}


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
    for name, value in (
            ("phase_device", None), ("start_builds", {}),
            ("phase_kernel", {}), ("phase_serve", (rec, 0)),
            ("phase_quant_serving", 0), ("phase_spec", 0),
            ("phase_window", 0), ("_write_tokens", ROOT),
            ("phase_train_bf16", (None, None, None)),
            ("phase_post_train_serving", 0),
            ("phase_cli_spec_quant", {"launches": 0}),
            ("phase_fused_head", {}), ("phase_optimizers", {})):
        monkeypatch.setattr(chip_smoke, name, stub(name, value))
    assert chip_smoke.main(["--phases", str(phase)]) == 0
    assert NEW_PHASES[phase] in called
    assert "range(1, 21)" in inspect.getsource(chip_smoke.main)


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
