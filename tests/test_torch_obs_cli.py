"""``--obs`` and ``--profile-dir`` through the port's CLI against the JAX
CLI's.

``mlp`` and a small ``gpt`` (2 layers, width 64) train one epoch with
``--obs --obs-trace --obs-blackbox --metrics-file --profile-dir``: the
sidecar holds JAX's events with JAX's keys, the summary line is logged,
the trace, the metrics file and the profiler's trace are written.  The
losses with telemetry on equal those with it off, bit for bit.  A
planted anomaly that the sentinel contains trips the flight recorder
into the black box JAX's drill leaves.  The flags of items 14(b) and
14(c), refused until they were ported, parse as JAX's CLI parses them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jspec
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.obs import trace as ttrace
from distributed_deep_learning_tpu_torch.utils import chaos as tchaos
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils import profiling as tprof
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tspec
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ARGV = {"mlp": ["-e", "1", "-b", "32", "-d", "cpu"],
        "gpt": ["-l", "2", "-s", "64", "-e", "1", "-b", "8", "-d", "cpu"]}
LIMIT = {"mlp": "96", "gpt": "35"}


def _obs(d, profile=True):
    argv = ["--obs", "--obs-file", str(d / "ev.jsonl"), "--obs-trace",
            str(d / "tr.json"), "--obs-blackbox", str(d / "bb.json"),
            "--metrics-file", str(d / "m.jsonl")]
    return argv + (["--profile-dir", str(d / "prof")] if profile else [])


def _events(path):
    return [json.loads(line) for line in open(path)]


def _jax_init(argv, name):
    cfg = jconfig.parse_args(argv, workload=name)
    spec = jspec(name)
    dataset = spec.build_dataset(cfg)
    x = dataset.features[:1]
    params = spec.build_model(cfg, dataset).init(
        jax.random.key(cfg.seed), jnp.asarray(x))["params"]
    return ttr.load_flax_params(jax.tree.map(np.asarray, params)) \
        if name == "gpt" else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each workload through both CLIs with telemetry (JAX without its
    profiler window), and the port's again without: ``{name: (JAX's
    events, port's events, port's history, port's history off, dir)}``."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, argv in ARGV.items():
            mp.setenv("DDL_DATA_LIMIT", LIMIT[name])
            jd = tmp_path_factory.mktemp(f"jax_{name}")
            td = tmp_path_factory.mktemp(f"port_{name}")
            jbase.run_workload(jspec(name), jconfig.parse_args(
                argv + _obs(jd, profile=False), name))
            init = _jax_init(argv, name)
            kw = {} if init is None else {"init_state_dict": init}
            _, on = tbase.run_workload(
                tspec(name), tconfig.parse_args(argv + _obs(td), name), **kw)
            _, off = tbase.run_workload(
                tspec(name), tconfig.parse_args(argv, name), **kw)
            out[name] = (_events(jd / "ev.jsonl"), _events(td / "ev.jsonl"),
                         on, off, td)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(ARGV))
def test_sidecar_has_jax_events_and_keys(runs, name):
    theirs, mine, _, _, d = runs[name]
    assert [e["event"] for e in mine] == [e["event"] for e in theirs]
    for a, b in zip(mine, theirs):
        assert set(a) == set(b), a["event"]
        if a["event"] in ("obs_goodput", "obs_mfu"):
            assert {k: v for k, v in a.items()
                    if not isinstance(v, (float, dict))} == \
                {k: v for k, v in b.items()
                 if not isinstance(v, (float, dict))} or \
                a["event"] == "obs_mfu", a
    mfu = next(e for e in mine if e["event"] == "obs_mfu")
    assert mfu["step_flops"] > 0 and mfu["device_kind"] == "cpu"
    spans = ttrace.read_chrome_trace(str(d / "tr.json"))
    assert {"compile", "dispatch", "data_wait", "device_sync"} <= \
        {s["name"] for s in spans}
    phases = [json.loads(line)["event"] for line in open(d / "m.jsonl")]
    assert "phase_end" in phases
    assert os.path.exists(tprof.trace_file(str(d / "prof"))) or any(
        f.startswith("trace.") for f in os.listdir(d / "prof"))


@pytest.mark.parametrize("name", list(ARGV))
def test_losses_with_telemetry_equal_without(runs, name):
    _, _, on, off, _ = runs[name]
    assert [(h.phase, h.loss, h.accuracy, h.step_losses) for h in on] == \
        [(h.phase, h.loss, h.accuracy, h.step_losses) for h in off]


def test_contained_anomaly_leaves_jax_black_box(tmp_path):
    mine = tchaos.run_blackbox_drill(0, str(tmp_path / "port.json"))
    theirs = jchaos.run_blackbox_drill(0, str(tmp_path / "jax.json"))
    again = tchaos.run_blackbox_drill(0, str(tmp_path / "again.json"))
    assert mine["dump_sha256"] == again["dump_sha256"]
    for k in ("trips", "events_captured", "faults_fired"):
        assert mine[k] == theirs[k], k
    kinds = [[e["kind"] for e in json.load(open(r["dump_path"]))["events"]]
             for r in (mine, theirs)]
    assert kinds[0] == kinds[1] and "sentinel_anomaly" in kinds[0]


@pytest.mark.parametrize("argv,item", [
    (["--reshard"], "14(b)"), (["--target-mesh", "data=2"], "14(b)"),
    (["--autotune"], "14(c)"), (["--plan", "p.json"], "14(c)")])
def test_resharding_and_tuning_flags_still_raise(argv, item):
    """The flags that raised naming their item (``item``) until it was
    ported now raise only where JAX's CLI refuses them, with its message
    (``--reshard`` without ``--resume``, ``--target-mesh`` without
    ``--reshard``, ``--plan`` of a missing file); ``--autotune`` parses
    to JAX's fields.  No flag is left unported."""
    try:
        theirs = jconfig.parse_args(argv, "gpt")
    except SystemExit as e:
        with pytest.raises(SystemExit) as mine:
            tconfig.parse_args(argv, "gpt")
        assert str(mine.value) == str(e), item
    else:
        mine = tconfig.parse_args(argv, "gpt")
        for field in ("autotune", "plan_file", "reshard", "target_mesh"):
            assert getattr(mine, field) == getattr(theirs, field), field
    assert tconfig.UNPORTED_FLAGS == {} and tconfig.ROADMAP_ITEMS == {}
