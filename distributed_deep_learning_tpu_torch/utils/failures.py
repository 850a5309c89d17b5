"""Host-level failure detection: the port of
``distributed_deep_learning_tpu/utils/failures.py``.

Each process runs a :class:`Heartbeat` thread that rewrites
``<dir>/hb-<rank>`` every ``interval`` seconds (``dir`` on a file system
every host sees).  :func:`detect_failures` lists the ranks whose beat is
stale by the file system's own clock (:func:`fs_now` against the beat
file's mtime, so two hosts' clocks are never compared), and
:class:`FailureMonitor` polls it on a thread and records a
:class:`WorkerFailure` for the training loop to raise before its next
step, instead of waiting on a dead collective.  A transient ``OSError``
of the scan is tolerated up to a limit (:class:`FlakyIOPolicy`), then the
monitor reports itself unhealthy (:class:`MonitorUnhealthy`).

Two fault-injection hooks rehearse the recovery path:
``DDL_INJECT_FAILURE="<rank>:<epoch>"`` and
``DDL_INJECT_STEP_FAILURE="<rank>:<step>"`` raise one ``RuntimeError``
on that process rank (``all``: every rank) at the start of that epoch or
right after that global train step.  The rank is the
``torch.distributed`` rank (0 outside a process group).
"""

from __future__ import annotations

import os
import threading
import time


class WorkerFailure(RuntimeError):
    """Raised by FailureMonitor when peers stop heartbeating."""

    def __init__(self, dead_ranks: list[int]):
        self.dead_ranks = dead_ranks
        super().__init__(f"worker(s) {dead_ranks} missed heartbeat deadline")


def _hb_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"hb-{rank}")


class Heartbeat:
    """Daemon thread stamping this process's liveness file."""

    def __init__(self, directory: str, rank: int, interval: float = 5.0):
        self.directory = os.fspath(directory)
        self.rank = rank
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat_once(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = _hb_path(self.directory, self.rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"{time.time():f}\n")
        os.replace(tmp, path)  # atomic on POSIX

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat_once()

    def start(self) -> "Heartbeat":
        self.beat_once()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def last_beat(directory: str, rank: int) -> float | None:
    """The timestamp WRITTEN INSIDE `rank`'s beat file (its own clock).

    Debug info only: cross-host clock skew makes it useless for staleness
    decisions — a writer whose clock runs minutes behind would look dead,
    one running ahead would look alive long after it hung.  Staleness uses
    :func:`beat_mtime` (the shared filesystem's clock) instead."""
    try:
        with open(_hb_path(directory, rank)) as f:
            return float(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def beat_mtime(directory: str, rank: int) -> float | None:
    """mtime of `rank`'s beat file — stamped by the SHARED filesystem at
    each beat, so every reader compares against one clock."""
    try:
        return os.stat(_hb_path(directory, rank)).st_mtime
    except FileNotFoundError:
        return None


def fs_now(directory: str) -> float:
    """The shared filesystem's current clock, read by touching a probe
    file and statting its mtime — the same clock that stamps the beats,
    so staleness arithmetic never mixes two hosts' clocks.  Falls back to
    the local clock if the directory is unwritable (the monitor's I/O
    tolerance handles persistent failures)."""
    path = os.path.join(directory, f".clock-probe-{os.getpid()}")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w"):
            pass
        os.utime(path)
        return os.stat(path).st_mtime
    except OSError:
        return time.time()


def detect_failures(directory: str, world_size: int, timeout: float,
                    now: float | None = None,
                    grace_ranks: tuple[int, ...] = ()) -> list[int]:
    """Ranks whose heartbeat is older than `timeout` (or absent).

    Age = shared-FS "now" (:func:`fs_now`) minus the beat file's mtime —
    one clock on both sides.  Comparing the reader's ``time.time()``
    against a timestamp another host WROTE (the old scheme) let cross-host
    clock skew fake deaths or hide real ones.  ``now`` overrides the probe
    for tests."""
    now = fs_now(directory) if now is None else now
    dead = []
    for rank in range(world_size):
        if rank in grace_ranks:
            continue
        beat = beat_mtime(directory, rank)
        if beat is None or now - beat > timeout:
            dead.append(rank)
    return dead


class MonitorUnhealthy(RuntimeError):
    """The failure monitor itself stopped working (persistent I/O errors
    against the heartbeat directory) — distinct from "a peer died" so the
    loop can react to BOTH instead of training blind."""


class FlakyIOPolicy:
    """Consecutive-I/O-error tolerance, shared by every flaky-IO watcher
    (the heartbeat monitor here, the checkpoint-watch path in
    ``serve/reload``).

    A transient ``OSError`` says nothing about the thing being watched —
    tolerate up to ``tolerance`` CONSECUTIVE failures, then declare the
    WATCHER unhealthy (:class:`MonitorUnhealthy`) instead of silently
    retrying forever or dying quietly.  One policy object per watcher;
    one set of semantics for all of them."""

    def __init__(self, tolerance: int = 3, what: str = "scan"):
        if tolerance < 1:
            raise ValueError(f"tolerance must be >= 1, got {tolerance}")
        self.tolerance = int(tolerance)
        self.what = what
        self.consecutive = 0

    def note_success(self) -> None:
        self.consecutive = 0

    def note_error(self, exc: BaseException) -> MonitorUnhealthy | None:
        """Record one failure; returns the :class:`MonitorUnhealthy` to
        latch once the tolerance is exhausted (None while tolerating)."""
        self.consecutive += 1
        if self.consecutive >= self.tolerance:
            return MonitorUnhealthy(
                f"{self.what} failed {self.consecutive} consecutive "
                f"times ({type(exc).__name__}: {exc}); monitoring "
                "stopped")
        return None

    def reset(self) -> None:
        self.consecutive = 0


class FailureMonitor:
    """Background watcher raising :class:`WorkerFailure` via a callback (or
    recording it for polling) when any peer goes stale.

    A transient shared-FS hiccup (an ``OSError`` from the heartbeat scan)
    is tolerated up to ``io_error_tolerance`` CONSECUTIVE polls; beyond
    that a :class:`MonitorUnhealthy` is recorded — previously the thread
    died silently and monitoring stopped with no signal.  ``healthy``
    distinguishes "monitor alive, no failures" from "monitor dead"."""

    def __init__(self, directory: str, world_size: int, *,
                 timeout: float = 30.0, poll_interval: float = 5.0,
                 self_rank: int | None = None,
                 io_error_tolerance: int = 3):
        self.directory = os.fspath(directory)
        self.world_size = world_size
        self.timeout = timeout
        self.poll_interval = poll_interval
        self.grace = (self_rank,) if self_rank is not None else ()
        self.io_error_tolerance = io_error_tolerance
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._io = FlakyIOPolicy(io_error_tolerance,
                                 what="heartbeat scan")
        self.failure: Exception | None = None

    def check(self) -> None:
        """Raise immediately if any peer is stale (poll-style use)."""
        dead = detect_failures(self.directory, self.world_size, self.timeout,
                               grace_ranks=self.grace)
        if dead:
            raise WorkerFailure(dead)

    @property
    def healthy(self) -> bool:
        """True while monitoring is actually happening.

        False once a failure is recorded OR the background thread stopped
        without being asked to (crash, I/O give-up) — the loop can then
        tell "monitor dead" from "no failures so far"."""
        if self.failure is not None:
            return False
        if self._thread is None:  # poll-style use: check() does the work
            return True
        return self._thread.is_alive() or self._stop.is_set()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.check()
                self._io.note_success()
            except WorkerFailure as e:  # record; training thread polls
                self.failure = e
                return
            except OSError as e:
                # shared-FS hiccup: the scan failed, which says nothing
                # about the PEERS — retry, but never silently forever
                unhealthy = self._io.note_error(e)
                if unhealthy is not None:
                    self.failure = unhealthy
                    return

    def start(self) -> "FailureMonitor":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="failure-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_interval)

    def reset(self) -> None:
        """Clear a recorded failure and resume monitoring — the elastic
        retry path: the replacement worker is expected to heartbeat again,
        and a latched failure from the dead attempt must not condemn every
        subsequent one.  Restarts the background thread only if it had
        been started (and died) before."""
        self.failure = None
        self._io.reset()
        if self._thread is not None and not self._thread.is_alive() \
                and not self._stop.is_set():
            self.start()

    def raise_if_failed(self) -> None:
        if self.failure is not None:
            raise self.failure

    def __enter__(self) -> "FailureMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_injected = False
_step_injected = False


def process_rank() -> int:
    """This process's ``torch.distributed`` rank (0 outside a group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def maybe_inject_step_failure(global_step: int) -> None:
    """Step-granular chaos hook: ``DDL_INJECT_STEP_FAILURE="<rank>:<step>"``
    raises ONE ``RuntimeError`` right after that global train step on that
    rank (or ``all``): the mid-epoch preemption drill for
    ``--checkpoint-every`` (recovery costs at most N steps)."""
    global _step_injected
    spec = os.environ.get("DDL_INJECT_STEP_FAILURE")
    if not spec or _step_injected:
        return
    parts = spec.split(":")
    if len(parts) != 2 or (parts[0] != "all" and not parts[0].isdigit()) \
            or not parts[1].isdigit():
        raise ValueError(
            f"DDL_INJECT_STEP_FAILURE={spec!r}: expected '<rank>:<step>' "
            "with rank a process index or 'all', e.g. '1:5' or 'all:5'")
    rank_s, step_s = parts
    rank = process_rank()
    hit = rank_s == "all" or rank == int(rank_s)
    if hit and global_step == int(step_s):
        _step_injected = True
        import sys

        print(f"CHAOS: injected failure on rank {rank} "
              f"at step {step_s}", file=sys.stderr, flush=True)
        raise RuntimeError(
            f"injected failure (DDL_INJECT_STEP_FAILURE={spec}) on rank "
            f"{rank} at step {step_s}")


def maybe_inject_failure(epoch: int) -> None:
    """Fault-injection hook: ``DDL_INJECT_FAILURE="<rank>:<epoch>"``
    raises ONE ``RuntimeError`` at the start of that epoch on that rank
    (``all``: every rank), for :func:`..train.elastic.fit_with_recovery`
    to catch and recover from."""
    global _injected
    spec = os.environ.get("DDL_INJECT_FAILURE")
    if not spec or _injected:
        return
    # "<rank>:<epoch>" with rank a number or "all" (pod preemption drill);
    # validate eagerly — a malformed spec must be one clear error, not a
    # cryptic crash at the start of every epoch (and recovery churn under
    # --elastic, which would catch-and-retry into the same parse failure)
    parts = spec.split(":")
    if len(parts) != 2 or (parts[0] != "all" and not parts[0].isdigit()) \
            or not parts[1].isdigit():
        raise ValueError(
            f"DDL_INJECT_FAILURE={spec!r}: expected '<rank>:<epoch>' with "
            "rank a process index or 'all', e.g. '1:2' or 'all:2'")
    rank_s, epoch_s = parts
    rank = process_rank()
    hit = rank_s == "all" or rank == int(rank_s)
    if hit and epoch == int(epoch_s):
        _injected = True
        import sys

        # stderr, not the PhaseLogger: non-coordinator ranks log nothing,
        # but the drill must be visible in every rank's output
        print(f"CHAOS: injected failure on rank {rank} "
              f"at epoch {epoch_s}", file=sys.stderr, flush=True)
        raise RuntimeError(
            f"injected failure (DDL_INJECT_FAILURE={spec}) on rank "
            f"{rank} at epoch {epoch_s}")
