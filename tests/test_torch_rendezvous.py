"""How the port's ranks find one another (``runtime.bootstrap``,
``runtime.launch``).

A launch's rendezvous store is bound, on a port the OS picks, by the
launcher before any rank starts, and held until the ranks end: two
launches, or anything else on the host, cannot take the port in between
(the parent tree's launcher chose a free port, closed it and let rank 0
bind it seconds later; a port taken in that gap left the ranks waiting
in the rendezvous until the test's kill).  A rendezvous that cannot
complete raises within its timeout, naming its address and port.
"""

import socket
import threading
import time

import pytest

from distributed_deep_learning_tpu_torch.runtime import bootstrap
from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


def _unused_port() -> int:
    """A port no one listens on (bound here without ``listen``)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    _unused_port.keep.append(s)
    return s.getsockname()[1]


_unused_port.keep = []


@pytest.mark.parametrize("case", ["no store", "no peer"])
def test_a_broken_rendezvous_raises_within_its_timeout(case, monkeypatch):
    """Rank 1 of 2 whose store never answers, and rank 0 of 2 in a
    launcher's store whose peer never comes: each raises within the
    timeout (here 2 s), naming the store's address and port."""
    monkeypatch.setattr(bootstrap, "RENDEZVOUS_TIMEOUT", 2.0)
    store = None
    if case == "no store":
        port, rank = _unused_port(), 1
        monkeypatch.delenv(bootstrap.HOSTED, raising=False)
    else:
        store = bootstrap.host_store()
        port, rank = store.port, 0
        monkeypatch.setenv(bootstrap.HOSTED, "1")
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=rf"rendezvous at tcp://127\.0\.0\.1:{port} "
                             r"failed within 2 s"):
        bootstrap.initialize("cpu")
    # the client retries its connection once past the timeout
    assert time.monotonic() - t0 < 30
    del store


def test_launches_hold_their_own_stores():
    """Each launcher's store has its own port, bound while it lives, and
    the ranks' environment points at it."""
    a, b = bootstrap.host_store(), bootstrap.host_store()
    assert a.port != b.port
    with socket.socket() as s, pytest.raises(OSError):
        s.bind(("127.0.0.1", a.port))
    env = bootstrap.hosted_env(a)
    assert env == {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(a.port),
                   bootstrap.HOSTED: "1"}


def test_concurrent_launches_each_meet_in_their_own_store():
    """Three two-rank launches at once, each of whose ranks rendezvous
    twice in one process (a key prefix a group): every rank of every
    launch sums its own launch's ranks, 1 + 2, twice."""
    results = [None] * 3

    def one(i):
        results[i] = launch_local(2, [], device="cpu", timeout=120,
                                  module="tests.helpers.twice_rank")

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in results:
        assert got is not None
        for res in got:
            assert "SUMS [3, 3] created True" in res.stdout, res.stdout
