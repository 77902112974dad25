"""The engine's FIFO step lock when a waiter's wait dies.

A waiter whose ``Condition.wait`` raises (a KeyboardInterrupt in
``cancel`` or ``generate``) must give its ticket up: otherwise the lock
is never passed past it and every later ``acquire``, the worker's next
step included, blocks forever.  The waiters that remain still get the
lock in arrival order.
"""
import threading
import time

import pytest
import torch_threads  # noqa: F401

from paddle_tpu_torch.generation.engine import _FifoLock


class _Interrupted(BaseException):
    """Stands in for a KeyboardInterrupt raised inside the wait."""


def _fail_first_wait(lock, thread_name, served):
    """Make one ``Condition.wait`` of the thread named `thread_name`
    raise: its first (the waiter dies while the lock is held), or with
    `served` the first that returns with the lock handed to it (the wait
    dies just as its turn comes)."""
    real = lock._cond.wait
    fired = []

    def wait(timeout=None):
        mine = threading.current_thread().name == thread_name
        if mine and not fired and not served:
            fired.append(1)
            raise _Interrupted()
        out = real(timeout)
        if mine and not fired and served and lock._serving == 1:
            fired.append(1)
            raise _Interrupted()
        return out

    lock._cond.wait = wait


def _queue(lock, name, order, errors):
    """Start a thread that acquires, records its name, and releases."""
    def run():
        try:
            lock.acquire()
        except _Interrupted:
            errors.append(name)
            return
        order.append(name)
        lock.release()

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    return t


def _wait_for_tickets(lock, n, timeout=2.0):
    end = time.monotonic() + timeout
    while lock._tickets < n:
        if time.monotonic() > end:
            raise AssertionError(f"{lock._tickets} tickets, want {n}")
        time.sleep(0.001)


@pytest.mark.parametrize("served", [False, True],
                         ids=["waiting", "served_as_it_died"])
def test_a_dead_wait_gives_its_ticket_up(served):
    """A waiter dies in its wait, either while the lock is still held
    (its ticket is skipped later) or just as the lock reaches it (it
    passes the lock on): the waiters behind it take the lock in arrival
    order, and the next acquire returns within 2 s."""
    lock = _FifoLock()
    order, errors = [], []
    _fail_first_wait(lock, "A", served)
    lock.acquire()                              # ticket 0: this thread
    threads = []
    for n, name in enumerate(("A", "B", "C"), start=2):
        threads.append(_queue(lock, name, order, errors))
        _wait_for_tickets(lock, n)              # tickets 1, 2, 3 in order
    lock.release()
    for t in threads:
        t.join(2)
        assert not t.is_alive(), "the lock wedged behind a dead waiter"
    assert errors == ["A"] and order == ["B", "C"]
    got = []
    t = threading.Thread(target=lambda: got.append(lock.acquire()),
                         daemon=True)
    t.start()
    t.join(2)
    assert got == [True], "the next acquire did not return within 2 s"
    lock.release()


def test_interrupted_waiters_under_contention_keep_order_and_exclusion():
    """Stress: 16 threads (more than the cores) take the lock 40 times
    each while every 5th wait dies, with a short switch interval: no
    update is lost (one holder at a time), every thread finishes, and the
    lock is still free to take."""
    import sys

    lock = _FifoLock()
    real = lock._cond.wait
    calls = [0]

    def flaky(timeout=None):
        calls[0] += 1           # under the condition's lock
        if calls[0] % 5 == 0:
            raise _Interrupted()
        return real(timeout)

    lock._cond.wait = flaky
    state = {"counter": 0, "held": 0, "overlap": 0}
    done = [0] * 16

    def work(k):
        while done[k] < 40:
            try:
                lock.acquire()
            except _Interrupted:
                continue
            try:
                state["held"] += 1
                if state["held"] > 1:
                    state["overlap"] += 1
                c = state["counter"]
                time.sleep(0)
                state["counter"] = c + 1
                state["held"] -= 1
            finally:
                lock.release()
            done[k] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(16)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a waiter wedged"
    assert state["overlap"] == 0
    assert state["counter"] == sum(done) == 16 * 40
    assert calls[0] >= 5                  # interruptions really happened
    got = []
    t = threading.Thread(target=lambda: got.append(lock.acquire()),
                         daemon=True)
    t.start()
    t.join(2)
    assert got == [True]
    lock.release()
