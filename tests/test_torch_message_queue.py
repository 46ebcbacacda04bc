"""The analyzer's message queue (``analyzer/engine.py::MessageQueue``): a
block's messages go in with one hand-off, ``poll()`` takes everything
queued under one lock, and ``read(timeout)`` takes one message or
returns None when the time runs out.  Order is FIFO across single and
batched puts from any thread, and nothing is lost or given twice."""

from __future__ import annotations

import sys
import threading
import time

from sigdigger_tpu_torch.analyzer.engine import MessageQueue


def producer(q: MessageQueue, tag: str, n: int, batch: int) -> None:
    """Put (tag, 0..n-1) in order, alternating a single put and a batch
    of ``batch``."""
    i = 0
    while i < n:
        q.put((tag, i))
        i += 1
        run = [(tag, j) for j in range(i, min(n, i + batch))]
        assert q.put_many(run) == (1 if run else 0)
        i += len(run)


def test_fifo_across_single_and_batched_puts_from_two_threads():
    q = MessageQueue()
    threads = [threading.Thread(target=producer, args=(q, t, 3000, b))
               for t, b in (("a", 7), ("b", 64))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    got = q.get_all()
    assert len(got) == 6000
    for tag in "ab":
        assert [i for t, i in got if t == tag] == list(range(3000))
    # on one thread, single and batched puts keep their order
    q.put(("x", 0))
    q.put_many([("x", 1), ("x", 2)])
    q.put(("x", 3))
    assert q.get_all() == [("x", i) for i in range(4)]


def test_poll_returns_each_message_once():
    q = MessageQueue()
    q.put_many(list(range(5)))
    q.put(5)
    assert q.get(0.0) == 0
    assert q.get_all() == [1, 2, 3, 4, 5]
    assert q.get_all() == []
    assert q.put_many([]) == 0 and q.get_all() == []


def test_read_wakes_on_a_batched_put_and_times_out_empty():
    q = MessageQueue()
    t0 = time.monotonic()
    assert q.get(0.05) is None
    assert time.monotonic() - t0 >= 0.05
    assert q.get(0.0) is None
    got = []
    readers = [threading.Thread(target=lambda: got.append(q.get(10.0)))
               for _ in range(2)]
    for r in readers:
        r.start()
    time.sleep(0.05)
    q.put_many(["m0", "m1", "m2"])
    for r in readers:
        r.join(timeout=10.0)
        assert not r.is_alive()
    # both waiting readers woke on the one batch, each with one message
    assert sorted(got) == ["m0", "m1"]
    assert q.get_all() == ["m2"]


def test_analyzer_read_and_poll_go_through_the_queue():
    from sigdigger_tpu_torch.analyzer.engine import Analyzer
    from sigdigger_tpu_torch.analyzer.messages import MessageKind
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources import SynthBandSource
    from sigdigger_tpu_torch.types import AnalyzerParams

    an = Analyzer(source=SynthBandSource(SourceProfile(
        type="synth", sample_rate=256_000), []),
        params=AnalyzerParams(window_size=1024), device="cpu")
    assert [m.kind for m in an.poll()] == [MessageKind.SOURCE_INFO]
    assert an.read(timeout=0.01) is None
    an._emit("one")
    an._mq.put_many(["two", "three"])
    assert an.read(timeout=0.01) == "one"
    assert an.poll() == ["two", "three"]
    assert an.poll() == []


def test_stress_loses_and_duplicates_nothing():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        q = MessageQueue()
        n, producers = 4000, 6
        threads = [threading.Thread(target=producer,
                                    args=(q, str(k), n, 1 + 5 * k))
                   for k in range(producers)]
        seen: list[list] = [[], [], []]
        done = threading.Event()

        def reader(k: int) -> None:
            while not done.is_set() or q._items:
                if k == 0:
                    seen[k].extend(q.get_all())
                else:
                    m = q.get(0.001)
                    if m is not None:
                        seen[k].append(m)

        readers = [threading.Thread(target=reader, args=(k,))
                   for k in range(3)]
        for t in threads + readers:
            t.start()
        for t in threads:
            t.join(timeout=50.0)
            assert not t.is_alive()
        done.set()
        for r in readers:
            r.join(timeout=5.0)
            assert not r.is_alive()
    finally:
        sys.setswitchinterval(interval)
    got = [m for s in seen for m in s]
    assert len(got) == n * producers
    assert set(got) == {(str(k), i) for k in range(producers)
                        for i in range(n)}
    # each reader saw each producer's messages in the order put
    for s in seen:
        for k in range(producers):
            mine = [i for t, i in s if t == str(k)]
            assert mine == sorted(mine)
