"""The port's own instruments: counters, and spans on the clock of
torch.profiler's trace.

Counters (`counter(name)`, one registry) always count: the CUDA kernels'
launches (`ops/cuda/flash_attention.py`, `int8_gemm.py`,
`flash_variants.py` bind theirs here) and the trainer's loader wait in
seconds (`waits`). Nothing resets them but a test.

Spans (`with span(name, index=i):`) mark where the work happens: the
pipeline's phases, the sampler's steps, the DiT's parts and elementwise
ops, the training step's loss, backward and optimizer. They are kept only
while `recording()` is open, in memory, and handed over when it closes;
with none open a span is one global read and a shared no-op. A span never
synchronises or records a CUDA event: it times the host issuing work.

Each span keeps its name, start and end, its parent, the root of its tree
(a request or a training step) and the OS thread it ran on. A span opened
on a thread with no span open (the autograd engine's, which runs
checkpointed blocks again in the backward) takes as parent the innermost
span open on the thread that opened the recording. Times are Unix-epoch
nanoseconds: the monotonic clock moved by one (wall, monotonic) pair read
when the recording opens, the mapping torch.profiler's kineto events use,
so a span and the runtime launches and kernels it caused share one
timeline. `chrome_events` gives them as a track of a Chrome trace (the
trainer's `--profile_steps`); `portbench/spans.py` puts a profiled
window's kernels and idle gaps down to them.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import NamedTuple


class Counter:
    """A running count: kernel launches, or seconds."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


COUNTERS: dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The registry's counter `name`, made at its first use."""
    return COUNTERS.setdefault(name, Counter())


class Span(NamedTuple):
    """One finished span, times in Unix-epoch ns."""

    id: int
    name: str
    attrs: dict
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int


class Recording:
    """The spans of one `recording()`: `spans`, filled when it closes."""

    def __init__(self):
        self.spans: list[Span] = []
        # finished spans as plain tuples of numbers and strings, which the
        # garbage collector stops tracking: thousands a step add no work
        # to its collections; ids, parents and roots are found at the close
        self._done: list[tuple] = []
        self._local = threading.local()
        self.thread = self._thread()
        self._wall_ns, self._mono_ns = time.time_ns(), time.perf_counter_ns()

    def _thread(self) -> int:
        """This thread's OS id, looked up once a thread: it is a system call."""
        try:
            return self._local.id
        except AttributeError:
            tid = self._local.id = threading.get_native_id()
            return tid

    def _close(self) -> None:
        """Number the finished spans by start and nest them: within a thread
        by their intervals, and a span with nothing open around it on its
        thread under the innermost span open then on the recording's thread."""
        shift = self._wall_ns - self._mono_ns
        open_on: dict = {}  # thread -> its stack of open spans
        starts, main = [], []  # the recording thread's spans, by start
        spans = []
        for sid, (name, attrs, thread, start, end) in enumerate(
                sorted(self._done, key=lambda t: (t[3], -t[4])), 1):
            start, end = start + shift, end + shift
            stack = open_on.setdefault(thread, [])
            while stack and stack[-1].end_ns < start:
                stack.pop()
            outer = stack[-1] if stack else None
            if outer is None and thread != self.thread:
                outer = _innermost(starts, main, spans, start)
            span = Span(sid, name, attrs, outer and outer.id, outer.root if outer else sid,
                        thread, start, end)
            stack.append(span)
            spans.append(span)
            if thread == self.thread:
                starts.append(start)
                main.append(span)
        self.spans = spans


def _innermost(starts: list, main: list, spans: list, t: int):
    """The innermost of `main` (one thread's spans, ordered by `starts`)
    open at `t`: the last started by then, or its first ancestor still
    open (`spans[id - 1]` is span `id`)."""
    i = bisect.bisect_right(starts, t)
    s = main[i - 1] if i else None
    while s is not None and s.end_ns < t:
        s = spans[s.parent - 1] if s.parent else None
    return s


class _Open:
    __slots__ = ("done", "name", "attrs", "thread", "start")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.done, self.name, self.attrs, self.thread = rec._done, name, attrs, rec._thread()

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.done.append((self.name, self.attrs, self.thread, self.start,
                          time.perf_counter_ns()))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording: Recording | None = None


def span(name: str, **attrs):
    """A context manager timing the block as span `name` (with `attrs`,
    such as a step or block index) while a recording is open."""
    rec = _recording
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs)


@contextlib.contextmanager
def recording():
    """Keep every span for the extent of the block; yields the Recording,
    whose `spans` are filled at the block's end. One at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a span recording is already open")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec._close()


def waits(iterable, name: str):
    """`iterable`'s items; each wait for the next is span `name`, and its
    seconds add to counter `name`."""
    clock = counter(name)
    it = iter(iterable)
    while True:
        with span(name):
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                clock.count += time.perf_counter() - t
        yield item


def chrome_events(rec: Recording, base_ns: int = 0) -> list:
    """The recording's spans as Chrome-trace complete events on their own
    track (one row per thread), `ts` in microseconds from `base_ns` (a
    torch.profiler trace's `baseTimeNanoseconds`)."""
    return [{"ph": "X", "cat": "span", "name": s.name, "pid": "program spans", "tid": s.thread,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "root": s.root, **s.attrs}}
            for s in rec.spans]
