"""Prefetching data loader of the online training path (counterpart of
`f_lite_tpu/data/loader.py`): items fetched in a worker pool, collated
into numpy batches, and a bounded prefetch queue that keeps the card fed
while the host fetches and decodes the next batch.

Worker types:
- "thread" (default): fetching is IO-bound and the decode and numpy work
  release the GIL in part; the default for network-backed datasets.
- "process": for decode-bound data. A picklable dataset (`ImageDataset`
  drops its lazy HTTP / S3 clients when pickled) runs in a FORKSERVER
  pool: workers fork from a clean server process with no threads, so they
  cannot inherit a lock held mid-fork by the trainer's threads (the CUDA
  runtime's, PyTorch's); each receives the dataset once, pickled through
  the pool initializer, and never imports the user's `__main__` again
  (`_no_main_reimport`). The server preloads only
  `f_lite_tpu_torch.data.dataset`, which imports no torch, so neither the
  server nor its workers initialize CUDA. Unpicklable datasets (closures,
  local classes) fall back to a fork pool, with a warning.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.machinery
import itertools
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

# per-iteration registry of the fork pool's datasets: each pool's tasks
# carry their own token, so two loaders iterated at once (train and
# validation) never serve each other's items; tokens come from a counter
# (not id(), which CPython reuses) and an entry goes when its pool shuts
# down, so a short-lived loader does not pin its dataset
_FORK_DATASETS: dict[int, object] = {}
_FORK_TOKENS = itertools.count()


def _fork_getitem(token, idx):
    return _FORK_DATASETS[token][idx]


def _fork_child_init():
    # forked children inherit the parent's atexit handlers; running those
    # in a worker can hang the pool's shutdown. Workers only compute items
    import atexit

    atexit._clear()


# forkserver workers: the dataset arrives once through the pool initializer
_WORKER_DATASET = None


def _proc_init(ds_bytes):
    global _WORKER_DATASET
    import pickle

    _WORKER_DATASET = pickle.loads(ds_bytes)


def _proc_getitem(idx):
    return _WORKER_DATASET[idx]


_forkserver_started = False
_FORKSERVER_LOCK = threading.Lock()

_MAIN_SPEC_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_main_reimport():
    """Forkserver children run multiprocessing.spawn.prepare(), which
    imports the parent's __main__ again from its file path: an unguarded
    `python script.py` would run once per worker. Workers need only this
    module and the pickled dataset; naming __main__'s spec literally
    "__main__" makes the child's spawn._fixup_main_from_name return
    before importing anything. Held around every pool call that can spawn
    a worker."""
    main = sys.modules.get("__main__")
    with _MAIN_SPEC_LOCK:
        old = getattr(main, "__spec__", None) if main is not None else None
        if main is not None:
            main.__spec__ = importlib.machinery.ModuleSpec("__main__", None)
        try:
            yield
        finally:
            if main is not None:
                main.__spec__ = old


class _ForkserverPool:
    """ProcessPoolExecutor wrapper that spawns ALL workers at construction
    under _no_main_reimport, so the __spec__ patch happens once, when the
    loader starts, not at every batch. map() applies the patch again only
    where the pool is not fully spawned (the private pre-spawn API is
    missing, or a dead worker is being replaced)."""

    def __init__(self, ex, n_workers):
        self._ex = ex
        self._n = n_workers
        with _no_main_reimport():
            try:
                # one process per call while none are idle (the executor
                # spawns lazily, one per submit, through this method)
                while len(ex._processes) < n_workers:
                    before = len(ex._processes)
                    ex._adjust_process_count()
                    if len(ex._processes) == before:
                        break
            except AttributeError:  # private API changed: lazy spawning
                pass

    def map(self, fn, *iterables):
        if len(getattr(self._ex, "_processes", ())) >= self._n:
            return self._ex.map(fn, *iterables)
        with _no_main_reimport():
            return self._ex.map(fn, *iterables)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self._ex.__exit__(*exc)


def _ensure_clean_forkserver():
    """Start the (singleton) forkserver, preloading the dataset module
    (numpy, no torch) so every worker forks with it imported; __main__ is
    never preloaded or imported again. The JAX package also strips its TPU
    backend's variables from the environment here; CUDA needs no such
    step, since nothing the server imports initializes it."""
    global _forkserver_started
    with _FORKSERVER_LOCK:
        if _forkserver_started:
            return
        import multiprocessing

        # only this module may be preloaded: torch in the server (its
        # at-fork handlers and threads) would bring back the
        # fork-with-threads hazard the forkserver exists to avoid; an
        # ImportError during preload is swallowed by the server
        multiprocessing.set_forkserver_preload(["f_lite_tpu_torch.data.dataset"])
        from multiprocessing import forkserver

        if getattr(forkserver._forkserver, "_forkserver_pid", None):
            import logging

            logging.getLogger(__name__).warning(
                "multiprocessing forkserver was already running before the "
                "DataLoader started it: its workers fork from a server "
                "without the dataset preload, which may have imported "
                "torch; create process-worker loaders before starting your "
                "own forkserver processes")
            _forkserver_started = True
            return
        forkserver.ensure_running()
        _forkserver_started = True


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int | None = None,
        sampler: Iterable | None = None,
        batch_sampler: Iterable | None = None,
        num_workers: int = 4,
        prefetch: int = 2,
        collate_fn=None,
        drop_last: bool = False,
        worker_type: str = "thread",
    ):
        self.drop_last = drop_last
        if batch_sampler is not None and batch_size is not None:
            raise ValueError("pass batch_size or batch_sampler, not both")
        if worker_type not in ("thread", "process"):
            raise ValueError("worker_type must be 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size or 1
        self.sampler = sampler
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.worker_type = worker_type
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn",
                                                _default_collate)

    def _make_pool(self):
        if self.worker_type == "process":
            import multiprocessing
            import pickle
            from concurrent.futures import ProcessPoolExecutor

            try:
                ds_bytes = pickle.dumps(self.dataset,
                                        protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as e:
                ds_bytes = None
                pickle_err = e
            if ds_bytes is not None and b"__main__" in ds_bytes:
                # classes of the user's script pickle by reference to
                # __main__, which forkserver workers never import; fork
                # inherits them through memory
                ds_bytes = None
                pickle_err = (
                    "dataset references __main__-defined classes; move them "
                    "into an importable module to use the (safer) forkserver "
                    "pool")
            if ds_bytes is not None:
                if len(ds_bytes) > 64 << 20:
                    import logging

                    logging.getLogger(__name__).info(
                        "pickled dataset is %.0f MB; it is sent to every "
                        "process worker at each epoch start (forkserver "
                        "workers cannot share parent memory copy-on-write)",
                        len(ds_bytes) / 2**20)
                # the dataset is pickled once per pool, and a pool is made
                # at each __iter__, so set_epoch's state reaches the workers
                _ensure_clean_forkserver()
                ctx = multiprocessing.get_context("forkserver")
                return (
                    _ForkserverPool(
                        ProcessPoolExecutor(self.num_workers, mp_context=ctx,
                                            initializer=_proc_init,
                                            initargs=(ds_bytes,)),
                        self.num_workers),
                    _proc_getitem,
                    None,
                )
            # unpicklable dataset: fork, the dataset inherited through
            # _FORK_DATASETS; unsafe in a threaded parent, hence the
            # warning (once per loader: _make_pool runs at every __iter__)
            if not getattr(self, "_fork_warned", False):
                self._fork_warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "dataset is not picklable (%s); process workers fall back "
                    "to fork, which is unsafe in a multithreaded or "
                    "CUDA-attached parent; make the dataset picklable to use "
                    "the forkserver pool", pickle_err)
            token = next(_FORK_TOKENS)
            _FORK_DATASETS[token] = self.dataset
            ctx = multiprocessing.get_context("fork")
            return (
                ProcessPoolExecutor(self.num_workers, mp_context=ctx,
                                    initializer=_fork_child_init),
                functools.partial(_fork_getitem, token),
                token,
            )
        return ThreadPoolExecutor(self.num_workers), self.dataset.__getitem__, None

    def _batches(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
        else:
            sampler = (self.sampler if self.sampler is not None
                       else range(len(self.dataset)))
            buf = []
            for idx in sampler:
                buf.append(idx)
                if len(buf) == self.batch_size:
                    yield buf
                    buf = []
            if buf and not self.drop_last:
                yield buf

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever: once the consumer has abandoned the
            # iterator (an eval loop's break, max_steps, preemption) the
            # queue stays full, and a bare q.put would pin this thread
            # inside `with pool:`, leaking the pool's workers
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # the pool is made inside the try: an error there must reach
            # the consumer, which would otherwise wait on q.get() forever
            token = None
            try:
                pool, getitem, token = self._make_pool()
                with pool:
                    for batch_idx in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(getitem, batch_idx))
                        if not put(self.collate_fn(items)):
                            return
            except Exception as e:  # a worker's error reaches the consumer
                put(e)
            finally:
                if token is not None:
                    _FORK_DATASETS.pop(token, None)
                put(_END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


_END = object()


def _default_collate(items):
    import numpy as np

    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out
