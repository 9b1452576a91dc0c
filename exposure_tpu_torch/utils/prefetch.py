"""Asynchronous producer with a bounded ready queue (a copy of
``exposure_tpu/utils/prefetch.py``).

A daemon thread keeps up to ``slots`` results of ``target(*args,
**kwargs)`` ready; ``get_next()`` hands the oldest over and wakes the
producer.  An exception raised by ``target`` is raised again in the
consumer by the ``get_next()`` that reaches it.  The streaming trainer
feeds its one producer the schedule's bundles in order
(``core/streaming.py``), so the providers' random streams are used by one
thread only."""

import queue
import threading


class AsyncPrefetcher:

    def __init__(self, target, args=(), kwargs=None, slots=1):
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self._queue = queue.Queue(maxsize=max(int(slots), 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                result = (None, self._target(*self._args, **self._kwargs))
            except Exception as e:  # surface in the consumer thread
                result = (e, None)
            while not self._stop.is_set():
                try:
                    self._queue.put(result, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get_next(self):
        err, value = self._queue.get()
        if err is not None:
            raise err
        return value

    def stop(self, timeout=30.0):
        """Stop the producer and join its thread; raises ``RuntimeError``
        when ``target`` is still running after ``timeout`` seconds."""
        self._stop.set()
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError('the prefetch thread did not stop within '
                               '%g s' % timeout)
