"""Parallel job execution with progress reporting.

Rebuild of the reference ExecProgressQueue
(``/root/reference/audiotools/__init__.py:5263-5437``): N independent
jobs (typically one per track) run in forked processes with results
returned over pipes and per-job progress over shared memory.

Forking is for host-bound jobs only.  A JAX process reserves most of
an accelerator's memory when it first touches the card, so jobs whose
work goes to a device run in the parent process, one after another,
sharing its device session (``device_jobs``); on an accelerator the
per-track data parallelism belongs on the device (``parallel.mesh``,
``parallel.farm``).  The queue mirrors the reference CLI semantics
(-j / maximum_jobs, per-file progress rows, fail-fast propagation).
"""

from __future__ import annotations

import multiprocessing
import os
import re
import traceback

# ATPU_FLAC_BACKEND, ATPU_TTA_DEC_BACKEND, ATPU_RG_BACKEND, ...
_BACKEND_VAR = re.compile(r"^ATPU_\w*BACKEND$")


def device_jobs():
    """whether queued jobs may run JAX programs on an accelerator

    True when any ATPU_*BACKEND variable selects "jax", or when the
    encode backend is left to resolve (``flac_enc_fast.default_backend``
    picks "jax") and JAX_PLATFORMS does not pin JAX to the CPU.  Such
    jobs never fork: a forked child would open the card a second time.
    JAX itself is not asked, because starting its runtime here would
    leave threads behind in every forked child; JAX_PLATFORMS=cpu or
    ATPU_FLAC_BACKEND=numpy lets host-only jobs fork."""
    if any(value == "jax" for (key, value) in os.environ.items()
           if _BACKEND_VAR.match(key)):
        return True
    encode = (os.environ.get("ATPU_ALAC_BACKEND") or
              os.environ.get("ATPU_FLAC_BACKEND"))
    if encode:
        return False
    platforms = [p.strip() for p in
                 os.environ.get("JAX_PLATFORMS", "").split(",")
                 if p.strip()]
    return not platforms or any(p != "cpu" for p in platforms)


class ExecProgressQueue:
    """runs one function per queued job in parallel subprocesses"""

    def __init__(self, progress_display):
        self.progress_display = progress_display
        self.queued_jobs = []
        self.results = {}

    def execute(self, function, progress_text=None,
                completion_output=None, *args, **kwargs):
        """queues a job for execution

        function is called with (*args, progress=fn, **kwargs);
        progress_text is shown while running; completion_output is a
        string (or callable on the result) shown when finished"""
        self.queued_jobs.append((progress_text, completion_output,
                                 function, args, kwargs))

    def run(self, max_processes=1):
        """runs all queued jobs, returning results in queue order

        jobs run in this process when device_jobs() holds"""
        if (max_processes <= 1 or len(self.queued_jobs) <= 1 or
                device_jobs()):
            return self.__run_serial__()
        else:
            return self.__run_parallel__(max_processes)

    def __run_serial__(self):
        results = []
        for (job_index,
             (progress_text, completion_output, function,
              args, kwargs)) in enumerate(self.queued_jobs):
            if progress_text is not None:
                row = self.progress_display.add_row(progress_text)
                progress = row.update
            else:
                row = None
                progress = None
            try:
                result = function(*args, progress=progress, **kwargs)
            finally:
                if row is not None:
                    row.finish()
            self.__display_completion__(completion_output, result)
            results.append(result)
        self.queued_jobs = []
        return results

    def __run_parallel__(self, max_processes):
        jobs = list(enumerate(self.queued_jobs))
        results = [None] * len(jobs)
        active = {}
        progress_arrays = {}
        rows = {}

        def launch(job_index, job):
            (progress_text, _completion, function, args, kwargs) = job
            progress_array = multiprocessing.Array("L", 2)
            (parent_conn, child_conn) = multiprocessing.Pipe(False)
            process = multiprocessing.Process(
                target=_run_job,
                args=(child_conn, progress_array, function, args,
                      kwargs))
            # NOT daemonic: daemonic children cannot spawn their own
            # helper processes; the parent joins every child, so
            # nothing leaks
            process.start()
            active[job_index] = (process, parent_conn)
            progress_arrays[job_index] = progress_array
            if progress_text is not None:
                rows[job_index] = self.progress_display.add_row(
                    progress_text)

        pending = jobs[:]
        error = None

        while pending or active:
            while pending and (len(active) < max_processes):
                (job_index, job) = pending.pop(0)
                launch(job_index, job)

            # poll progress and completion
            finished = []
            for (job_index, (process, conn)) in list(active.items()):
                array = progress_arrays[job_index]
                if job_index in rows:
                    rows[job_index].update(array[0], array[1])
                if conn.poll(0.05):
                    (ok, payload) = conn.recv()
                    process.join()
                    if job_index in rows:
                        rows[job_index].finish()
                        del rows[job_index]
                    if ok:
                        results[job_index] = payload
                        self.__display_completion__(
                            self.queued_jobs[job_index][1], payload)
                    else:
                        error = payload
                        pending = []
                    finished.append(job_index)
            for job_index in finished:
                del active[job_index]

            if error is not None:
                # drain remaining processes then re-raise the child's
                # original exception (reference __init__.py:5394-5402)
                for (process, conn) in active.values():
                    process.terminate()
                    process.join()
                active.clear()
                if isinstance(error, BaseException):
                    raise error
                raise ExecQueueError(error)

        self.queued_jobs = []
        return results

    def __display_completion__(self, completion_output, result):
        if completion_output is None:
            return
        if callable(completion_output):
            output = completion_output(result)
        else:
            output = completion_output
        if output is not None:
            self.progress_display.output_line(str(output))


class ExecQueueError(Exception):
    """raised when a queued job fails; carries the child traceback"""


def _run_job(conn, progress_array, function, args, kwargs):
    def progress(current, total):
        progress_array[0] = int(current)
        progress_array[1] = int(total)

    try:
        result = function(*args, progress=progress, **kwargs)
        conn.send((True, result))
    except Exception as err:
        # ship the original exception object so the parent can
        # re-raise it by type (the reference pickles the child
        # exception back to the parent); fall back to the traceback
        # text when the exception isn't picklable
        try:
            conn.send((False, err))
        except Exception:
            conn.send((False, traceback.format_exc()))
