"""Ranks of a run, one spawned process a rank, rank r on card r.

Only the standard library is imported here, so that the process that prints the result
can start the ranks before it imports torch itself: the imports, which take seconds each,
then run at once.  A rank's work is named by its module and function (``"module:name"``)
and imported in the rank.  The ranks meet through a file store in a directory of their
own under the temporary directory (``TMPDIR``), removed when they have ended, in a gloo
group that carries the barriers and the few objects the ranks agree on; a store on a TCP
port chosen beforehand could find the port taken by the time it listens.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback


def _rank(r, n, store, device, target, args, results):
    """Rank r of n: join the group, take card r (or the CPU), run ``target(r, device,
    *args)`` and report (rank, ok, its record or the traceback) to ``results``."""
    import datetime

    import torch
    import torch.distributed as tdist

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        tdist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                                 world_size=n, timeout=datetime.timedelta(seconds=300))
        if device == "cuda":
            torch.cuda.set_device(r)
            dev = torch.device("cuda", r)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        results.put((r, True, fn(r, dev, *args)))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        results.put((r, False, traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


class Ranks:
    """n ranks started on ``target`` with ``args``; ``collect`` their records, then
    ``stop`` them (always: it ends every rank still running and waits for each)."""

    def __init__(self, target: str, n: int, args: tuple, device: str = "cuda"):
        ctx = multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self.tmp = tempfile.mkdtemp(prefix="cgbench_ranks_")
        store = os.path.join(self.tmp, "store")
        self.procs = [ctx.Process(target=_rank,
                                  args=(r, n, store, device, target, args, self.results))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def collect(self, deadline: float) -> list:
        """Every rank's record, in rank order; raises when a rank failed or died, or at the
        deadline (``time.time()``)."""
        got = {}
        while len(got) < len(self.procs):
            try:
                r, ok, payload = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(self.procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "before it reported") from None
                if time.time() > deadline:
                    raise RuntimeError("the ranks did not report by their deadline") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{payload}")
            got[r] = payload
        return [got[r] for r in range(len(self.procs))]

    def stop(self, kill: bool = False) -> None:
        """Wait for every rank to end (at most 30 s each, or none with ``kill``), ending
        those still running."""
        for p in self.procs:
            if p.is_alive() and not kill:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join()
        self.results.close()
        shutil.rmtree(self.tmp, ignore_errors=True)
