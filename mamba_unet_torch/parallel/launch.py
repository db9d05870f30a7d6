"""Run a function on several ranks of a fresh ``torch.distributed`` group.

:func:`run_ranks` spawns ``world`` processes (the ``spawn`` start method:
no forked CUDA or thread state), each pinned to one intra-op thread; each
joins a process group at ``tcp://localhost:<a free port>`` and calls
``fn(rank, world, *args)``; the results come back in rank order. A rank's
exception is raised here with its traceback. :class:`Ranks` starts them
side by side, in threads, and returns at once, so that the caller works
while they start and run (a spawned child reads its pickled arguments
only once it has imported torch, and ``start()`` waits for that). ``fn``
must be importable from a module that the ranks can import (its module
is imported again in each rank), and its arguments and results
picklable. A rank hands its result over through a file in a temporary
directory (``tempfile``'s, so ``TMPDIR``'s), not through the queue's
pipe, which carries a few GB of arrays an order of magnitude slower.

The group is ``gloo``: it runs the ranks on the CPU, or several ranks on
one card (NCCL refuses two ranks on one device); the train CLI under
``torchrun`` takes ``nccl`` with one card per rank.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import socket
import tempfile
import threading
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn: Callable, args: tuple,
               results, spill: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(spill, f"rank{rank}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        results.put((rank, True, path))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


class Ranks:
    """``world`` spawned ranks of one ``gloo`` process group, each running
    ``fn(rank, world, *args)``; :meth:`result` collects their results."""

    def __init__(self, world: int, fn: Callable, *args):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.name = world, fn.__name__
        self._results = ctx.Queue()
        self._spill = tempfile.TemporaryDirectory(prefix="ranks-")
        port = free_port()
        # daemons: a caller that fails while they run ends them as it exits
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, port, fn, args,
                                         self._results, self._spill.name),
                                   daemon=True)
                       for r in range(world)]
        self._start_errors: List[str] = []
        self._starting = [threading.Thread(target=self._start, args=(p,),
                                           daemon=True)
                          for p in self._procs]
        for t in self._starting:
            t.start()

    def _start(self, proc) -> None:
        try:
            proc.start()
        except BaseException:  # raised by result()
            self._start_errors.append(traceback.format_exc())

    def result(self, timeout: float = 900.0) -> List[Any]:
        """The ranks' results in rank order; raises if a rank does not
        start, fails or does not finish within ``timeout`` seconds. Every
        rank process has ended when it returns or raises."""
        got = {}
        for t in self._starting:
            t.join()
        errors = [f"a rank's start:\n{e}" for e in self._start_errors]
        try:
            for _ in range(0 if errors else self.world):  # drain, then join
                try:
                    rank, ok, out = self._results.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(f"{self.world} ranks of {self.name} "
                                       f"did not finish in {timeout} s"
                                       ) from None
                if ok:
                    with open(out, "rb") as f:
                        got[rank] = pickle.load(f)
                    os.remove(out)
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in self._procs:
                if p.pid is None:  # never started
                    continue
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
            self._spill.cleanup()
        if errors:
            raise RuntimeError(f"{self.name} failed on " + "\n".join(errors))
        return [got[r] for r in range(self.world)]


def run_ranks(world: int, fn: Callable, *args,
              timeout: float = 900.0) -> List[Any]:
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    process of one ``gloo`` process group (:class:`Ranks`, waited for)."""
    return Ranks(world, fn, *args).result(timeout)
