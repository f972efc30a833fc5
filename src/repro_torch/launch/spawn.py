"""Start the ranks of a process-group run (the port's counterpart of the
reference's `tests/conftest.py::run_dist`, which starts a subprocess with N
fake devices).

`spawn(fn, world, ...)` starts ``world`` processes with the ``spawn`` start
method, joins them into one default process group through a file store in
a fresh temporary directory (no fixed ``MASTER_PORT``, so concurrent runs
never collide), runs ``fn(*args)`` in each and returns the ranks' results
in rank order. A rank that raises sends its traceback to the parent, which
kills every other rank (so none waits forever in a collective the failed
rank will never join) and raises `RankError` with the traceback and the
exit code; a rank that dies without a word (a signal) is reported by its
exit code. At ``deadline_s`` the parent kills every rank and raises
`TimeoutError`. On Linux a rank is killed when the parent dies (even by
SIGKILL), so a parent stopped from outside leaves no rank running; call
`spawn` from the thread that outlives the ranks (the main thread).

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) the
same call joins the job from the environment and runs ``fn`` in this
process: the result list then holds this rank's result only.
"""
from __future__ import annotations

import ctypes
import os
import pickle
import queue
import signal
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import check_backend


class RankError(RuntimeError):
    """A rank of a spawned run raised or died."""

    def __init__(self, rank: int, exitcode, detail: str):
        super().__init__(f"rank {rank} failed (exit code {exitcode}):\n"
                         f"{detail}")
        self.rank, self.exitcode, self.detail = rank, exitcode, detail


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _init(backend: str, device: str, rank: int, world: int, init: str,
          deadline_s: float, local_rank: int) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count()
                              if backend == "nccl" else dev.index or 0)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=deadline_s))


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent dies (Linux
    ``PR_SET_PDEATHSIG``); exit now if ``parent`` is gone already."""
    if sys.platform != "linux":
        return
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # 1: PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def _child(parent, call, rank, world, backend, device, init, deadline_s,
           out):
    _die_with(parent)
    # the ranks share the host's cores: each takes its share of the threads
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        _init(backend, device, rank, world, init, deadline_s, rank)
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str, device, deadline_s:
          float, args: Sequence = ()) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks of one ``backend`` process
    group on ``device`` and return their results in rank order (picklable
    values; ``fn`` must be importable by name). Raises `RankError` when a
    rank raises or dies, `TimeoutError` after ``deadline_s`` seconds."""
    check_backend(backend, world, device)
    if _under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"processes, the run needs {world}")
        if not dist.is_initialized():
            _init(backend, str(device), int(os.environ["RANK"]), world,
                  "env://", deadline_s,
                  int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        return [fn(*args)]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        # the call goes by file: a start's pickle larger than a pipe would
        # hold the parent until that child has imported it, one at a time
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_child, args=(
            os.getpid(), call, r, world, backend, str(device), init,
            deadline_s, out))
            for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, out, time.monotonic() + deadline_s,
                            deadline_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _collect(procs, out, deadline: float, deadline_s: float) -> List[Any]:
    """The ranks' results, read from ``out`` as they come (a queue is
    drained before its writers are joined); raises on the first failure."""
    results = {}
    while len(results) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"spawned run passed its deadline of {deadline_s} s; ranks "
                f"without a result: "
                f"{sorted(set(range(len(procs))) - set(results))}")
        try:
            rank, ok, value = out.get(timeout=min(left, 0.5))
        except queue.Empty:
            for r, p in enumerate(procs):
                if r not in results and p.exitcode not in (None, 0):
                    raise RankError(r, p.exitcode, "died without a result")
            continue
        if not ok:
            procs[rank].join(timeout=10)
            raise RankError(rank, procs[rank].exitcode, value)
        results[rank] = value
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1.0))
    return [results[r] for r in range(len(procs))]
