"""Start a function on ``world_size`` ranks, one spawned process each, and
collect what each returns, under a deadline (the tests and ``chip_smoke.py``
run the sharded paths this way; any launcher that starts one process per rank
and calls :func:`~rgp_tpu_torch.parallel.mesh.init_distributed` in each does
the same).

``fn(rank, *args)`` runs after the rank has joined the group; it must be a
module-level function (a spawned process imports it by name) and return
something picklable. A rank that raises sends its traceback and exits
non-zero; a rank that dies, or a deadline that passes, ends every rank and
raises here.
"""

from __future__ import annotations

import queue
import time
import traceback

import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_distributed

__all__ = ["spawn_ranks"]


def _rank_main(fn, rank, world_size, backend, init_method, pg_timeout, args, out):
    init_distributed(backend, init_method=init_method, rank=rank, world_size=world_size, timeout=pg_timeout)
    try:
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *, backend: str, init_method: str, args=(), timeout: float = 300.0,
                pg_timeout: float = 120.0):
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each run in its
    own spawned process joined to a ``backend`` group through
    ``init_method`` (e.g. ``file://`` of a path that does not exist yet).
    ``timeout`` (seconds) bounds the whole run, ``pg_timeout`` each
    collective."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, init_method, pg_timeout, args, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = {}
    try:
        while len(results) < world_size:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} before returning") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(results))} did not return "
                                       f"within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"a rank did not exit within {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        out.close()
    return [results[r] for r in range(world_size)]
