"""Process-group start-up, a local multi-rank launcher, and the scaling
measurement.

Counterpart of the JAX package's ``parallel/multihost.py``. The port is one
process per device: :func:`initialize` joins the process group that
``torchrun`` (or any launcher setting ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``) describes, NCCL when
CUDA is present, else gloo. :func:`spawn` starts ``world`` local ranks of
one function for tests and tools, rendezvousing through a file in a
temporary directory, never a fixed port.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def initialize(backend: str = "") -> None:
    """Join the process group the environment describes: a no-op when
    ``WORLD_SIZE`` is unset or 1, or when a group already exists. Sets
    this process's device to ``cuda:LOCAL_RANK`` under NCCL."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend)


def device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when CUDA is present."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


def _rank_main(fn, r: int, world: int, init_method: str, backend: str,
               queue, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=r,
                                world_size=world)
        try:
            queue.put((r, fn(r, world, *args), None))
        finally:
            dist.destroy_process_group()
    except Exception:                         # noqa: BLE001 — reported
        queue.put((r, None, traceback.format_exc()))


def spawn(fn, world: int, *args, backend: str = "gloo",
          timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    in one process group; return the ranks' results in rank order (each
    must pickle). ``fn`` must live in a module the children can import (the
    ``spawn`` start method re-imports it). Raises with the first failing
    rank's traceback."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gs_rdv_")
    queue = ctx.SimpleQueue()
    init = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, backend, queue, args),
                         daemon=True)
             for r in range(world)]
    try:
        return collect(procs, queue, timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def collect(procs, queue, timeout: float):
    """Start ``procs``, each of which puts one (rank, result, traceback or
    None) on ``queue``; drain the queue, then join them. Returns the
    results in rank order; raises with every failing rank's traceback, or
    when a rank exits without a result or ``timeout`` seconds pass."""
    for p in procs:
        p.start()
    results, errors = [None] * len(procs), []
    try:
        deadline = time.monotonic() + timeout
        for _ in procs:
            while queue.empty():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawned ranks took over {timeout} s")
                if not any(p.is_alive() for p in procs) and queue.empty():
                    raise RuntimeError("spawned ranks exited without a result")
                time.sleep(0.01)
            r, res, err = queue.get()
            results[r] = res
            if err:
                errors.append(f"rank {r}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def measure_scaling(step_fn_factory, device_counts=None, iters: int = 10):
    """Step time against device count for a camera-batched step.

    ``step_fn_factory(n)`` returns a zero-argument callable that runs one
    step with a batch of ``n`` cameras over ``n`` ranks. Returns
    ``{n: {"ms", "cams_per_ms", "efficiency"}}``, the efficiency relative
    to perfect weak scaling from the smallest count."""
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32)
                         if c <= world_size()]
    results, base = {}, None
    for n in device_counts:
        fn = step_fn_factory(n)
        fn()                                   # warm-up
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1000
        throughput = n / ms
        if base is None:
            base = throughput
        results[n] = {"ms": round(ms, 2),
                      "cams_per_ms": round(throughput, 4),
                      "efficiency": round(throughput / (
                          base * n / device_counts[0]), 4)}
    return results
