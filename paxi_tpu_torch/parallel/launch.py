"""Run one function on ``world`` local ranks, one process each.

    results = spawn(4, fn, *args, device="cpu")    # fn(mesh, *args)

Every rank joins one ``torch.distributed`` process group, builds its
``Mesh`` and calls ``fn(mesh, *args)``; ``spawn`` returns the ranks'
results in rank order.  The rendezvous is a ``FileStore`` under
``build/rendezvous/`` in the checkout (nothing outside it, no port).  The
backend is gloo on the CPU and where several ranks share one card (NCCL
refuses two ranks on one device), NCCL where each rank has a card of its
own.  A rank that fails makes ``spawn`` raise with that rank's traceback
and stop the others; it never returns partial results.  ``fn`` must be
importable by name (a module-level function) and should return CPU
values.

On a machine with several cards, ``torchrun`` drives the same ``fn``: it
starts the ranks and sets their environment, and each rank calls
``fn(init_from_env(), *args)``.  Both ways pick a rank's device by
``mesh.rank_device``.
"""

from __future__ import annotations

import os
import pickle
import queue
import time
import traceback
import uuid
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paxi_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_device

RENDEZVOUS_DIR = Path(__file__).resolve().parents[2] / "build" / "rendezvous"


def default_backend(world: int, device) -> str:
    """gloo on the CPU and when ranks outnumber the cards, else NCCL."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the ranks on the CPU")
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _on_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def _set_rank_device(local_rank: int, device) -> torch.device:
    """The rank's device (the CPU if asked for, else its card, as
    ``make_mesh`` picks it), made current before the process group."""
    dev = rank_device(local_rank, "cpu" if _on_cpu(device) else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_from_env(device=None) -> Mesh:
    """Join the process group that ``torchrun``'s environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``_PORT``)
    and return this rank's mesh."""
    dev = _set_rank_device(int(os.environ.get("LOCAL_RANK", 0)), device)
    dist.init_process_group(default_backend(int(os.environ["WORLD_SIZE"]),
                                            device))
    return make_mesh(device=dev)


def _worker(rank: int, world: int, store: str, backend: str, device,
            threads: int, results, fn, args) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _set_rank_device(rank, device)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                               # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(world: int, fn, *args, backend=None, device=None,
          timeout: float = 1800.0):
    """``[fn(mesh_r, *args) for r in range(world)]``, each rank in its own
    process; see the module docstring."""
    backend = backend or default_backend(world, device)
    RENDEZVOUS_DIR.mkdir(parents=True, exist_ok=True)
    store = RENDEZVOUS_DIR / f"{os.getpid()}-{uuid.uuid4().hex}"
    threads = max(1, (os.cpu_count() or 1) // world) \
        if _on_cpu(device) else 0
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(store), backend, device,
                               threads, results, fn, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    # give a dying rank a moment to report its traceback
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                        continue
                elif time.monotonic() > deadline:
                    failure = f"ranks did not finish within {timeout} s"
                    continue
                else:
                    continue
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                failure = f"rank {rank} failed:\n{payload}"
        if failure is None:
            for p in procs:
                p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        store.unlink(missing_ok=True)
    if failure is not None:
        raise RuntimeError(f"spawn({world}): {failure}")
    return [out[r] for r in range(world)]
