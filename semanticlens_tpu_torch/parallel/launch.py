"""Start ``world_size`` ranks of one function in their own processes and wait for them.

For the CPU tests (gloo ranks on the CPU) and for runs that share one card
between ranks (gloo ranks on ``cuda:0``: NCCL refuses two ranks on one
GPU). Runs over several cards start with ``torchrun`` instead, which sets
the same environment. The ranks meet through a ``FileStore`` in
``workdir``, never a TCP port, so concurrent launches cannot collide.

``fn(rank, world_size, device, *args)`` must be importable by name (a
module-level function): the processes start with ``spawn`` and import it
afresh. A rank that raises writes its traceback to ``workdir`` and
:func:`spawn` raises with it; a rank still running after ``timeout_s`` is
killed and :func:`spawn` raises. A rank killed by a signal prints the
Python stack it died in (``faulthandler``) to its standard error.
"""

from __future__ import annotations

import faulthandler
import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

__all__ = ["spawn"]


def _rank_main(fn, rank: int, world_size: int, backend: str, device: str, workdir: str, timeout_s: float,
               args: tuple):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK="0")
    faulthandler.enable()  # a crash in native code still names the Python frame
    import torch
    import torch.distributed as dist

    from semanticlens_tpu_torch.core.mesh import init_distributed

    torch.set_num_threads(1)  # W ranks share the host's cores
    try:
        dev = init_distributed(backend, store_path=Path(workdir) / "store", device=device, timeout_s=timeout_s)
        fn(rank, world_size, dev, *args)
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, workdir, *, backend: str = "gloo", device: str = "cpu", args: tuple = (),
          timeout_s: float = 120.0) -> float:
    """Run ``fn`` on ``world_size`` ranks; returns the wall seconds from start to the last exit.

    ``device`` is every rank's device (``"cpu"``, or ``"cuda:0"`` for ranks
    sharing one card); each rank runs one torch thread. The process
    group's collectives time out after ``timeout_s`` too.
    """
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "store").unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, device, str(workdir), timeout_s,
                                                  tuple(args)), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = t0 + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    wall = time.perf_counter() - t0
    errors = [(workdir / f"rank{r}.err").read_text() for r in range(world_size) if (workdir / f"rank{r}.err").exists()]
    if errors:
        raise RuntimeError(f"{len(errors)} of {world_size} ranks failed; first traceback:\n{errors[0]}")
    if late:
        raise RuntimeError(f"ranks {late} of {world_size} still ran after {timeout_s:.0f} s and were killed")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return wall
