"""Start data-parallel ranks as processes on one machine.

``torchrun`` starts one process per rank from the shell; :func:`spawn`
does the same from Python: ``world`` processes from the ``spawn`` start
method (never ``fork``: the parent may hold CUDA or threads), each joining
a process group on ``127.0.0.1`` through
:func:`parallel.mesh.initialize_distributed` and calling
``fn(rank, world, *args)``. Every rank's return value comes back to the
caller in rank order. A rank that raises, dies or outlives ``timeout``
seconds fails the whole call: the other ranks are terminated and
:class:`RankFailure` carries each rank's traceback or exit code, so a
hang never outlives the call.

Build the kernels in the parent before spawning (``kernels.build``'s
cache): two ranks then never race one ``nvcc`` build.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback


class RankFailure(RuntimeError):
    """A rank raised, died or timed out; ``failures``: {rank: what}."""

    def __init__(self, failures: dict):
        self.failures = dict(failures)
        lines = [f"rank {r}: {what}" for r, what in sorted(failures.items())]
        super().__init__("data-parallel ranks failed:\n" + "\n".join(lines))


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, timeout, fn, args, out):
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh

    try:
        mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    backend=backend, device=device,
                                    timeout=timeout)
        result = fn(rank, world, *args)
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which fails the call
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, args=(), backend=None, device="cuda",
          timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined by
    a ``backend`` process group (collectives time out after ``timeout``
    seconds too); returns the results in rank order. As in
    :func:`parallel.mesh.initialize_distributed`, the ranks run on the
    card over NCCL unless the caller names ``device="cpu"`` (gloo) or
    ``backend``. ``fn`` and its arguments are pickled: ``fn`` must be
    importable by name."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, device, timeout,
                               fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failures = {}, {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining: a rank blocks until its result
        # is read
        while len(results) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                for r in range(world):
                    if r not in results and r not in failures:
                        failures[r] = f"no result after {timeout:.0f} s"
                break
            try:
                r, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank that exits cleanly has flushed its result; one
                # that died before putting anything fails the call
                for r, p in enumerate(procs):
                    if (p.exitcode not in (None, 0) and r not in results
                            and r not in failures):
                        failures[r] = f"exited with code {p.exitcode}"
                continue
            (results if ok else failures)[r] = value
            if failures:
                break
    finally:
        for p in procs:
            if failures:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
    if failures:
        raise RankFailure(failures)
    return [results[r] for r in range(world)]
