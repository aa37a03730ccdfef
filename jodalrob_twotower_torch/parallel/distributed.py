"""Multi-process support (port of ``jodalrob_twotower_tpu/parallel/distributed.py``).

The reference runs multi-host with ``jax.distributed``: every host calls
``initialize``, the global mesh spans every host's devices, and each host
feeds its own slice of the data. The port's mesh is a process group with
one process per device (``parallel/mesh.py``), so the same steps hold
within one host as across hosts:

  1. every rank joins the group, through :func:`initialize` (from its
     arguments, or from the environment ``torchrun`` sets) or through
     :func:`launch`, which spawns N ranks on this host;
  2. ``parallel/mesh.make_mesh`` gives each rank its device and collectives;
  3. each rank feeds its own block of every global batch
     (:func:`host_local_batch_to_global` puts it on the rank's device), and
     a streamed pair set splits across the data axis (:func:`host_shard_pairs`,
     the ``host_index``/``host_count`` arguments of ``data/parquet_stream.py``).

A multi-host or multi-card run starts one process per card with
``torchrun``; :func:`launch` is the local launcher the CLIs, the tests and
the chip smoke use. Every rank's process group carries a timeout, and the
launcher a deadline after which it kills its ranks: a collective that hangs
fails, and a rank's exception fails the launch. On one process every helper
here is a no-op.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PG_TIMEOUT_S = 300  # a process group's collective timeout
JOIN_TIMEOUT_S = 1800  # the launcher's deadline for its ranks


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = PG_TIMEOUT_S,
) -> None:
    """Join the process group: ``tcp://<coordinator_address>`` with
    ``num_processes`` ranks, this one ``process_id``; or, with no address,
    from ``torchrun``'s environment (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``). A no-op for one process, with neither given, or when the
    group is up. ``backend`` defaults to NCCL on the card, gloo without one."""
    if dist.is_initialized():
        return
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return  # a single-process run
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, timeout=timeout)  # env://
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)


def process_info() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_shard_pairs(pairs: np.ndarray, mesh=None) -> np.ndarray:
    """Strided split of the pair list across processes (every process ends
    up with the same number of batches; trimmed to the common multiple).
    With a ``mesh`` the split is over its data axis (``mesh.rank`` of
    ``mesh.size``), so the ranks of one data index, which train the same
    block, take the same pairs; without one, over every process.

    Strided (pairs[idx::count]) rather than contiguous blocks: pair lists
    commonly arrive sorted by notice id, and a block split would hand each
    process a distributionally skewed slice."""
    idx, count = (mesh.rank, mesh.size) if mesh is not None else process_info()
    if count == 1:
        return pairs
    per_host = len(pairs) // count
    if per_host == 0:
        raise ValueError(
            f"{len(pairs)} pairs cannot be sharded over {count} hosts - every "
            "host would train on nothing (collectives would hang, not error)"
        )
    return pairs[idx::count][:per_host]


def host_local_batch_to_global(mesh, host_arrays):
    """This process's block of a global batch as the mesh steps take it:
    each leaf of ``host_arrays`` (an array, or a PairBatch, TowerBatch,
    tuple, list or dict of them) as a tensor on the rank's device. The
    reference assembles one global array from every host's rows
    (``make_array_from_process_local_data``); a port rank's rows already
    are its block of the batch, so they are put on its device as they
    are. An absent field (a TowerBatch without text ids) stays None."""
    if host_arrays is None:
        return None
    if isinstance(host_arrays, dict):
        return {k: host_local_batch_to_global(mesh, v) for k, v in host_arrays.items()}
    if isinstance(host_arrays, tuple) and hasattr(host_arrays, "_fields"):  # PairBatch, TowerBatch
        return type(host_arrays)(*(host_local_batch_to_global(mesh, v) for v in host_arrays))
    if isinstance(host_arrays, (tuple, list)):
        return type(host_arrays)(host_local_batch_to_global(mesh, v) for v in host_arrays)
    if not isinstance(host_arrays, torch.Tensor):
        host_arrays = torch.from_numpy(np.ascontiguousarray(host_arrays))
    return host_arrays.to(mesh.device)


def free_port() -> int:
    """A TCP port on localhost that is free now (the group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, timeout_s: float, threads: int | None,
               fn: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, report its
    result or its traceback, leave the group."""
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - reported (before the group closes) to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _failures(results, nprocs: int, failed: dict, grace_s: float = 2.0) -> str:
    """Every rank failure reported within ``grace_s`` of the first: a rank's
    own error and the errors it caused in its peers' collectives (whose
    reports may arrive first) are all named, in rank order."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"launch: rank {r} of {nprocs} failed:\n{failed[r]}" for r in sorted(failed))


def _prebuild(devices: Sequence) -> None:
    """Build every CUDA kernel in this process before ranks start, so that
    no two ranks run nvcc into the build directory at once."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from jodalrob_twotower_torch.ops import _build

        _build.build(_build.kernel_sources())


def launch(
    fn: Callable,
    nprocs: int,
    *,
    args: tuple = (),
    backend: str = "gloo",
    devices: Sequence | None = None,
    timeout_s: float = PG_TIMEOUT_S,
    join_timeout_s: float = JOIN_TIMEOUT_S,
    threads: int | None = None,
) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks of a fresh process group over
    ``backend`` and return each rank's result, in rank order.

    ``nprocs`` > 1 spawns the ranks (``fn`` and ``args`` are pickled: ``fn``
    must be importable by name); one rank runs in this process, in a group
    of its own unless a group is already up. ``devices`` (the ranks' devices)
    lets the kernels be built here before the ranks start. Each group gets
    ``timeout_s``, the launch ``join_timeout_s``: when a rank raises, the
    others are killed and the rank's traceback raised here as RuntimeError;
    past the deadline every rank is killed and TimeoutError raised.
    ``threads`` sets each spawned rank's torch threads."""
    if devices is not None:
        _prebuild(devices)
    if nprocs == 1:
        if dist.is_initialized():
            return [fn(*args)]
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, nprocs, port, backend, timeout_s, threads, fn, args, results),
                         daemon=True) for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + join_timeout_s
    try:
        while len(out) < nprocs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"launch: {nprocs - len(out)} of {nprocs} ranks not done in {join_timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(remaining, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive() and p.exitcode]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0]} died (exit code {procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(_failures(results, nprocs, {rank: value}))
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == nprocs else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(nprocs)]


def script_ranks(n: int, force_cpu: bool) -> tuple[list, str]:
    """The devices and backend of ``n`` ranks: with ``force_cpu`` n gloo
    ranks on the CPU. On the card rank r takes card r % (the visible cards),
    over NCCL when every rank has a card of its own and over gloo when ranks
    share one (NCCL refuses two ranks on one device): so on one card the
    ranks' collectives are gloo's, staged through the host, and their times
    no claim about scaling. The mesh scripts' ``--ranks`` take this as it is,
    to run their checks on one card; :func:`launch_cli` refuses more ranks
    than cards first. Without a card and without ``force_cpu`` it raises."""
    if force_cpu:
        return ["cpu"] * n, "gloo"
    from jodalrob_twotower_torch.device import resolve_device

    resolve_device(None)
    count = torch.cuda.device_count()
    return [f"cuda:{r % count}" for r in range(n)], ("nccl" if n <= count else "gloo")


def launch_script(fn: Callable, n: int, args: tuple, force_cpu: bool, *, join_timeout_s: float = JOIN_TIMEOUT_S):
    """``fn(devices, *args)`` on the ``n`` ranks of :func:`script_ranks`;
    returns (each rank's result in rank order, the backend). The kernels
    are built here first on the card; on the CPU each rank takes its share
    of the threads."""
    devices, backend = script_ranks(n, force_cpu)
    return launch(fn, n, args=(devices, *args), backend=backend, devices=devices, threads=_rank_threads(n, force_cpu),
                  join_timeout_s=join_timeout_s), backend


def launch_cli(fn: Callable, argv: list[str], n: int, force_cpu: bool):
    """A CLI's ``--mesh-devices n``: ``fn(argv, devices)`` on the n ranks of
    :func:`script_ranks`, and rank 0's result. On the card n above the
    visible cards is refused (a silently smaller mesh would run unsharded
    while claiming otherwise), so the ranks take cards 0..n-1 over NCCL;
    with ``force_cpu`` n gloo ranks run on the CPU, as the reference's
    virtual CPU devices do, each on its share of the CPU threads."""
    if not force_cpu and torch.cuda.device_count() < n:
        raise SystemExit(
            f"--mesh-devices {n} but only {torch.cuda.device_count()} device(s) available (cuda) - a silently "
            "smaller mesh would run unsharded while claiming otherwise"
        )
    devices, backend = script_ranks(n, force_cpu)
    return launch(fn, n, args=(argv, devices), backend=backend, devices=devices, threads=_rank_threads(n, force_cpu))[0]


def _rank_threads(n: int, force_cpu: bool) -> int | None:
    """Each spawned CPU rank's share of this process's torch threads."""
    return max(1, torch.get_num_threads() // n) if force_cpu else None


def refuse_unported(args) -> None:
    """``--store-sharding`` without a mesh exits, as the reference's CLIs
    do."""
    if getattr(args, "store_sharding", None) and not args.mesh_devices:
        raise SystemExit("--store-sharding requires --mesh-devices")
