"""Multi-process setup: ``torch.distributed`` and the global ('chains', 'data') mesh.

Counterpart of ``vihmc_tpu/chains/distributed.py`` (:23-141). Every process
runs the same program: :func:`initialize_distributed` joins the process
group over a TCP store at the coordinator's ``host:port`` and picks the
rank's device, :func:`global_chain_mesh` builds the mesh over every rank,
and ``sample_chains(mesh=...)`` splits the chains over the ranks
(:mod:`vihmc_torch.chains.parallel`). Each process loads (or generates) the
same data and keeps its slice (``shard_batch``). The chains' random numbers
are drawn for all chains on every rank from the streams of the run's seed
and sliced, so the assignment of chains to ranks does not change them.

NCCL takes one rank per card: two ranks on one card under ``'nccl'`` raise
here, before the group is made. Ranks that share a card use ``'gloo'``,
asked for by the caller (``backend='gloo'``); nothing switches the backend
or the device silently.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from vihmc_torch.core.device import resolve_device

#: the store and collective timeout when the caller gives none (seconds)
DEFAULT_TIMEOUT_S = 300.0


def slurm_coordinator(env=None) -> str:
    """The coordinator of a SLURM step, worked out as JAX's SLURM cluster
    does: the first host of ``SLURM_STEP_NODELIST`` (``node001``,
    ``node001,host2``, ``node[001-015],host2``, ``node[001,007-015]``) and
    the port ``61440 + SLURM_JOB_ID % 4096``. Raises ``ValueError`` when
    either variable is missing."""
    env = os.environ if env is None else env
    nodes, job = env.get("SLURM_STEP_NODELIST"), env.get("SLURM_JOB_ID")
    if not nodes or not job:
        raise ValueError("a SLURM launch without coordinator_address needs SLURM_STEP_NODELIST "
                         "and SLURM_JOB_ID; pass coordinator_address='host:port'")
    port = int(job) % 2 ** 12 + (65535 - 2 ** 12 + 1)
    cut = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
    host = nodes[:cut]
    if cut < len(nodes) and nodes[cut] == "[":
        rest = nodes[cut + 1:]
        host += rest[:next((i for i, ch in enumerate(rest) if ch in ",-]"), len(rest))]
    return f"{host}:{port}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           initialization_timeout: Optional[float] = None,
                           backend: Optional[str] = None, device="cuda") -> bool:
    """Join ``torch.distributed`` if running multi-process.

    With no arguments, reads the environment: SLURM's ``SLURM_NTASKS`` and
    ``SLURM_PROCID`` (the coordinator from :func:`slurm_coordinator`), or
    torchrun's ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT``
    (where JAX auto-detects a TPU pod). Returns True if distributed mode was
    initialized, False for single-process runs.

    ``initialization_timeout`` (seconds) bounds the coordinator handshake
    and every later collective (the process group's timeout). SCOPE of the
    graceful False-return fallback (as in the JAX package): it covers only
    NON-ZERO ranks whose coordinator TCP port is unreachable (probed with a
    plain connect below); such a rank then runs alone. Process 0 -- and any
    rank whose coordinator is reachable but whose peers never complete the
    handshake -- raises at the deadline, as does a failing
    ``init_process_group`` (JAX's coordination-service client aborts the
    process there). ``coordinator_address`` must be ``host:port`` when the
    timeout fallback is requested (validated below).

    ``backend`` None is ``'nccl'`` when ``device`` is a CUDA device, else
    ``'gloo'``. The rank's device is ``cuda:{local_rank % device_count}``
    (``LOCAL_RANK``, ``SLURM_LOCALID``, else the process id), made current,
    so ``device='cuda'`` names it from then on. Two ranks on one card under
    ``'nccl'`` raise a ``RuntimeError``.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("SLURM_NTASKS", "0")) or None
    if process_id is None and env.get("SLURM_PROCID") is not None:
        process_id = int(env["SLURM_PROCID"])
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        # torchrun's environment stands where JAX auto-detects a TPU pod
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env.get("RANK", "0")) if process_id is None else process_id
    if coordinator_address is None and num_processes and num_processes > 1:
        coordinator_address = slurm_coordinator(env)
    if not coordinator_address:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"a coordinator ({coordinator_address!r}) needs num_processes and "
                         f"process_id (got {num_processes!r}, {process_id!r})")
    if initialization_timeout is not None and process_id != 0:
        # graceful failure mode: an unreachable coordinator is probed with a
        # plain TCP connect first and degrades to a single-process False
        # return
        host, sep, port = coordinator_address.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(
                f"coordinator_address must be 'host:port' when "
                f"initialization_timeout is set (got {coordinator_address!r})")
        deadline = time.time() + initialization_timeout
        reachable = False
        while time.time() < deadline and not reachable:
            try:
                with socket.create_connection((host or "localhost", int(port)),
                                              timeout=1.0):
                    reachable = True
            except OSError:
                time.sleep(0.2)
        if not reachable:
            return False
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=initialization_timeout or DEFAULT_TIMEOUT_S)
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(host or "localhost", int(port), int(num_processes),
                          is_master=process_id == 0, timeout=timeout)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", process_id)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    store.set(f"vihmc_torch/device/{process_id}", f"{socket.gethostname()}/{dev}")
    placed = [store.get(f"vihmc_torch/device/{r}").decode() for r in range(int(num_processes))]
    # the store lives in process 0: it waits until every rank has read
    store.set(f"vihmc_torch/placed/{process_id}", "1")
    if process_id == 0:
        store.wait([f"vihmc_torch/placed/{r}" for r in range(int(num_processes))])
    if backend == "nccl":
        _check_one_rank_per_card(placed)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    return True


def _check_one_rank_per_card(placed):
    """Raise when two ranks would share one card under NCCL."""
    seen = {}
    for rank, where in enumerate(placed):
        if where in seen:
            raise RuntimeError(
                f"NCCL takes one rank per card: ranks {seen[where]} and {rank} are both on "
                f"{where}. Launch one rank per card, or pass backend='gloo' to share a card")
        seen[where] = rank


def global_chain_mesh(n_data_shards: int = 1):
    """('chains','data') mesh over ALL processes' ranks (one rank without a
    process group)."""
    from vihmc_torch.chains.parallel import make_chain_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_chain_mesh(n_chain_shards=world // n_data_shards,
                           n_data_shards=n_data_shards, devices=range(world))


def chains_per_host(total_chains: int) -> int:
    """Even chains-per-process split (errors on remainders, mirroring the
    reference's equal-shard check for split-HMC)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if total_chains % n:
        raise ValueError(f"{total_chains} chains cannot split over {n} hosts")
    return total_chains // n
