"""Process-group bootstrap: one process per rank, one device per process.

Port of ``ray_tpu/parallel/distributed.py``. The reference joins each slice
host's JAX process to a coordination service, after which one jitted
program spans every host's devices. Here each rank joins a
``torch.distributed`` process group: NCCL over ``cuda:{local_rank}``, or
gloo on the CPU where the caller asks for it (the tests). The address is
given explicitly, as ``jax.distributed.initialize`` takes it: nothing on a
machine tells a rank of its cluster.

Ranks that run as actors or tasks of the port's runtime can agree on the
address through its KV store instead: ``rendezvous_via_kv``, then
``release_rendezvous`` once the group is up.
"""

from __future__ import annotations

import datetime
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch._device import DeviceLike, resolve_device

_NAMESPACE = "torch_rendezvous"
_device: Optional[torch.device] = None


def is_initialized() -> bool:
    return dist.is_initialized()


def free_port() -> int:
    """Reserve an ephemeral port (closed before use; the reference's
    accepted race)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    device: DeviceLike = "cuda",
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` and return this rank's device.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there), or an
    init URL (``tcp://...``, ``file://...``). ``device="cuda"`` (the
    default) takes ``cuda:{local_rank}`` (``local_rank`` defaults to
    ``process_id``) and NCCL, and raises without a card; ``"cpu"`` takes
    gloo. ``backend="gloo"`` on CUDA lets ranks share one card (NCCL
    refuses two ranks on one device; gloo stages CUDA tensors through the
    host for its collectives, but not for send and receive). Collectives
    that wait longer than ``timeout_s`` fail."""
    global _device
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = process_id if local_rank is None else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {process_id} wants cuda:{index} but {torch.cuda.device_count()} "
                "devices are visible"
            )
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend,
        init_method=url,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs,
    )
    _device = dev
    return dev


def device() -> torch.device:
    """This rank's device (``initialize``'s)."""
    if _device is None:
        raise RuntimeError("call ray_tpu_torch.parallel.distributed.initialize(...) first")
    return _device


def shutdown() -> None:
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def rendezvous_via_kv(
    rt,
    key: str,
    rank: int,
    world: int,
    *,
    node_ip: str = "127.0.0.1",
    timeout_s: float = 120.0,
) -> str:
    """Agree on a coordinator address through the cluster KV.

    Rank 0 reserves a port and publishes ``ip:port`` under ``key``; everyone
    polls until it appears. Returns the coordinator address, which
    ``initialize`` takes. ``rt`` is the runtime
    (``ray_tpu_torch._private.worker.get_runtime()``), in a worker or the
    driver.
    """
    if rank == 0:
        addr = f"{node_ip}:{free_port()}"
        rt.rpc("kv_put", _NAMESPACE, key.encode(), addr.encode(), True)
        return addr
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        raw = rt.rpc("kv_get", _NAMESPACE, key.encode())
        if raw:
            return raw.decode()
        time.sleep(0.05)
    raise RuntimeError(f"process-group rendezvous timed out on key {key!r}")


def release_rendezvous(rt, key: str) -> None:
    """Drop the published coordinator address (rank 0, once the group is up)."""
    try:
        rt.rpc("kv_del", _NAMESPACE, key.encode())
    except Exception:
        pass
