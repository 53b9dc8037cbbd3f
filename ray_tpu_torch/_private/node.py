"""Node: session directories, object store layout, worker process spawning.

Design parity: ``python/ray/_private/node.py:37`` (session dir creation, port
and process management) + the raylet WorkerPool's process-spawning half
(``src/ray/raylet/worker_pool.h:83``). Workers are spawned from a forkserver so
each spawn is a cheap fork of a pre-imported template process (the reference
prestarts idle python workers for the same reason). GPUs are detected here,
without initialising CUDA (``accelerators/nvidia_gpu.py``).
"""

from __future__ import annotations

import atexit
import io
import multiprocessing.context as mp_context
import multiprocessing.forkserver as mp_forkserver
import multiprocessing.popen_forkserver as popen_forkserver
import multiprocessing.spawn as mp_spawn
import multiprocessing.util as mp_util
import os
import pickle
import secrets
import shutil
import time
from typing import Dict, Optional

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.object_store import ObjectStoreClient, destroy_store
from ray_tpu_torch._private.scheduler import NodeState, Scheduler, WorkerState

_mp_ctx = None

# The modules worker_main touches, imported once by the forkserver so a spawn
# is a cheap fork of a template process: the import of
# ray_tpu_torch._private.worker alone drags in node/scheduler (~20ms of child
# CPU per spawn without preload — the fleet-launch ceiling). Importing the
# package imports torch too; neither initialises CUDA.
_PRELOAD = [
    "ray_tpu_torch._private.worker_process",
    "ray_tpu_torch._private.serialization",
    "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.native_store",
    "ray_tpu_torch._private.direct_actor",
    "ray_tpu_torch._private.object_transfer",
    "ray_tpu_torch._private.runtime_env",
]


class _ForkServerPopen(popen_forkserver.Popen):
    """``popen_forkserver.Popen`` launching through the runtime's own fork
    server. The stdlib's is one per process: a process that also runs the
    JAX package's runtime (the parity tests) would fork its workers from a
    template that preloaded ``ray_tpu``, and hand the port's workers that
    package. The child side is unchanged: it runs the stdlib's
    ``forkserver.main``."""

    def _launch(self, process_obj):
        prep_data = mp_spawn.get_preparation_data(process_obj._name)
        buf = io.BytesIO()
        mp_context.set_spawning_popen(self)
        try:
            mp_context.reduction.dump(prep_data, buf)
            mp_context.reduction.dump(process_obj, buf)
        finally:
            mp_context.set_spawning_popen(None)
        self.sentinel, w = _FORK_SERVER.connect_to_new_process(self._fds)
        _parent_w = os.dup(w)
        self.finalizer = mp_util.Finalize(self, mp_util.close_fds, (_parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = mp_forkserver.read_signed(self.sentinel)


class _ForkServerProcess(mp_context.ForkServerProcess):
    @staticmethod
    def _Popen(process_obj):
        return _ForkServerPopen(process_obj)


class _ForkServerContext(mp_context.ForkServerContext):
    Process = _ForkServerProcess


_FORK_SERVER = mp_forkserver.ForkServer()


def _get_ctx():
    """The forkserver context the workers are started from. Its server is a
    fresh interpreter (never a fork of this process, which may have
    initialised CUDA), so every worker starts with CUDA untouched."""
    global _mp_ctx
    if _mp_ctx is None:
        # multiprocessing child prep re-imports the driver's __main__; when the
        # driver is stdin/exec ("<stdin>", "<string>") that import crashes every
        # worker at boot — drop the bogus path so prep skips it
        import sys

        main_mod = sys.modules.get("__main__")
        main_file = getattr(main_mod, "__file__", None)
        if main_file and main_file.startswith("<"):
            try:
                del main_mod.__file__
            except AttributeError:
                pass
        _FORK_SERVER.set_forkserver_preload(list(_PRELOAD))
        _mp_ctx = _ForkServerContext()
    return _mp_ctx


class Node:
    """Head node of a (possibly virtual multi-node) cluster."""

    def __init__(
        self,
        config: Config,
        num_cpus: Optional[int] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.config = config
        ts = time.strftime("%Y%m%d-%H%M%S")
        # the random token keeps two runtimes apart even where clock second
        # and pid agree (pid namespaces, parallel test runs)
        self.session_name = f"session_{ts}_{os.getpid()}_{secrets.token_hex(4)}"
        self.session_dir = os.path.join(config.session_dir_root, self.session_name)
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else self.session_dir
        self.shm_dir = os.path.join(shm_root, "ray_tpu_torch_" + self.session_name)
        # a scheme'd spill target routes eviction through the external
        # storage API; the local fallback dir still backs oversize creates
        from ray_tpu_torch._private import external_storage as _xstorage

        spill_uri = (
            config.spill_directory
            if _xstorage.has_scheme(config.spill_directory)
            else ""
        )
        self.fallback_dir = (
            "" if spill_uri else config.spill_directory
        ) or os.path.join(self.session_dir, "spill")
        config.dump(os.path.join(self.session_dir, "config.json"))

        from ray_tpu_torch._private.native_store import create_store_client

        self.store_client = create_store_client(
            self.shm_dir,
            self.fallback_dir,
            config.object_store_memory,
            spill_uri=spill_uri,
        )

        if num_cpus is None:
            num_cpus = os.cpu_count() or 1
        if num_gpus is None:
            from ray_tpu_torch._private.accelerators import nvidia_gpu

            num_gpus = nvidia_gpu.detect_gpu_count()
        total: Dict[str, float] = {"CPU": float(num_cpus)}
        if num_gpus:
            total["GPU"] = float(num_gpus)
        total["memory"] = float(_detect_memory_bytes())
        total["object_store_memory"] = float(config.object_store_memory)
        if resources:
            total.update({k: float(v) for k, v in resources.items()})
        from ray_tpu_torch._private.object_transfer import machine_id

        self.head_node_id = NodeID.from_random()
        head = NodeState(
            node_id=self.head_node_id,
            total=dict(total),
            available=dict(total),
            labels=dict(labels or {}),
            shm_dir=self.shm_dir,
            host_id=machine_id(),
        )

        self.scheduler = Scheduler(self, config)
        self.scheduler.nodes[self.head_node_id] = head
        self.scheduler.start()

        # the session's socket secret must exist BEFORE the worker config
        # snapshot: workers authenticate direct-call and channel sockets
        if not config.auth_key:
            config.auth_key = secrets.token_hex(16)
        self._config_blob = pickle.dumps(config)
        self._ctx = _get_ctx()
        atexit.register(self._atexit)
        self._closed = False

        if config.prestart_workers:
            for _ in range(min(2, int(num_cpus))):
                self.spawn_worker(self.head_node_id)

    # -- virtual nodes (parity: cluster_utils.Cluster.add_node) -----------

    def add_virtual_node(
        self,
        num_cpus: float = 1.0,
        num_gpus: float = 0.0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> NodeID:
        total: Dict[str, float] = {"CPU": float(num_cpus)}
        if num_gpus:
            total["GPU"] = float(num_gpus)
        if resources:
            total.update({k: float(v) for k, v in resources.items()})
        nid = NodeID.from_random()
        ns = NodeState(node_id=nid, total=dict(total), available=dict(total), labels=dict(labels or {}))
        self.scheduler.post(("add_node", ns))
        return nid

    def remove_virtual_node(self, node_id: NodeID) -> None:
        self.scheduler.post(("remove_node", node_id))

    # -- workers -----------------------------------------------------------

    def spawn_worker(self, node_id: NodeID) -> WorkerID:
        from ray_tpu_torch._private import worker_process

        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        wid = WorkerID.from_random()
        proc = self._ctx.Process(
            target=worker_process.worker_main,
            args=(child_conn, wid.binary(), self.shm_dir, self.fallback_dir, self._config_blob),
            name=f"ray_tpu_torch-worker-{wid.hex()[:8]}",
            daemon=True,
        )
        proc.start()
        child_conn.close()
        ws = WorkerState(worker_id=wid, conn=parent_conn, proc=proc, node_id=node_id)
        self.scheduler.post(("worker_spawned", ws))
        return wid

    # -- shutdown ----------------------------------------------------------

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        self.scheduler.shutdown()
        # the workers are gone: stop the fork server too (the next init
        # starts a fresh one), so a shut-down runtime leaves no process
        _FORK_SERVER._stop()
        self.store_client.close()
        destroy_store(self.shm_dir)
        shutil.rmtree(self.fallback_dir, ignore_errors=True)

    def _atexit(self):
        try:
            self.shutdown()
        except Exception:
            pass


def _detect_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 * 1024**3
