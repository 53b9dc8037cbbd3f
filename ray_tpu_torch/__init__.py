"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's model and serving path.

A package of its own beside the JAX package ``ray_tpu``, which stays the
reference: the same parameter layouts, the same public names, the same
outputs on the same inputs and weights. It imports ``torch`` and nothing of
JAX or ``ray_tpu``. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU.

Hand-written CUDA kernels carry the main paths: flash attention (prefill,
``forward``, the ViT, ring attention's hops and, with its backward kernel,
training) and paged attention (decode over the paged pool and over the
dense cache); see ``ray_tpu_torch.kernels``. The training step is
``ray_tpu_torch.parallel.spmd.build_lm_train_step``, on one device or on a
mesh of ranks (``ray_tpu_torch.parallel``: process groups, the mesh,
sharding rules, ring attention, GPipe, expert-parallel MoE). The Train
library, ``ray_tpu_torch.train``, runs such a step on a gang of worker
actors (``DataParallelTrainer``, ``TorchTrainer``: ``train.report``,
checkpoints, restarts; one GPU per worker with ``use_gpu``); pytree
checkpoints are its ``save_pytree`` and ``load_pytree``. The data
library, ``ray_tpu_torch.data``, feeds it (``datasets=``,
``train.get_dataset_shard``): lazy streaming datasets on the runtime's
tasks and actors, whose batches reach the card through pinned memory on
the iterator's own CUDA stream (``iter_torch_batches``).
``ray_tpu_torch.dag.compile_torch_pipeline`` captures a chain of pure
stages as one CUDA graph per input signature. The RL library
(PPO, IMPALA, APPO, DQN, SAC, BC, MARWIL, CQL, multi-agent PPO; no kernel;
learner groups of actors for several learner devices) is
``ray_tpu_torch.rl``.

The package carries its own copy of the core runtime (``ray_tpu_torch.
_private``: tasks, actors, the object store, the KV store and resource
scheduling, with ``num_gpus`` on the ``GPU`` resource) and exports its API
as ``ray_tpu``'s: ``init``, ``remote``, ``get``, ``put``, ``wait``, ``kill``,
``cancel``, ``get_actor``, ... Its worker processes import torch and
nothing of JAX.
"""

from ray_tpu_torch import exceptions
from ray_tpu_torch._api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    init,
    job_scope,
    method,
    nodes,
    profile_dump,
    put,
    recent_traces,
    remote,
    request_profile,
    shutdown,
    timeline,
    trace,
    train_timeline,
    wait,
)
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.worker import (
    ObjectRef,
    ObjectRefGenerator,
    get_runtime,
    is_initialized,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor, kill
from ray_tpu_torch.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_backward,
)
from ray_tpu_torch.kernels.paged_attention import paged_attention
from ray_tpu_torch.models import mnist, moe, vit
from ray_tpu_torch.models.generation import (
    generate,
    init_kv_cache,
    init_paged_pool,
    make_decode_fns,
    make_paged_fns,
    sample_token,
    sequence_key,
)
from ray_tpu_torch.models.transformer import (
    GPTJ_6B,
    LLAMA2_7B,
    TINY,
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    param_logical_axes,
)
from ray_tpu_torch.ops.attention import (
    attention,
    make_context_parallel_attention,
    ring_attention,
)
from ray_tpu_torch.ops.layers import (
    apply_rope,
    gelu,
    layer_norm,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from ray_tpu_torch.serve.exceptions import DeploymentOverloadedError
from ray_tpu_torch.serve.llm import (
    NULL_BLOCK,
    BlockAllocator,
    BlockTable,
    EngineConfig,
    InferenceEngine,
    KVCacheExhausted,
    LLMServer,
    TokenStream,
)
from ray_tpu_torch.train import load_pytree, save_pytree
from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
from ray_tpu_torch.parallel.spmd import build_lm_train_step
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch.weights import params_from_jax

__version__ = "0.1.0"

__all__ = [
    "ActorClass",
    "ActorHandle",
    "BlockAllocator",
    "BlockTable",
    "DeploymentOverloadedError",
    "EngineConfig",
    "FlashAttention",
    "GPTJ_6B",
    "InferenceEngine",
    "KVCacheExhausted",
    "LLAMA2_7B",
    "LLMServer",
    "MeshConfig",
    "NULL_BLOCK",
    "ObjectRef",
    "ObjectRefGenerator",
    "TINY",
    "TokenStream",
    "TransformerConfig",
    "__version__",
    "apply_rope",
    "attention",
    "available_resources",
    "build_lm_train_step",
    "cancel",
    "cluster_resources",
    "create_mesh",
    "exceptions",
    "flash_attention",
    "flash_attention_backward",
    "forward",
    "gelu",
    "generate",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "init_kv_cache",
    "init_paged_pool",
    "init_params",
    "is_initialized",
    "job_scope",
    "kill",
    "layer_norm",
    "load_pytree",
    "loss_fn",
    "make_context_parallel_attention",
    "make_decode_fns",
    "make_paged_fns",
    "method",
    "mnist",
    "moe",
    "nodes",
    "paged_attention",
    "param_logical_axes",
    "params_from_jax",
    "profile_dump",
    "put",
    "recent_traces",
    "remote",
    "request_profile",
    "resolve_device",
    "ring_attention",
    "rms_norm",
    "rope_frequencies",
    "sample_token",
    "save_pytree",
    "sequence_key",
    "shutdown",
    "swiglu",
    "timeline",
    "trace",
    "train_timeline",
    "vit",
    "wait",
]


def __getattr__(name):
    # lazy subpackage access: `import ray_tpu_torch; ray_tpu_torch.data.range(...)`
    # works without eagerly importing the libraries (parity: `ray.data` et al)
    if name in ("data", "train", "serve", "rl", "util"):
        import importlib

        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
