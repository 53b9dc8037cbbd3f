"""@remote functions.

Design parity: ``python/ray/remote_function.py:266`` (``RemoteFunction._remote``)
and option handling (``python/ray/_private/ray_option_utils.py``). The function
is cloudpickled once and cached (the reference exports once to the GCS function
table via ``_private/function_manager.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.runtime_env import upload_runtime_env as _upload_runtime_env
from ray_tpu_torch.util.tracing import for_submission as _trace_for_submission
from ray_tpu_torch._private.task_spec import Arg, SchedulingStrategy, TaskSpec, TaskType
from ray_tpu_torch._private.worker import ObjectRef, ObjectRefGenerator, get_runtime, pack_args

_DEFAULT_TASK_OPTIONS = dict(
    num_cpus=1.0,
    num_gpus=0.0,
    resources=None,
    num_returns=1,
    max_retries=3,
    retry_exceptions=False,
    scheduling_strategy=None,
    runtime_env=None,
    name=None,
    memory=None,
)


def resolve_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    res = {k: float(v) for k, v in (opts.get("resources") or {}).items()}
    if opts.get("num_cpus"):
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    return res


def _normalize_retry_exceptions(value):
    """False | True | exception class | list of classes -> False|True|names.

    Classes are stored as qualified-name strings: TaskSpec travels to workers
    over plain pickle (user classes may not import there), and pickling
    ``__main__`` classes by value breaks ``isinstance`` identity. The
    scheduler matches names against the raised cause's MRO.
    """
    if not value:
        return False
    if value is True:
        return True
    if isinstance(value, type) and issubclass(value, BaseException):
        value = [value]
    names = []
    for v in value:
        if not (isinstance(v, type) and issubclass(v, BaseException)):
            raise TypeError(
                f"retry_exceptions entries must be exception types, got {v!r}"
            )
        names.append(f"{v.__module__}.{v.__qualname__}")
    return names


def resolve_strategy(opts) -> SchedulingStrategy:
    strat = opts.get("scheduling_strategy")
    if strat is None:
        return SchedulingStrategy()
    if isinstance(strat, str):
        return SchedulingStrategy(kind=strat)
    return strat.to_internal()


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._name = getattr(fn, "__name__", "fn")
        self._options = dict(_DEFAULT_TASK_OPTIONS)
        self._options.update(options or {})
        self._pickled: Optional[bytes] = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly; use "
            f"'{self._name}.remote()' or '.bind()' in a DAG."
        )

    def options(self, **updates) -> "RemoteFunction":
        new = RemoteFunction(self._function, {**self._options, **updates})
        new._pickled = self._pickled
        return new

    def _get_pickled(self) -> bytes:
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._function)
        return self._pickled

    def remote(self, *args, **kwargs):
        rt = get_runtime()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        packed_args, packed_kwargs = pack_args(rt, args, kwargs)
        task_id = rt.new_task_id()
        spec = TaskSpec(
            task_id=task_id,
            task_type=TaskType.NORMAL_TASK,
            function=self._get_pickled(),
            args=packed_args,
            kwargs=packed_kwargs,
            num_returns=1 if streaming else int(num_returns),
            resources=resolve_resources(opts),
            name=opts.get("name") or self._name,
            max_retries=int(opts.get("max_retries") or 0),
            retry_exceptions=_normalize_retry_exceptions(
                opts.get("retry_exceptions")
            ),
            scheduling_strategy=resolve_strategy(opts),
            runtime_env=_upload_runtime_env(rt, opts.get("runtime_env")),
            is_streaming=streaming,
            trace_ctx=_trace_for_submission(),
        )
        rt.submit(spec)
        if streaming:
            return ObjectRefGenerator(spec.task_id, ObjectRef(ObjectID.for_return(spec.task_id, 0), _owned=True))
        refs = [ObjectRef(oid, _owned=True) for oid in spec.return_ids()]
        if spec.num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)
