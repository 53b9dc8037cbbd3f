"""EnvRunner: samples rollouts with the current policy (port of
``ray_tpu/rl/env_runner.py``).

Parity: ``SingleAgentEnvRunner.sample`` (``rllib/env/single_agent_env_runner.py:131``)
— remote runner actors on the port's runtime, or a driver-local runner
(``num_env_runners=0``), stepping vectorized numpy envs. The local runner
acts on the algorithm's device: each env step moves the observations there
and the actions, log-probabilities and values back, as the reference's
``np.asarray`` calls do. Remote runners ask for no accelerator, as the
reference's runner actors do, and act on the CPU; the group sends them the
parameters as numpy and tolerates their loss (``rllib/utils/actor_manager.py``
role).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.optim import to_numpy
from ray_tpu_torch.weights import params_from_jax


def resolve_obs_dim(config, spec) -> int:
    """Module input width after the env-to-module pipeline (FrameStack etc.
    widen observations; the policy net must be built for the OUTPUT)."""
    factory = getattr(config, "env_to_module_connector", None)
    if factory is None:
        return spec.obs_dim
    return _build_pipeline(factory).out_dim(spec.obs_dim)


def _build_pipeline(connectors):
    if connectors is None:
        return None
    from ray_tpu_torch.rl.connectors import Connector, ConnectorPipeline

    if callable(connectors) and not isinstance(connectors, Connector):
        connectors = connectors()  # per-runner factory
    if isinstance(connectors, ConnectorPipeline):
        return connectors
    if isinstance(connectors, Connector):
        return ConnectorPipeline([connectors])
    return ConnectorPipeline(list(connectors))


class EnvRunner:
    """Steps ``num_envs`` env copies; acts on ``device`` with actions drawn
    from a ``torch.Generator`` there, seeded by ``seed``."""

    def __init__(self, env_creator, num_envs: int, rollout_len: int, seed: int,
                 connectors=None, *, device="cuda"):
        from ray_tpu_torch.rl.env import VectorEnv

        self.device = resolve_device(device)
        self.vec = VectorEnv(env_creator, num_envs, seed=seed)
        self.rollout_len = rollout_len
        # observations are transformed before the policy sees them AND
        # before they land in the rollout, so learning matches acting
        self.connectors = _build_pipeline(connectors)
        raw = self.vec.reset()
        self.obs = self.connectors(raw) if self.connectors else raw
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        # per-env episode bookkeeping for return metrics
        self._ep_return = np.zeros(num_envs)
        self._completed: List[float] = []

    def get_connector_state(self):
        """Trained connector-pipeline state (normalize stats etc.) for
        evaluation-time reuse; None when no pipeline is configured."""
        return self.connectors.get_state() if self.connectors else None

    def _act(self, params):
        from ray_tpu_torch.rl.models import sample_actions

        obs = torch.from_numpy(np.asarray(self.obs, np.float32)).to(self.device)
        return sample_actions(params, obs, self.generator)

    @torch.no_grad()
    def sample(self, params) -> Dict[str, np.ndarray]:
        """One rollout of ``rollout_len`` steps. ``params`` is a tree of
        tensors, or of numpy arrays (what the group sends a remote runner),
        which are carried to ``device`` first."""
        from ray_tpu_torch.rl.models import tree_leaves

        if not isinstance(tree_leaves(params)[0], torch.Tensor):
            params = params_from_jax(params, device=self.device)
        T, N = self.rollout_len, self.vec.n
        obs_buf = np.empty((T, N, self.obs.shape[-1]), np.float32)
        act_buf = np.empty((T, N), np.int32)
        logp_buf = np.empty((T, N), np.float32)
        val_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), bool)
        for t in range(T):
            actions, logp, value = self._act(params)
            actions = actions.cpu().numpy().astype(np.int32)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logp.cpu().numpy()
            val_buf[t] = value.cpu().numpy()
            env_actions = (
                self.connectors.transform_action(actions)
                if self.connectors
                else actions
            )
            raw, rew, done = self.vec.step(env_actions)
            self.obs = self.connectors(raw, dones=done) if self.connectors else raw
            rew_buf[t] = rew
            done_buf[t] = done
            self._ep_return += rew
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
        # bootstrap value for the final observation
        _, _, last_val = self._act(params)
        episode_returns, self._completed = self._completed, []
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "last_values": last_val.cpu().numpy(),
            "episode_returns": np.array(episode_returns, np.float32),
        }


RemoteEnvRunner = ray_tpu_torch.remote(EnvRunner)


class EnvRunnerGroup:
    """num_env_runners remote runners, or one local (in-driver) runner.

    Elastic fault tolerance (parity: ``FaultTolerantActorManager``,
    ``rllib/utils/actor_manager.py:1``): dead runners are dropped on sample
    and ``restore()`` replaces them up to the configured count, so sampling
    survives runner loss and heals. Remote runner k (from 1) is seeded
    ``seed + 1000 * k`` and acts on the CPU; ``device`` is the local
    runner's."""

    def __init__(self, env_creator, num_env_runners: int, num_envs_per_runner: int,
                 rollout_len: int, seed: int = 0, connectors=None, *, device="cuda"):
        self.local: Optional[EnvRunner] = None
        self.remote: List = []
        self._env_creator = env_creator
        self._num_envs = num_envs_per_runner
        self._rollout_len = rollout_len
        self._seed = seed
        self._connectors = connectors  # factory: fresh pipeline per runner
        self._target = num_env_runners
        self._spawned = 0
        if num_env_runners == 0:
            self.local = EnvRunner(
                env_creator, num_envs_per_runner, rollout_len, seed,
                connectors=connectors, device=device,
            )
        else:
            for _ in range(num_env_runners):
                self._spawn()

    def _spawn(self):
        self._spawned += 1
        self.remote.append(
            RemoteEnvRunner.remote(
                self._env_creator,
                self._num_envs,
                self._rollout_len,
                self._seed + 1000 * self._spawned,
                connectors=self._connectors,
                device="cpu",
            )
        )

    def num_healthy(self) -> int:
        return 1 if self.local is not None else len(self.remote)

    def connector_state(self):
        """The trained env-to-module connector state, wherever the runners
        live: the local runner's pipeline state, or the first healthy
        remote runner's (remote runners see the same stream statistics)."""
        if self.local is not None:
            return self.local.get_connector_state()
        for r in list(self.remote):
            try:
                return ray_tpu_torch.get(r.get_connector_state.remote(), timeout=60)
            except Exception:
                continue
        return None

    def restore(self, min_runners: Optional[int] = None) -> int:
        """Replace dead runners up to the original target; returns how many
        fresh runners were started."""
        if self.local is not None:
            return 0
        want = self._target if min_runners is None else min_runners
        started = 0
        while len(self.remote) < want:
            self._spawn()
            started += 1
        return started

    def sample(self, params) -> List[Dict[str, np.ndarray]]:
        if self.local is not None:
            return [self.local.sample(params)]
        host_params = to_numpy(params)
        refs = [r.sample.remote(host_params) for r in self.remote]
        out = []
        for r, ref in zip(list(self.remote), refs):
            try:
                out.append(ray_tpu_torch.get(ref, timeout=300))
            except Exception:
                # elastic sampling: drop the dead runner, keep the rest
                self.remote.remove(r)
        if not out:
            raise RuntimeError("all env runners failed")
        return out

    def stop(self):
        for r in self.remote:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
