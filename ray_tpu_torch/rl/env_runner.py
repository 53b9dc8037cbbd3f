"""EnvRunner: samples rollouts with the current policy (port of
``ray_tpu/rl/env_runner.py``, local runner only).

Parity: ``SingleAgentEnvRunner.sample`` (``rllib/env/single_agent_env_runner.py:131``)
— a driver-local runner (``num_env_runners=0``) stepping vectorized numpy
envs with the policy on the algorithm's device. Each env step moves the
observations to the device and the actions, log-probabilities and values
back, as the reference's ``np.asarray`` calls do. Remote runners, and the
elastic group that replaces them, need the actor runtime: the port has
none, and ``EnvRunnerGroup`` raises for ``num_env_runners > 0``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


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


class EnvRunnerGroup:
    """One local (in-driver) runner. ``num_env_runners > 0`` asks for
    remote runner actors, which the port does not have: it raises."""

    def __init__(self, env_creator, num_env_runners: int, num_envs_per_runner: int,
                 rollout_len: int, seed: int = 0, connectors=None, *, device="cuda"):
        if num_env_runners:
            raise NotImplementedError(
                "remote env runners need the actor runtime, which the port does not have; "
                "use num_env_runners=0")
        self.local = EnvRunner(
            env_creator, num_envs_per_runner, rollout_len, seed,
            connectors=connectors, device=device,
        )

    def num_healthy(self) -> int:
        return 1

    def connector_state(self):
        """The local runner's trained env-to-module connector state."""
        return self.local.get_connector_state()

    def sample(self, params) -> List[Dict[str, np.ndarray]]:
        return [self.local.sample(params)]

    def stop(self):
        pass
