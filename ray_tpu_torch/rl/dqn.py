"""DQN: off-policy Q-learning with replay and a target network (port of
``ray_tpu/rl/dqn.py``).

Parity: ``rllib/algorithms/dqn/`` — epsilon-greedy exploration, uniform
replay buffer, Huber TD loss against a periodically synced target network,
double-Q or max targets. Exploration and replay sampling draw from the same
numpy generator, in the same order, as the reference. The target network
is a snapshot taken at every sync: the online parameters are updated in
place, so an alias would track them.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import VectorEnv, make_env
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, load_params
from ray_tpu_torch.rl.optim import Adam, clone, state_numpy, to_numpy, value_and_grad
from ray_tpu_torch.weights import params_from_jax


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size = 50_000
        self.learning_starts = 1_000
        self.train_batch_size = 64
        self.target_update_freq = 500  # env steps between target syncs
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 5_000
        self.double_q = True
        self.updates_per_iter = 64
        self.steps_per_iter = 512

    def build(self, device="cuda") -> "DQN":
        return DQN(self, device=device)


class _ReplayBuffer:
    """Uniform ring buffer over flat numpy arrays (the reference's
    ``ReplayBuffer`` role, ``rllib/utils/replay_buffers/``)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.pos = 0
        self.size = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        for i in range(len(obs)):
            p = self.pos
            self.obs[p] = obs[i]
            self.next_obs[p] = next_obs[i]
            self.actions[p] = actions[i]
            self.rewards[p] = rewards[i]
            self.dones[p] = dones[i]
            self.pos = (p + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, rng, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }


def dqn_loss(params, target_params, batch, gamma: float, double_q: bool):
    """Mean Huber (delta 1) TD loss -> (loss, mean |td|)."""
    q = apply_mlp_policy(params, batch["obs"])[0]
    q_taken = q.gather(1, batch["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_target = apply_mlp_policy(target_params, batch["next_obs"])[0]
        if double_q:
            best = apply_mlp_policy(params, batch["next_obs"])[0].argmax(dim=1)
            q_next = q_next_target.gather(1, best[:, None])[:, 0]
        else:
            q_next = q_next_target.max(dim=1).values
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = q_taken - target
    loss = F.huber_loss(td, torch.zeros_like(td), reduction="none", delta=1.0).mean()
    return loss, td.detach().abs().mean()


class DQN(Algorithm):
    def __init__(self, config: DQNConfig, device="cuda"):
        super().__init__(config, device)
        spec = make_env(config.env).spec
        # the MLP policy's pi head doubles as the Q head (logits == Q-values)
        self.params = init_mlp_policy(self._generator(config.seed), spec.obs_dim,
                                      spec.num_actions, config.hidden, device=self.device)
        self.target_params = clone(self.params)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.envs = VectorEnv(config.env, config.num_envs_per_runner, seed=config.seed)
        self._obs = self.envs.reset()
        self.buffer = _ReplayBuffer(config.buffer_size, spec.obs_dim)
        self._update = self._make_update()
        self._q_values = self._make_q_values()
        self._rng = np.random.default_rng(config.seed)
        self._timesteps = 0
        self._since_target_sync = 0
        self._episode_returns: List[float] = []
        self._running_returns = np.zeros(config.num_envs_per_runner, np.float32)

    def _make_q_values(self):
        dev = self.device

        @torch.no_grad()
        def q_values(params, obs):
            x = torch.from_numpy(np.asarray(obs, np.float32)).to(dev)
            return apply_mlp_policy(params, x)[0].cpu().numpy()

        return q_values

    def _make_update(self):
        cfg = self.config
        optimizer = self.optimizer

        def update(params, target_params, opt_state, batch):
            loss, td_abs, grads = value_and_grad(dqn_loss, params, target_params, batch,
                                                 cfg.gamma, cfg.double_q)
            optimizer.step(params, grads, opt_state)
            return params, opt_state, {"td_loss": loss, "td_abs": td_abs}

        return update

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_envs = cfg.num_envs_per_runner
        metrics: Dict[str, Any] = {}
        for _ in range(max(1, cfg.steps_per_iter // n_envs)):
            eps = self._epsilon()
            q = self._q_values(self.params, self._obs)
            actions = q.argmax(axis=1)
            explore = self._rng.random(n_envs) < eps
            actions = np.where(
                explore, self._rng.integers(0, q.shape[1], n_envs), actions
            )
            next_obs, rewards, dones = self.envs.step(actions)
            self.buffer.add_batch(self._obs, actions, rewards, next_obs, dones)
            self._running_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._episode_returns.append(float(self._running_returns[i]))
                    self._running_returns[i] = 0.0
            self._obs = next_obs
            self._timesteps += n_envs
            self._since_target_sync += n_envs
        if self.buffer.size >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                batch = self._to_device(self.buffer.sample(self._rng, cfg.train_batch_size))
                self.params, self.opt_state, metrics = self._update(
                    self.params, self.target_params, self.opt_state, batch
                )
            if self._since_target_sync >= cfg.target_update_freq:
                self.target_params = clone(self.params)
                self._since_target_sync = 0
        self._episode_returns = self._episode_returns[-100:]
        return {
            "episode_return_mean": float(np.mean(self._episode_returns))
            if self._episode_returns else 0.0,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "epsilon": self._epsilon(),
            **{k: float(v) for k, v in metrics.items()},
        }

    def get_state(self):
        return {
            "params": to_numpy(self.params),
            "target_params": to_numpy(self.target_params),
            "opt_state": state_numpy(self.opt_state),
            "timesteps": self._timesteps,
        }

    def set_state(self, state):
        self.params = load_params(state["params"], self.device)
        self.target_params = params_from_jax(state["target_params"], device=self.device)
        self.opt_state = self.optimizer.load_state(state["opt_state"], self.params, self.device)
        self._timesteps = state["timesteps"]
