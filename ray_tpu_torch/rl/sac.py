"""SAC (discrete actions): maximum-entropy off-policy RL (port of
``ray_tpu/rl/sac.py``).

Parity: ``rllib/algorithms/sac/`` — twin soft Q networks with Polyak target
tracking, a stochastic (categorical) actor, and an auto-tuned entropy
temperature alpha, with exact expectations over the action simplex. One
update steps the critics, then the actor against the updated critics, then
log-alpha, then moves the target critics toward the critics, in place. The
targets start as snapshots of the critics (not aliases: the critics are
updated in place). Acting draws its Gumbel noise, and replay its indices,
from the same numpy generator as the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.dqn import _ReplayBuffer
from ray_tpu_torch.rl.env import VectorEnv, make_env
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, load_params
from ray_tpu_torch.rl.optim import Adam, clone, polyak_, to_numpy, value_and_grad


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.alpha_lr = 3e-4
        self.buffer_size = 50_000
        self.learning_starts = 1_000
        self.train_batch_size = 128
        self.tau = 0.01  # polyak coefficient for target critics
        self.target_entropy_fraction = 0.7  # of max entropy log(|A|)
        self.initial_alpha = 0.2
        self.updates_per_iter = 64
        self.steps_per_iter = 512

    def build(self, device="cuda") -> "SAC":
        return SAC(self, device=device)


def _pi_stats(actor, obs):
    logp = torch.log_softmax(apply_mlp_policy(actor, obs)[0], dim=-1)
    return torch.exp(logp), logp


def _q_loss(q_params, target, batch):
    q = apply_mlp_policy(q_params, batch["obs"])[0]
    q_taken = q.gather(1, batch["actions"].long()[:, None])[:, 0]
    return ((q_taken - target) ** 2).mean(), None


def _actor_loss(actor, qmin, alpha, obs):
    probs, logp = _pi_stats(actor, obs)
    # E_a~pi [ alpha*logpi - Q ], exact over the simplex
    loss = (probs * (alpha * logp - qmin)).sum(dim=1).mean()
    entropy = -(probs * logp).sum(dim=1).mean()
    return loss, entropy.detach()


def _qmin(q1, q2, obs):
    return torch.minimum(apply_mlp_policy(q1, obs)[0], apply_mlp_policy(q2, obs)[0])


class SAC(Algorithm):
    def __init__(self, config: SACConfig, device="cuda"):
        super().__init__(config, device)
        spec = make_env(config.env).spec
        self._n_actions = spec.num_actions
        gen = self._generator(config.seed)
        # actor: logits head; critics: the pi head doubles as per-action Q
        self.actor, self.q1, self.q2 = (
            init_mlp_policy(gen, spec.obs_dim, spec.num_actions, config.hidden,
                            device=self.device) for _ in range(3))
        self.q1_target = clone(self.q1)
        self.q2_target = clone(self.q2)
        self.log_alpha = torch.tensor(math.log(config.initial_alpha), dtype=torch.float32,
                                      device=self.device, requires_grad=True)
        self.actor_opt = Adam(config.lr)
        self.q_opt = Adam(config.lr)
        self.alpha_opt = Adam(config.alpha_lr)
        self.actor_state = self.actor_opt.init(self.actor)
        self.q1_state = self.q_opt.init(self.q1)
        self.q2_state = self.q_opt.init(self.q2)
        self.alpha_state = self.alpha_opt.init(self.log_alpha)
        self._target_entropy = config.target_entropy_fraction * float(
            np.log(spec.num_actions)
        )
        self._update = self._make_update()
        self._policy_logits = self._make_policy_logits()
        self.envs = VectorEnv(config.env, config.num_envs_per_runner, seed=config.seed)
        self._obs = self.envs.reset()
        self.buffer = _ReplayBuffer(config.buffer_size, spec.obs_dim)
        self._rng = np.random.default_rng(config.seed)
        self._timesteps = 0
        self._episode_returns: List[float] = []
        self._running_returns = np.zeros(config.num_envs_per_runner, np.float32)

    def _make_policy_logits(self):
        dev = self.device

        @torch.no_grad()
        def policy_logits(actor, obs):
            x = torch.from_numpy(np.asarray(obs, np.float32)).to(dev)
            return apply_mlp_policy(actor, x)[0].cpu().numpy()

        return policy_logits

    def _make_update(self):
        cfg = self.config
        target_entropy = self._target_entropy

        def update(batch):
            with torch.no_grad():
                alpha = torch.exp(self.log_alpha)
                # soft targets: r + gamma * E_a'~pi [ Qmin_target - alpha*logpi ]
                probs_next, logp_next = _pi_stats(self.actor, batch["next_obs"])
                qmin_next = _qmin(self.q1_target, self.q2_target, batch["next_obs"])
                v_next = (probs_next * (qmin_next - alpha * logp_next)).sum(dim=1)
                target = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * v_next

            q1_l, _, q1_g = value_and_grad(_q_loss, self.q1, target, batch)
            q2_l, _, q2_g = value_and_grad(_q_loss, self.q2, target, batch)
            self.q_opt.step(self.q1, q1_g, self.q1_state)
            self.q_opt.step(self.q2, q2_g, self.q2_state)

            with torch.no_grad():
                qmin = _qmin(self.q1, self.q2, batch["obs"])
            a_l, entropy, a_g = value_and_grad(_actor_loss, self.actor, qmin, alpha,
                                               batch["obs"])
            self.actor_opt.step(self.actor, a_g, self.actor_state)

            # temperature: drive entropy toward the target; d/dlog_a of
            # exp(log_a) * stop(entropy - target)
            al_g = alpha * (entropy - target_entropy)
            self.alpha_opt.step(self.log_alpha, [al_g], self.alpha_state)

            # polyak-track the target critics
            polyak_(self.q1_target, self.q1, cfg.tau)
            polyak_(self.q2_target, self.q2, cfg.tau)
            return {
                "q1_loss": q1_l,
                "q2_loss": q2_l,
                "actor_loss": a_l,
                "entropy": entropy,
                "alpha": alpha,
            }

        return update

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_envs = cfg.num_envs_per_runner
        metrics: Dict[str, Any] = {}
        for _ in range(max(1, cfg.steps_per_iter // n_envs)):
            logits = self._policy_logits(self.actor, self._obs)
            u = self._rng.gumbel(size=logits.shape)
            actions = np.argmax(logits + u, axis=1)  # sample from pi
            next_obs, rewards, dones = self.envs.step(actions)
            self.buffer.add_batch(self._obs, actions, rewards, next_obs, dones)
            self._running_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._episode_returns.append(float(self._running_returns[i]))
                    self._running_returns[i] = 0.0
            self._obs = next_obs
            self._timesteps += n_envs
        if self.buffer.size >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                batch = self._to_device(self.buffer.sample(self._rng, cfg.train_batch_size))
                metrics = self._update(batch)
        self._episode_returns = self._episode_returns[-100:]
        return {
            "episode_return_mean": float(np.mean(self._episode_returns))
            if self._episode_returns else 0.0,
            "num_env_steps_sampled_lifetime": self._timesteps,
            **{k: float(v) for k, v in metrics.items()},
        }

    def get_state(self):
        return {
            "actor": to_numpy(self.actor),
            "q1": to_numpy(self.q1),
            "q2": to_numpy(self.q2),
            "log_alpha": to_numpy(self.log_alpha),
            "timesteps": self._timesteps,
        }

    def set_state(self, state):
        self.actor = load_params(state["actor"], self.device)
        self.q1 = load_params(state["q1"], self.device)
        self.q2 = load_params(state["q2"], self.device)
        self.q1_target = clone(self.q1)
        self.q2_target = clone(self.q2)
        self.log_alpha = load_params(np.asarray(state["log_alpha"], np.float32), self.device)
        self._timesteps = state.get("timesteps", 0)
