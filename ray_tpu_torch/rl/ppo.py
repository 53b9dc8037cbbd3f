"""PPO: clipped-surrogate policy optimization (port of ``ray_tpu/rl/ppo.py``).

Parity: ``rllib/algorithms/ppo/`` — GAE advantages (numpy), clipped policy
loss + value loss + entropy bonus, minibatch epochs with the reference's
``default_rng(iteration)`` permutations; the learner update is one clipped
Adam step on the algorithm's device. Learning target parity: CartPole-v1
return >= 150 (``rllib/tuned_examples/ppo/cartpole-ppo.yaml:5-7``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup, resolve_obs_dim
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, load_params
from ray_tpu_torch.rl.optim import Adam, state_numpy, to_numpy, value_and_grad


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.gae_lambda = 0.95
        self.num_epochs = 8
        self.minibatch_size = 512
        self.grad_clip = 0.5

    def build(self, device="cuda") -> "PPO":
        return PPO(self, device=device)


def ppo_loss(params, batch, clip_param: float, vf_loss_coeff: float, entropy_coeff: float):
    """PPO's loss on one minibatch -> (total, (pi_loss, vf_loss, entropy))."""
    logits, values = apply_mlp_policy(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    pi_loss = -surr.mean()
    vf_loss = ((values - batch["returns"]) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
    total = pi_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
    return total, (pi_loss, vf_loss, entropy)


class PPO(Algorithm):
    def __init__(self, config: PPOConfig, device="cuda"):
        super().__init__(config, device)
        spec = make_env(config.env).spec
        obs_dim = resolve_obs_dim(config, spec)
        self.params = init_mlp_policy(self._generator(config.seed), obs_dim, spec.num_actions,
                                      config.hidden, device=self.device)
        self.optimizer = Adam(config.lr, grad_clip=config.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        self.runners = EnvRunnerGroup(
            config.env,
            config.num_env_runners,
            config.num_envs_per_runner,
            config.rollout_len,
            seed=config.seed,
            connectors=getattr(config, "env_to_module_connector", None),
            device=self.device,
        )
        self._update = self._make_update()
        self._recent_returns: List[float] = []
        self._timesteps = 0

    # -- loss/update -------------------------------------------------------

    def _make_update(self):
        cfg = self.config
        optimizer = self.optimizer

        def update(params, opt_state, batch):
            total, (pi_l, vf_l, ent), grads = value_and_grad(
                ppo_loss, params, batch, cfg.clip_param, cfg.vf_loss_coeff, cfg.entropy_coeff)
            optimizer.step(params, grads, opt_state)
            return params, opt_state, {
                "total_loss": total,
                "policy_loss": pi_l.detach(),
                "vf_loss": vf_l.detach(),
                "entropy": ent.detach(),
            }

        return update

    # -- GAE ---------------------------------------------------------------

    def _gae(self, rollout) -> Dict[str, np.ndarray]:
        cfg = self.config
        rewards, values, dones = rollout["rewards"], rollout["values"], rollout["dones"]
        T, N = rewards.shape
        adv = np.zeros((T, N), np.float32)
        last_adv = np.zeros(N, np.float32)
        next_value = rollout["last_values"]
        for t in reversed(range(T)):
            nonterminal = 1.0 - dones[t].astype(np.float32)
            delta = rewards[t] + cfg.gamma * next_value * nonterminal - values[t]
            last_adv = delta + cfg.gamma * cfg.gae_lambda * nonterminal * last_adv
            adv[t] = last_adv
            next_value = values[t]
        returns = adv + values
        flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731
        return {
            "obs": flat(rollout["obs"]),
            "actions": flat(rollout["actions"]),
            "logp_old": flat(rollout["logp"]),
            "advantages": flat(adv),
            "returns": flat(returns),
        }

    # -- training step -----------------------------------------------------

    def training_step(self) -> Dict[str, Any]:
        rollouts = self.runners.sample(self.params)
        batches = [self._gae(r) for r in rollouts]
        batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        n = len(batch["obs"])
        self._timesteps += n
        rng = np.random.default_rng(self.iteration)
        on_device = self._to_device(batch)
        metrics = {}
        for _ in range(self.config.num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for start in range(0, n, self.config.minibatch_size):
                idx = perm[start : start + self.config.minibatch_size]
                mini = {k: v[idx] for k, v in on_device.items()}
                self.params, self.opt_state, metrics = self._update(
                    self.params, self.opt_state, mini
                )
        for r in rollouts:
            self._recent_returns.extend(r["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (
            float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
        )
        return {
            "episode_return_mean": mean_return,
            "num_env_steps_sampled_lifetime": self._timesteps,
            **{k: float(v) for k, v in metrics.items()},
        }

    # -- state -------------------------------------------------------------

    def get_state(self):
        return {
            "params": to_numpy(self.params),
            "opt_state": state_numpy(self.opt_state),
            "timesteps": self._timesteps,
        }

    def set_state(self, state):
        self.params = load_params(state["params"], self.device)
        self.opt_state = self.optimizer.load_state(state["opt_state"], self.params, self.device)
        self._timesteps = state["timesteps"]

    def stop(self):
        self.runners.stop()
