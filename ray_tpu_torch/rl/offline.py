"""Offline RL: behavior cloning (BC), advantage-weighted MARWIL and discrete
CQL (port of ``ray_tpu/rl/offline.py``).

Parity: ``rllib/algorithms/bc/``, ``rllib/algorithms/marwil/`` and
``rllib/algorithms/cql/`` — train a policy from a fixed dataset with no
environment interaction. The dataset is duck-typed, as the reference uses
it: any object with ``materialize()`` whose result has
``iter_batches(batch_size=, drop_last=)`` yielding dicts of arrays (a
``ray_tpu.data.Dataset`` works unchanged; the port imports nothing to take
one). MARWIL weights the log-likelihood by exp(beta * advantage / std) with
the population std (``jnp.std``), outside the gradient. CQL's target network
is a snapshot of the online one, Polyak-tracked in place after every step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, load_params
from ray_tpu_torch.rl.optim import (
    Adam,
    clone,
    polyak_,
    state_numpy,
    to_numpy,
    value_and_grad,
)
from ray_tpu_torch.weights import params_from_jax


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 256
        self.beta = 0.0  # 0 => pure BC; >0 => MARWIL advantage weighting
        self.vf_coeff = 1.0
        self.dataset = None  # a dataset with obs/actions[/returns] columns

    def offline_data(self, dataset) -> "BCConfig":
        self.dataset = dataset
        return self

    def build(self, device="cuda") -> "BC":
        return BC(self, device=device)


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0

    def build(self, device="cuda") -> "MARWIL":
        return MARWIL(self, device=device)


def bc_loss(params, batch, beta: float, vf_coeff: float):
    """-> (total, policy loss)."""
    logits, values = apply_mlp_policy(params, batch["obs"])
    logp = torch.log_softmax(logits, dim=-1).gather(1, batch["actions"].long()[:, None])[:, 0]
    if beta > 0.0:
        adv = batch["returns"] - values
        with torch.no_grad():
            weight = torch.exp(beta * (adv / (adv.std(correction=0) + 1e-8)))
        pi_loss = -(weight * logp).mean()
        vf_loss = (adv ** 2).mean()
        return pi_loss + vf_coeff * vf_loss, pi_loss
    pi_loss = -logp.mean()
    return pi_loss, pi_loss


def _greedy_return(params, env_name, num_episodes: int, seed: int, device) -> float:
    """Mean greedy rollout return in the real env (parity: evaluation
    workers)."""
    returns = []
    for ep in range(num_episodes):
        env = make_env(env_name, seed=seed + ep)
        obs, _ = env.reset()
        total, done = 0.0, False
        while not done:
            with torch.no_grad():
                x = torch.as_tensor(np.asarray(obs, np.float32)[None], device=device)
                logits = apply_mlp_policy(params, x)[0][0].cpu().numpy()
            obs, r, term, trunc, _ = env.step(int(np.argmax(logits)))
            total += r
            done = term or trunc
        returns.append(total)
    return float(np.mean(returns))


class _Offline(Algorithm):
    """Reads its dataset in epochs of ``train_batch_size`` rows."""

    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        if config.dataset is None:
            raise ValueError(f"{type(self).__name__}Config.offline_data(dataset) is required")
        spec = make_env(config.env).spec
        self.params = init_mlp_policy(self._generator(config.seed), spec.obs_dim,
                                      spec.num_actions, config.hidden, device=self.device)
        # materialize once; offline data is read-mostly
        self._data = config.dataset.materialize()
        self._epoch_iter = None
        self._samples = 0

    def _raw_batch(self):
        if self._epoch_iter is None:
            self._epoch_iter = self._data.iter_batches(
                batch_size=self.config.train_batch_size, drop_last=True
            )
        try:
            return next(self._epoch_iter)
        except StopIteration:
            self._epoch_iter = self._data.iter_batches(
                batch_size=self.config.train_batch_size, drop_last=True
            )
            try:
                return next(self._epoch_iter)
            except StopIteration:
                raise ValueError(
                    f"offline dataset has fewer rows than train_batch_size="
                    f"{self.config.train_batch_size}"
                ) from None

    def evaluate(self, num_episodes: int = 10, seed: int = 0) -> float:
        return _greedy_return(self.params, self.config.env, num_episodes, seed, self.device)


class BC(_Offline):
    def __init__(self, config: BCConfig, device="cuda"):
        super().__init__(config, device)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = self._make_update()

    def _make_update(self):
        cfg = self.config
        optimizer = self.optimizer

        def update(params, opt_state, batch):
            total, pi_l, grads = value_and_grad(bc_loss, params, batch, cfg.beta, cfg.vf_coeff)
            optimizer.step(params, grads, opt_state)
            return params, opt_state, {"total_loss": total, "policy_loss": pi_l.detach()}

        return update

    def _next_batch(self) -> Dict[str, np.ndarray]:
        batch = self._raw_batch()
        out = {"obs": np.asarray(batch["obs"], np.float32),
               "actions": np.asarray(batch["actions"], np.int32)}
        if self.config.beta > 0.0:
            out["returns"] = np.asarray(batch["returns"], np.float32)
        return out

    def training_step(self) -> Dict[str, Any]:
        metrics = {}
        for _ in range(16):
            batch = self._next_batch()
            self.params, self.opt_state, metrics = self._update(
                self.params, self.opt_state, self._to_device(batch)
            )
            self._samples += len(batch["obs"])
        return {
            "num_samples_trained": self._samples,
            **{k: float(v) for k, v in metrics.items()},
        }

    def get_state(self):
        return {"params": to_numpy(self.params),
                "opt_state": state_numpy(self.opt_state),
                "samples": self._samples}

    def set_state(self, state):
        self.params = load_params(state["params"], self.device)
        self.opt_state = self.optimizer.load_state(state["opt_state"], self.params, self.device)
        self._samples = state["samples"]


class MARWIL(BC):
    pass


class CQLConfig(BCConfig):
    """Conservative Q-Learning on a fixed dataset (parity:
    ``rllib/algorithms/cql/``, Kumar et al. 2020 — discrete CQL(H))."""

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.cql_alpha = 1.0  # conservative-regularizer weight
        self.tau = 0.01  # target-network Polyak rate (applied every step)

    def build(self, device="cuda") -> "CQL":
        return CQL(self, device=device)


def cql_loss(params, target_params, batch, gamma: float, cql_alpha: float):
    """Max-target TD loss plus the CQL(H) penalty
    ``logsumexp_a Q(s,a) - Q(s, a_data)`` -> (total, (td, cql))."""
    q_all = apply_mlp_policy(params, batch["obs"])[0]
    q_data = q_all.gather(1, batch["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next = apply_mlp_policy(target_params, batch["next_obs"])[0]
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next.max(dim=1).values
    td_loss = ((q_data - target) ** 2).mean()
    cql_term = (torch.logsumexp(q_all, dim=1) - q_data).mean()
    return td_loss + cql_alpha * cql_term, (td_loss.detach(), cql_term.detach())


class CQL(_Offline):
    """Discrete CQL: TD learning against a Polyak target plus the
    conservative penalty that pushes down out-of-dataset action values. The
    dataset provides (obs, actions, rewards, next_obs, dones) rows."""

    def __init__(self, config: CQLConfig, device="cuda"):
        super().__init__(config, device)
        # the policy MLP's logits head doubles as Q(s, .); value head unused
        self.target_params = clone(self.params)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = self._make_update()

    def _make_update(self):
        cfg = self.config
        optimizer = self.optimizer

        def update(params, target_params, opt_state, batch):
            total, (td, cql), grads = value_and_grad(cql_loss, params, target_params, batch,
                                                     cfg.gamma, cfg.cql_alpha)
            optimizer.step(params, grads, opt_state)
            polyak_(target_params, params, cfg.tau)
            return params, target_params, opt_state, {
                "total_loss": total,
                "td_loss": td,
                "cql_loss": cql,
            }

        return update

    def _next_batch(self) -> Dict[str, np.ndarray]:
        batch = self._raw_batch()
        return {
            "obs": np.asarray(batch["obs"], np.float32),
            "actions": np.asarray(batch["actions"], np.int32),
            "rewards": np.asarray(batch["rewards"], np.float32),
            "next_obs": np.asarray(batch["next_obs"], np.float32),
            "dones": np.asarray(batch["dones"], np.float32),
        }

    def training_step(self) -> Dict[str, Any]:
        metrics = {}
        for _ in range(16):
            batch = self._next_batch()
            self.params, self.target_params, self.opt_state, metrics = (
                self._update(
                    self.params, self.target_params, self.opt_state, self._to_device(batch)
                )
            )
            self._samples += len(batch["obs"])
        return {
            "num_samples_trained": self._samples,
            **{k: float(v) for k, v in metrics.items()},
        }

    def get_state(self):
        return {
            "params": to_numpy(self.params),
            "target_params": to_numpy(self.target_params),
            "opt_state": state_numpy(self.opt_state),
            "samples": self._samples,
        }

    def set_state(self, state):
        self.params = load_params(state["params"], self.device)
        self.target_params = params_from_jax(state["target_params"], device=self.device)
        self.opt_state = self.optimizer.load_state(state["opt_state"], self.params, self.device)
        self._samples = state["samples"]
