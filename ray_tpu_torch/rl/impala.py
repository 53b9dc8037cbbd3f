"""IMPALA: actor-learner RL with V-trace off-policy correction (port of
``ray_tpu/rl/impala.py``, single device).

Parity: ``rllib/algorithms/impala/impala.py:1`` (V-trace from Espeholt et
al. 2018). The reference's learner is one jitted SPMD program over a
``data``-axis mesh, or a group of learner processes; the port's learner is
one clipped Adam step on one device. ``num_learner_devices > 1`` waits for
the port's mesh and ``num_learner_workers > 1`` for an actor runtime: both
raise ``NotImplementedError``. The batch keeps the reference's lane mask
(padded env lanes weigh nothing in the loss).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup, resolve_obs_dim
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, load_params
from ray_tpu_torch.rl.optim import Adam, to_numpy, value_and_grad


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 6e-4
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.grad_clip = 40.0
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.num_learner_devices = 1
        self.num_learner_workers = 1
        self.learner_runtime_env = None
        self.num_cpus_per_learner = 1.0

    def learners(
        self,
        num_learner_devices: int = 1,
        num_learner_workers: int = 1,
        learner_runtime_env=None,
        num_cpus_per_learner: float = 1.0,
    ) -> "IMPALAConfig":
        self.num_learner_devices = num_learner_devices
        self.num_learner_workers = num_learner_workers
        self.learner_runtime_env = learner_runtime_env
        self.num_cpus_per_learner = num_cpus_per_learner
        return self

    def build(self, device="cuda") -> "IMPALA":
        return IMPALA(self, device=device)


@torch.no_grad()
def vtrace_targets(values, last_values, rewards, dones, rhos, gamma, clip_rho=1.0, clip_c=1.0):
    """V-trace targets vs_t and policy-gradient advantages.

    values/rewards/dones/rhos: (T, N); last_values: (N,). Returns
    (vs (T,N), pg_adv (T,N)), both outside the autograd graph (the
    reference's ``stop_gradient``). A reverse loop over T stands in for
    ``lax.scan``.
    """
    rho_bar = torch.clamp(rhos, max=clip_rho)
    c_bar = torch.clamp(rhos, max=clip_c)
    discounts = gamma * (1.0 - dones.float())
    values_next = torch.cat([values[1:], last_values[None]], dim=0)
    deltas = rho_bar * (rewards + discounts * values_next - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(last_values)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * c_bar[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    vs_next = torch.cat([vs[1:], last_values[None]], dim=0)
    pg_adv = rho_bar * (rewards + discounts * vs_next - values)
    return vs, pg_adv


def _policy_terms(params, batch):
    """Per-step log-probabilities, all log-probabilities, values and the
    importance ratios pi/mu of a (T, N) batch."""
    T, N = batch["actions"].shape
    logits, values = apply_mlp_policy(params, batch["obs"].reshape(T * N, -1))
    logp_all = torch.log_softmax(logits.reshape(T, N, -1), dim=-1)
    logp = logp_all.gather(-1, batch["actions"].long()[..., None])[..., 0]
    rhos = torch.exp(logp - batch["logp"])  # pi / mu
    return logp, logp_all, values.reshape(T, N), rhos


def _masked_terms(values, vs, logp_all, w, T):
    denom = torch.clamp(w.sum() * T, min=1.0)
    vf_loss = 0.5 * (((values - vs) ** 2) * w).sum() / denom
    entropy = -((torch.exp(logp_all) * logp_all).sum(dim=-1) * w).sum() / denom
    return denom, vf_loss, entropy


def impala_loss(params, batch, cfg_vals):
    logp, logp_all, values, rhos = _policy_terms(params, batch)
    vs, pg_adv = vtrace_targets(values, batch["last_values"], batch["rewards"], batch["dones"],
                                rhos.detach(), cfg_vals["gamma"], cfg_vals["vtrace_clip_rho"],
                                cfg_vals["vtrace_clip_c"])
    # padded env lanes are masked out of every term
    w = batch["mask"][None, :]
    denom, vf_loss, entropy = _masked_terms(values, vs, logp_all, w, logp.shape[0])
    pg_loss = -(logp * pg_adv * w).sum() / denom
    loss = pg_loss + cfg_vals["vf_loss_coeff"] * vf_loss - cfg_vals["entropy_coeff"] * entropy
    return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}


def _build_update(loss_fn, cfg_vals: Dict[str, Any], optimizer: Adam):
    def update(params, opt_state, batch):
        _, metrics, grads = value_and_grad(loss_fn, params, batch, cfg_vals)
        optimizer.step(params, grads, opt_state)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return update


def build_impala_update(cfg_vals: Dict[str, Any], optimizer: Adam):
    """The IMPALA learner update as a function of plain config values:
    ``update(params, opt_state, batch) -> (params, opt_state, metrics)``,
    stepping ``params`` and ``opt_state`` in place."""
    return _build_update(impala_loss, cfg_vals, optimizer)


def resolve_update_builder(name: str):
    """Update builders by name, as the reference's learner workers take them."""
    if name == "appo":
        from ray_tpu_torch.rl.appo import build_appo_update

        return build_appo_update
    return build_impala_update


class IMPALA(Algorithm):
    # subclasses (APPO) swap the learner update
    @classmethod
    def _update_builder_name(cls) -> str:
        return "impala"

    @classmethod
    def _extra_cfg_vals(cls, config) -> Dict[str, Any]:
        return {}

    def __init__(self, config: IMPALAConfig, device="cuda"):
        if int(config.num_learner_devices) > 1:
            raise NotImplementedError(
                "num_learner_devices > 1 needs the port's device mesh, which it does not have "
                "yet; use one learner device")
        if int(config.num_learner_workers) > 1:
            raise NotImplementedError(
                "num_learner_workers > 1 needs learner actors, which the port does not have")
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
        self._cfg_vals = {
            "gamma": config.gamma,
            "vtrace_clip_rho": config.vtrace_clip_rho,
            "vtrace_clip_c": config.vtrace_clip_c,
            "vf_loss_coeff": config.vf_loss_coeff,
            "entropy_coeff": config.entropy_coeff,
            **self._extra_cfg_vals(config),
        }
        self._update = resolve_update_builder(self._update_builder_name())(
            self._cfg_vals, self.optimizer)
        self._recent_returns: List[float] = []
        self._timesteps = 0

    # -- training ----------------------------------------------------------

    def training_step(self) -> Dict[str, Any]:
        rollouts = self.runners.sample(self.params)
        # concatenate runner rollouts along the env axis
        batch = {
            k: np.concatenate([r[k] for r in rollouts], axis=1)
            for k in ("obs", "actions", "logp", "rewards", "dones")
        }
        batch["last_values"] = np.concatenate([r["last_values"] for r in rollouts])
        for r in rollouts:
            self._recent_returns.extend(r["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        T, N = batch["actions"].shape
        # one learner device: no lane is padded
        batch["mask"] = np.ones(N, np.float32)
        batch = {
            k: v.astype(np.float32) if v.dtype == bool else v for k, v in batch.items()
        }
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, self._to_device(batch)
        )
        self._timesteps += T * N
        mean_ret = (
            float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
        )
        return {
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "num_healthy_workers": self.runners.num_healthy(),
            **{k: float(v) for k, v in metrics.items()},
        }

    # -- checkpointing (Tune-Trainable shape) ------------------------------

    def get_state(self):
        return {
            "params": to_numpy(self.params),
            "timesteps": self._timesteps,
        }

    def set_state(self, state):
        self.params = load_params(state["params"], self.device)
        self._timesteps = state.get("timesteps", 0)

    def stop(self):
        self.runners.stop()
