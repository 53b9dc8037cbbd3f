"""Multi-agent RL: env contract, multi-agent episode collection, and
per-policy PPO learning (port of ``ray_tpu/rl/multi_agent.py``).

Parity: ``rllib/env/multi_agent_env.py`` (the dict-keyed env API with the
``__all__`` termination sentinel), ``rllib/env/multi_agent_env_runner.py``
(episode collection with a policy-mapping function), and the multi-RLModule
learner (``rllib/core/rl_module/multi_rl_module.py``): each policy id owns
its own module (params + optimizer state); one update function is shared
across policies and applied per-policy to its own batch. The env contract
and the collector are numpy, copied from the reference; acting runs each
policy's net on the algorithm's device, and the Gumbel draws, log-probs and
minibatch permutations are the reference's numpy ones, in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import CartPoleEnv, make_env
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, load_params
from ray_tpu_torch.rl.optim import Adam, to_numpy, value_and_grad
from ray_tpu_torch.rl.ppo import ppo_loss


class MultiAgentEnv:
    """The multi-agent env contract (parity: ``MultiAgentEnv``):

    * ``reset() -> (obs_dict, info_dict)`` keyed by agent id;
    * ``step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)``
      where ``terminateds["__all__"]`` / ``truncateds["__all__"]`` end the
      episode. Agents absent from ``obs`` need no action next step.
    """

    agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles, one per agent (the reference's own
    multi-agent test env, ``rllib/examples/envs/classes/multi_agent/``).
    The episode ends when EVERY agent's pole has fallen (or time caps)."""

    def __init__(self, num_agents: int = 2, seed: Optional[int] = None):
        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {
            aid: CartPoleEnv(seed=None if seed is None else seed + i)
            for i, aid in enumerate(self.agents)
        }
        self.spec = CartPoleEnv.spec
        self._done: Dict[str, bool] = {}

    def reset(self, *, seed: Optional[int] = None):
        obs = {}
        for i, (aid, env) in enumerate(self._envs.items()):
            obs[aid], _ = env.reset(seed=None if seed is None else seed + i)
        self._done = {aid: False for aid in self.agents}
        return obs, {}

    def step(self, action_dict: Dict[str, Any]):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for aid, action in action_dict.items():
            if self._done.get(aid, True):
                continue
            o, r, term, trunc, info = self._envs[aid].step(int(action))
            rewards[aid] = r
            terms[aid] = term
            truncs[aid] = trunc
            infos[aid] = info
            if term or trunc:
                self._done[aid] = True
            else:
                obs[aid] = o
        all_done = all(self._done.values())
        terms["__all__"] = all_done and not any(truncs.values())
        truncs["__all__"] = all_done and any(truncs.values())
        return obs, rewards, terms, truncs, infos


class _MultiAgentEpisodeCollector:
    """Steps N multi-agent env copies, routing each agent through its
    policy (parity: ``multi_agent_env_runner.py`` episode collection)."""

    def __init__(self, env_creator, n_envs: int, policy_mapping_fn, seed: int):
        self._envs = [env_creator(seed=seed + i) for i in range(n_envs)]
        self._map = policy_mapping_fn
        self._obs = [e.reset(seed=seed + i)[0] for i, e in enumerate(self._envs)]
        self._returns = [dict() for _ in self._envs]
        self.completed_returns: Dict[str, List[float]] = {}

    def collect(self, act_fn, rollout_len: int) -> Dict[str, Dict[str, np.ndarray]]:
        """``act_fn(policy_id, obs_batch) -> (actions, logp, values)``.
        Returns per-policy batches of T-major transition arrays."""
        # per policy: lists of transition dicts
        steps: Dict[str, Dict[str, list]] = {}

        def bucket(pid):
            return steps.setdefault(
                pid,
                {
                    k: []
                    for k in (
                        "obs",
                        "actions",
                        "logp",
                        "values",
                        "rewards",
                        "dones",
                        "lanes",
                    )
                },
            )

        # stable integer id per (env_idx, agent_id) lane: the flat per-policy
        # stream interleaves lanes per timestep, and GAE must bootstrap each
        # transition from its OWN lane's successor, not the next array row
        lane_ids: Dict[Tuple[int, str], int] = {}

        for _ in range(rollout_len):
            # group live (env_idx, agent_id) pairs by policy
            by_policy: Dict[str, List[Tuple[int, str]]] = {}
            for ei, obs in enumerate(self._obs):
                for aid in obs:
                    by_policy.setdefault(self._map(aid), []).append((ei, aid))
            actions_per_env: List[Dict[str, int]] = [dict() for _ in self._envs]
            pending = {}  # (ei, aid) -> (pid, action, logp, value)
            for pid, pairs in by_policy.items():
                batch = np.stack([self._obs[ei][aid] for ei, aid in pairs])
                actions, logp, values = act_fn(pid, batch)
                for j, (ei, aid) in enumerate(pairs):
                    actions_per_env[ei][aid] = int(actions[j])
                    pending[(ei, aid)] = (pid, batch[j], int(actions[j]),
                                          float(logp[j]), float(values[j]))
            for ei, env in enumerate(self._envs):
                if not actions_per_env[ei]:
                    continue
                obs2, rewards, terms, truncs, _ = env.step(actions_per_env[ei])
                for aid, act in actions_per_env[ei].items():
                    pid, ob, a, lp, v = pending[(ei, aid)]
                    done = terms.get(aid, False) or truncs.get(aid, False)
                    b = bucket(pid)
                    b["obs"].append(ob)
                    b["actions"].append(a)
                    b["logp"].append(lp)
                    b["values"].append(v)
                    b["rewards"].append(rewards.get(aid, 0.0))
                    b["dones"].append(float(done))
                    b["lanes"].append(
                        lane_ids.setdefault((ei, aid), len(lane_ids))
                    )
                    ret = self._returns[ei]
                    ret[aid] = ret.get(aid, 0.0) + rewards.get(aid, 0.0)
                if terms.get("__all__") or truncs.get("__all__"):
                    for aid, total in self._returns[ei].items():
                        self.completed_returns.setdefault(
                            self._map(aid), []
                        ).append(total)
                    self._returns[ei] = {}
                    obs2, _ = env.reset()
                self._obs[ei] = obs2
        return {
            pid: {k: np.asarray(v, np.float32 if k != "actions" else np.int32)
                  for k, v in b.items()}
            for pid, b in steps.items()
        }


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.gae_lambda = 0.95
        self.num_epochs = 8
        self.minibatch_size = 512
        self.grad_clip = 0.5
        self.policies: List[str] = []
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: aid

    def multi_agent(
        self,
        policies: List[str],
        policy_mapping_fn: Optional[Callable[[str], str]] = None,
    ) -> "MultiAgentPPOConfig":
        """Parity: ``AlgorithmConfig.multi_agent(policies=...,
        policy_mapping_fn=...)``."""
        self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self, device="cuda") -> "MultiAgentPPO":
        return MultiAgentPPO(self, device=device)


class MultiAgentPPO(Algorithm):
    """PPO with one module per policy id (parity: MultiRLModule + the
    multi-agent learner path)."""

    def __init__(self, config: MultiAgentPPOConfig, device="cuda"):
        super().__init__(config, device)
        if not config.policies:
            raise ValueError("use .multi_agent(policies=[...]) first")
        probe = make_env(config.env) if not callable(config.env) else config.env()
        spec = probe.spec
        self.optimizer = Adam(config.lr, grad_clip=config.grad_clip)
        # per-policy modules: independent params + optimizer state
        self.params: Dict[str, Any] = {}
        self.opt_states: Dict[str, Any] = {}
        for i, pid in enumerate(config.policies):
            p = init_mlp_policy(self._generator(config.seed + i), spec.obs_dim,
                                spec.num_actions, config.hidden, device=self.device)
            self.params[pid] = p
            self.opt_states[pid] = self.optimizer.init(p)
        self._update = self._make_update()
        self._act = torch.no_grad()(apply_mlp_policy)

        def _create(seed=None):
            if callable(config.env):
                try:
                    return config.env(seed=seed)
                except TypeError:
                    return config.env()
            return make_env(config.env, seed=seed)

        self._collector = _MultiAgentEpisodeCollector(
            _create,
            config.num_envs_per_runner,
            config.policy_mapping_fn,
            config.seed,
        )
        self._rng = np.random.default_rng(config.seed)
        self._timesteps = 0

    def _make_update(self):
        cfg = self.config
        optimizer = self.optimizer

        def update(params, opt_state, batch):
            loss, _, grads = value_and_grad(ppo_loss, params, batch, cfg.clip_param,
                                            cfg.vf_loss_coeff, cfg.entropy_coeff)
            optimizer.step(params, grads, opt_state)
            return params, opt_state, loss

        return update

    def _act_fn(self, pid: str, obs: np.ndarray):
        # no power-of-two padding as in the reference (it exists for jit's
        # shapes): the draws below follow the live rows only, as there
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        logits, values = self._act(self.params[pid], x)
        logits = logits.cpu().numpy()
        values = values.cpu().numpy()
        # sample from the categorical policy
        u = self._rng.gumbel(size=logits.shape)
        actions = np.argmax(logits + u, axis=1)
        logp_all = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        logp = np.take_along_axis(logp_all, actions[:, None], axis=1)[:, 0]
        return actions, logp, values

    def _gae_flat(self, b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Per-policy GAE over the flat transition stream, PER LANE (lane
        ids carried by the collector): each transition bootstraps from its
        own lane's successor, with ``done`` as the episode boundary inside
        a lane."""
        cfg = self.config
        rewards, values, dones = b["rewards"], b["values"], b["dones"]
        lanes = b.get("lanes")
        n = len(rewards)
        adv = np.zeros(n, np.float32)
        lane_keys = (
            np.zeros(n, np.int32) if lanes is None else lanes.astype(np.int32)
        )
        for lane in np.unique(lane_keys):
            idx = np.nonzero(lane_keys == lane)[0]  # time-ordered
            last_adv = 0.0
            next_value = 0.0
            for t in idx[::-1]:
                nonterminal = 1.0 - dones[t]
                delta = rewards[t] + cfg.gamma * next_value * nonterminal - values[t]
                last_adv = delta + cfg.gamma * cfg.gae_lambda * nonterminal * last_adv
                adv[t] = last_adv
                next_value = values[t]
        returns = adv + values
        return {
            "obs": b["obs"],
            "actions": b["actions"].astype(np.int32),
            "logp_old": b["logp"],
            "advantages": (adv - adv.mean()) / (adv.std() + 1e-8),
            "returns": returns,
        }

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        per_policy = self._collector.collect(self._act_fn, cfg.rollout_len)
        metrics: Dict[str, Any] = {}
        for pid, raw in per_policy.items():
            batch = self._gae_flat(raw)
            on_device = self._to_device(batch)
            n = len(batch["obs"])
            self._timesteps += n
            loss = 0.0
            mb = min(cfg.minibatch_size, 256)  # the reference's one compiled shape
            for _ in range(cfg.num_epochs):
                perm = self._rng.permutation(n)
                for start in range(0, n, mb):
                    idx = perm[start : start + mb]
                    if len(idx) < mb:
                        # pad the ragged tail with resampled rows, as the
                        # reference does (same draws, same minibatches)
                        idx = np.concatenate(
                            [idx, self._rng.integers(0, n, mb - len(idx))]
                        )
                    idx = torch.from_numpy(idx).to(self.device)
                    mini = {k: v[idx] for k, v in on_device.items()}
                    self.params[pid], self.opt_states[pid], loss = self._update(
                        self.params[pid], self.opt_states[pid], mini
                    )
            metrics[f"{pid}/loss"] = float(loss)
        returns_all: List[float] = []
        for pid, rets in self._collector.completed_returns.items():
            rets[:] = rets[-100:]
            if rets:
                metrics[f"{pid}/episode_return_mean"] = float(np.mean(rets))
                returns_all.extend(rets)
        metrics["episode_return_mean"] = (
            float(np.mean(returns_all)) if returns_all else 0.0
        )
        metrics["num_env_steps_sampled_lifetime"] = self._timesteps
        return metrics

    def get_state(self):
        return {
            "params": {pid: to_numpy(p) for pid, p in self.params.items()},
            "timesteps": self._timesteps,
        }

    def set_state(self, state):
        self.params.update({pid: load_params(p, self.device)
                            for pid, p in state["params"].items()})
        self._timesteps = state.get("timesteps", 0)
