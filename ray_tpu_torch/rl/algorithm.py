"""Algorithm base + fluent config (port of ``ray_tpu/rl/algorithm.py``).

Parity: ``rllib/algorithms/algorithm.py:229`` (Tune-Trainable shape:
``train()`` returns a result dict; ``save``/``restore``) and the fluent
``AlgorithmConfig`` (``algorithm_config.py``): ``.environment(...)``
``.env_runners(...)`` ``.training(...)`` ``.build(device=...)``.

An algorithm runs its learner, and its local env runner's policy, on one
device: ``build(device="cuda")`` by default, which raises without a card.
Remote env runners (``num_env_runners > 0``) are CPU actors on the port's
runtime (``ray_tpu_torch.init()`` first).
"""

from __future__ import annotations

import copy
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


class AlgorithmConfig:
    def __init__(self):
        self.env = "CartPole-v1"
        self.num_env_runners = 0
        self.num_envs_per_runner = 16
        self.rollout_len = 128
        self.lr = 3e-4
        self.gamma = 0.99
        self.seed = 0
        self.hidden = (64, 64)
        # zero-arg factory -> connector list/pipeline (see env_runners)
        self.env_to_module_connector = None

    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int = 0, num_envs_per_env_runner: int = 16,
                    rollout_fragment_length: int = 128,
                    env_to_module_connector=None) -> "AlgorithmConfig":
        """``env_to_module_connector``: zero-arg factory returning a list of
        connectors (or a ConnectorPipeline) applied to observations before
        the module sees/stores them — one fresh instance per runner."""
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_len = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k}")
            setattr(self, k, v)
        return self

    def debugging(self, seed: int = 0) -> "AlgorithmConfig":
        self.seed = seed
        return self

    def build(self, device="cuda"):
        raise NotImplementedError


class Algorithm:
    """Base: iteration counter, device, checkpointing, Tune-compatible
    train(), greedy inference and evaluation."""

    def __init__(self, config: AlgorithmConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.iteration = 0

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        result = self.training_step()
        result["training_iteration"] = self.iteration
        return result

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as fh:
            pickle.dump({"iteration": self.iteration, "state": self.get_state()}, fh)
        return path

    def restore(self, path: str) -> None:
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as fh:
            blob = pickle.load(fh)
        self.iteration = blob["iteration"]
        self.set_state(blob["state"])

    # -- inference / evaluation --------------------------------------------

    def _policy_params(self):
        """The MLP-policy param tree actions come from. Policy-gradient
        algos expose ``self.params``; SAC's actor is ``self.actor``."""
        params = getattr(self, "params", None)
        if params is None:
            params = getattr(self, "actor", None)
        if params is None:
            raise NotImplementedError(
                f"{type(self).__name__} does not expose policy params for "
                "single-action inference"
            )
        return params

    def compute_single_action(self, obs, explore: bool = False) -> int:
        """Action for one MODULE-space observation — i.e. after any
        configured env-to-module connector pipeline has transformed it
        (``evaluate`` does this). ``explore=False`` is greedy (argmax over
        the policy/Q logits); ``explore=True`` samples, seeded from
        ``config.seed``."""
        from ray_tpu_torch.rl.models import apply_mlp_policy

        x = torch.as_tensor(np.asarray(obs, np.float32)[None], device=self.device)
        with torch.no_grad():
            logits = apply_mlp_policy(self._policy_params(), x)[0][0].cpu().numpy()
        if explore:
            rng = getattr(self, "_explore_rng", None)
            if rng is None:
                rng = self._explore_rng = np.random.default_rng(
                    getattr(self.config, "seed", 0)
                )
            z = rng.gumbel(size=logits.shape)
            return int(np.argmax(logits + z))
        return int(np.argmax(logits))

    def evaluate(self, num_episodes: int = 5, seed: int = 10_000,
                 max_steps_per_episode: int = 1000) -> Dict[str, Any]:
        """Greedy evaluation rollouts on fresh envs, with the configured
        env-to-module connector pipeline applied exactly as the training
        runner applies it, from the runner's trained connector state loaded
        into a private copy (evaluation does not advance its statistics)."""
        from ray_tpu_torch.rl.env import make_env
        from ray_tpu_torch.rl.env_runner import _build_pipeline

        pipe = _build_pipeline(getattr(self.config, "env_to_module_connector", None))
        if pipe is not None:
            # ALWAYS a private copy: a config holding connector INSTANCES
            # (not a factory) shares them with the training runner
            pipe = copy.deepcopy(pipe)
        runners = getattr(self, "runners", None)
        if pipe is not None and runners is not None:
            state = runners.connector_state()
            if state is not None:
                pipe.set_state(copy.deepcopy(state))
        returns = []
        lengths = []
        for ep in range(num_episodes):
            env = make_env(self.config.env, seed=seed + ep)
            try:
                # callable creators ignore make_env's seed: reseed on reset
                obs = env.reset(seed=seed + ep)[0]
            except TypeError:
                obs = env.reset()[0]
            total, steps = 0.0, 0
            for _ in range(max_steps_per_episode):
                raw = np.asarray(obs, np.float32)[None]
                mod_obs = pipe(raw)[0] if pipe else raw[0]
                action = self.compute_single_action(mod_obs)
                if pipe:
                    action = int(pipe.transform_action(np.asarray([action]))[0])
                obs, reward, term, trunc, _ = env.step(action)
                total += float(reward)
                steps += 1
                if term or trunc:
                    break
            returns.append(total)
            lengths.append(steps)
        return {
            "evaluation": {
                "episode_return_mean": float(np.mean(returns)),
                "episode_return_min": float(np.min(returns)),
                "episode_return_max": float(np.max(returns)),
                "episode_len_mean": float(np.mean(lengths)),
                "episodes_this_iter": num_episodes,
            }
        }

    def stop(self) -> None:
        pass
