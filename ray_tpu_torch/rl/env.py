"""Environment API and built-in envs (numpy; the port's own copy of
``ray_tpu/rl/env.py``, with its own env registry).

Parity: RLlib's gymnasium-based env layer; the API matches gymnasium
(``reset() -> (obs, info)``, ``step() -> (obs, reward, terminated, truncated,
info)``) so user gym envs drop in. CartPole dynamics follow the classic
control formulation (public standard: Barto, Sutton & Anderson 1983) so the
reference's tuned-example learning thresholds are comparable.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class EnvSpec:
    def __init__(self, obs_dim: int, num_actions: int, max_episode_steps: int):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.max_episode_steps = max_episode_steps


class CartPoleEnv:
    """CartPole-v1-compatible: pole balancing, +1 reward/step, 500-step cap."""

    spec = EnvSpec(obs_dim=4, num_actions=2, max_episode_steps=500)

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._state = None
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costh, sinth = math.cos(theta), math.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        pml = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + pml * theta_dot**2 * sinth) / total_mass
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * costh**2 / total_mass)
        )
        x_acc = temp - pml * theta_acc * costh / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(
            x < -self.X_LIMIT
            or x > self.X_LIMIT
            or theta < -self.THETA_LIMIT
            or theta > self.THETA_LIMIT
        )
        truncated = self._steps >= self.spec.max_episode_steps
        return self._state.astype(np.float32), 1.0, terminated, truncated, {}


_REGISTRY: Dict[str, Callable[..., Any]] = {
    "CartPole-v1": CartPoleEnv,
}


def register_env(name: str, creator: Callable[..., Any]) -> None:
    """Parity: ``ray.tune.registry.register_env``."""
    _REGISTRY[name] = creator


def make_env(name_or_creator, seed: Optional[int] = None):
    if callable(name_or_creator):
        return name_or_creator()
    creator = _REGISTRY.get(name_or_creator)
    if creator is None:
        raise ValueError(
            f"unknown env '{name_or_creator}'; register it with rl.register_env"
        )
    try:
        return creator(seed=seed)
    except TypeError:
        return creator()


class VectorEnv:
    """N independent env copies stepped in lockstep with auto-reset."""

    def __init__(self, creator, n: int, seed: int = 0):
        self.envs = [make_env(creator, seed=seed + i) for i in range(n)]
        self.n = n

    def reset(self) -> np.ndarray:
        return np.stack([e.reset()[0] for e in self.envs])

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, _ = e.step(int(a))
            done = term or trunc
            if done:
                o = e.reset()[0]
            obs.append(o)
            rewards.append(r)
            dones.append(done)
        return np.stack(obs), np.array(rewards, np.float32), np.array(dones)
