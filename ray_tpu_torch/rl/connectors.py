"""Connector pipelines: composable transforms between env and module
(numpy; the port's own copy of ``ray_tpu/rl/connectors.py``).

Parity: ``rllib/connectors/`` (new-stack ConnectorV2) — env-to-module
pipelines transform raw observations before the policy consumes them (and
before they are stored in the rollout, so training sees exactly what acting
saw), module-to-env pipelines transform actions on the way back. Stateful
connectors (running obs normalization, frame stacking) carry their state
through ``get_state``/``set_state`` and ride algorithm checkpoints.

Each runner holds its own pipeline instance (the reference merges per-runner
connector states periodically; here runner-local state is kept — exact for
single-runner setups, approximate for many, same as the reference between
merges).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform stage. ``__call__`` receives a batch of observations
    (N, obs_dim) plus the per-lane done mask of the PREVIOUS step (stateful
    connectors reset those lanes)."""

    def __call__(self, obs: np.ndarray, dones: Optional[np.ndarray] = None) -> np.ndarray:
        return obs

    def transform_action(self, actions: np.ndarray) -> np.ndarray:
        return actions

    def out_dim(self, in_dim: int) -> int:
        return in_dim

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipeline(Connector):
    """Ordered composition (parity: ConnectorPipelineV2)."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, obs, dones=None):
        for c in self.connectors:
            obs = c(obs, dones)
        return obs

    def transform_action(self, actions):
        for c in reversed(self.connectors):
            actions = c.transform_action(actions)
        return actions

    def out_dim(self, in_dim: int) -> int:
        for c in self.connectors:
            in_dim = c.out_dim(in_dim)
        return in_dim

    def get_state(self):
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state or str(i) in state:
                c.set_state(state.get(i, state.get(str(i))))


class NormalizeObservations(Connector):
    """Running mean/std observation filter (parity:
    ``connectors/env_to_module/mean_std_filter.py``; Welford batched)."""

    def __init__(self, epsilon: float = 1e-8, clip: float = 10.0):
        self.eps = epsilon
        self.clip = clip
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs, np.float64)
        n = obs.shape[0]
        if self.mean is None:
            self.mean = np.zeros(obs.shape[-1])
            self.m2 = np.ones(obs.shape[-1])
        batch_mean = obs.mean(axis=0)
        batch_m2 = ((obs - batch_mean) ** 2).sum(axis=0)
        delta = batch_mean - self.mean
        total = self.count + n
        self.mean = self.mean + delta * n / total
        self.m2 = self.m2 + batch_m2 + delta**2 * self.count * n / total
        self.count = total
        var = self.m2 / max(self.count, 2.0)
        out = (obs - self.mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        return {
            "count": self.count,
            "mean": None if self.mean is None else self.mean.copy(),
            "m2": None if self.m2 is None else self.m2.copy(),
        }

    def set_state(self, state):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class FrameStack(Connector):
    """Concatenate the last ``k`` observations per env lane (parity:
    ``connectors/env_to_module/frame_stacking.py``); lanes reset on done."""

    def __init__(self, k: int = 4):
        self.k = int(k)
        self._buf: Optional[np.ndarray] = None  # (N, k, obs_dim)

    def __call__(self, obs, dones=None):
        obs = np.asarray(obs, np.float32)
        n, d = obs.shape
        if self._buf is None or self._buf.shape[0] != n:
            self._buf = np.repeat(obs[:, None, :], self.k, axis=1)
        elif dones is not None and dones.any():
            idx = np.nonzero(dones)[0]
            self._buf[idx] = obs[idx, None, :]
        self._buf = np.concatenate([self._buf[:, 1:], obs[:, None, :]], axis=1)
        return self._buf.reshape(n, self.k * d)

    def out_dim(self, in_dim: int) -> int:
        return in_dim * self.k

    def get_state(self):
        return {"buf": None if self._buf is None else self._buf.copy()}

    def set_state(self, state):
        self._buf = state["buf"]


class ClipActions(Connector):
    """Module-to-env action clipping (parity:
    ``connectors/module_to_env/...``; no-op for discrete actions)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def transform_action(self, actions):
        if np.issubdtype(np.asarray(actions).dtype, np.floating):
            return np.clip(actions, self.low, self.high)
        return actions
