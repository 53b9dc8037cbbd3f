"""Reinforcement learning library of the port (RLlib equivalent, new-stack
shape): PyTorch counterpart of ``ray_tpu.rl``, single device.

The same public names, fluent configs and parameter trees as the reference:
``PPOConfig().environment(...).env_runners(...).training(...).build(device=...)``
builds an algorithm whose learner, and whose local env runner's policy, run
on ``device`` (default ``"cuda"``; raises without a card). ``train()``,
``evaluate()``, ``compute_single_action()``, ``save``/``restore`` and
``get_state``/``set_state`` (numpy trees in the reference's layout, so a
JAX algorithm's ``get_state()["params"]`` loads into the port's) as there.
Envs, connectors and replay are numpy. Not in the port: remote env runners
and the multi-process learner group (they need an actor runtime) and a
learner over more than one device (it needs a mesh); asking for them
raises ``NotImplementedError``.
"""

from ray_tpu_torch.rl.appo import APPO, APPOConfig
from ray_tpu_torch.rl.connectors import (
    ClipActions,
    Connector,
    ConnectorPipeline,
    FrameStack,
    NormalizeObservations,
)
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.env import CartPoleEnv, EnvSpec, make_env, register_env
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.multi_agent import (
    MultiAgentCartPole,
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rl.sac import SAC, SACConfig
from ray_tpu_torch.rl.offline import BC, CQL, MARWIL, BCConfig, CQLConfig, MARWILConfig
from ray_tpu_torch.rl.ppo import PPO, PPOConfig

__all__ = [
    "PPO",
    "PPOConfig",
    "APPO",
    "APPOConfig",
    "IMPALA",
    "IMPALAConfig",
    "CQL",
    "CQLConfig",
    "DQN",
    "DQNConfig",
    "SAC",
    "SACConfig",
    "MultiAgentEnv",
    "MultiAgentCartPole",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "CartPoleEnv",
    "make_env",
    "register_env",
    "EnvSpec",
    "Connector",
    "ConnectorPipeline",
    "NormalizeObservations",
    "FrameStack",
    "ClipActions",
]
