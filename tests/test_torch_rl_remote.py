"""Remote env runners of the port's RL library (``ray_tpu_torch.rl``) on the
port's runtime, held against the JAX package's (``ray_tpu.rl`` on
``ray_tpu``'s runtime, as ``tests/test_rl.py`` runs it).

PPO with two remote runners (``tests/test_rl.py:63``'s configuration) takes
the reference's result keys and env-step count, and goes through the same
kill / sample / restore sequence as the reference, step for step; remote
runner k starts from the reference runner k's observations and samples, bit
for bit, what a local port runner seeded ``seed + 1000 * k`` samples;
IMPALA's group heals after a kill, with one learner device, as the
reference's does (``tests/test_rl.py:119-126`` at eight).
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import rl as JR
from ray_tpu_torch import rl as PR

T = 60


@pytest.fixture(scope="module")
def runtimes():
    """Both runtimes, each started once for the module: the reference's for
    ``ray_tpu.rl``'s remote runners, the port's for ``ray_tpu_torch.rl``'s."""
    for R in (ray_tpu, ray_tpu_torch):
        if R.is_initialized():
            R.shutdown()
    try:
        ray_tpu.init(num_cpus=2, _system_config={"prestart_workers": False})
        ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _ppo_config(R):
    return (
        R.PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=32)
        .debugging(seed=0)
    )


def _elastic_ppo(R, algo):
    """train, kill runner 0, train (one runner samples), restore, train:
    what each step reports about the group."""
    first = algo.train()
    seen = [(first["num_env_steps_sampled_lifetime"], algo.runners.num_healthy())]
    R.kill(algo.runners.remote[0])
    seen.append((algo.train()["num_env_steps_sampled_lifetime"], algo.runners.num_healthy()))
    restored = algo.runners.restore()
    seen.append((restored, algo.runners.num_healthy()))
    seen.append((algo.train()["num_env_steps_sampled_lifetime"], algo.runners.num_healthy()))
    algo.stop()
    return first, seen


def test_ppo_remote_env_runners(runtimes):
    jfirst, jseen = _elastic_ppo(ray_tpu, _ppo_config(JR).build())
    first, seen = _elastic_ppo(ray_tpu_torch, _ppo_config(PR).build(device="cpu"))
    assert first["num_env_steps_sampled_lifetime"] == 2 * 4 * 32
    assert "total_loss" in first and set(first) == set(jfirst)
    assert all(np.isfinite(v) for v in first.values() if isinstance(v, float))
    # the elastic sequence, step for step: 256 steps, one runner left after
    # the kill (+128), one restored, both sample again (+256)
    assert seen == jseen == [(256, 2), (384, 1), (1, 2), (640, 2)]


def test_remote_runner_batches_equal_local_runners(runtimes):
    from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
    from ray_tpu_torch.rl.models import init_mlp_policy

    params = init_mlp_policy(torch.Generator().manual_seed(3), 4, 2, device="cpu")
    group = EnvRunnerGroup("CartPole-v1", 2, 4, 32, seed=7, device="cpu")
    batches = group.sample(params)
    assert len(batches) == 2
    for k, batch in enumerate(batches, start=1):
        # the reference's runner k (ray_tpu/rl/env_runner.py:151-158 seeds it
        # seed + 1000 * k) starts from the same observations, bit for bit
        jax_first_obs = JR.env_runner.EnvRunner("CartPole-v1", 4, 32, 7 + 1000 * k).obs
        np.testing.assert_array_equal(batch["obs"][0], jax_first_obs, err_msg=f"runner {k}")
        local = EnvRunner("CartPole-v1", 4, 32, 7 + 1000 * k, device="cpu").sample(params)
        assert set(batch) == set(local)
        for key, value in local.items():
            np.testing.assert_array_equal(batch[key], value, err_msg=f"runner {k} {key}")
    group.stop()


def _impala_config(R):
    return (
        R.IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=16)
        .debugging(seed=0)
    )


def _elastic_impala(R, algo):
    """training_step, kill runner 0, two more steps: (lifetime steps,
    healthy runners) after each."""
    seen = []
    result = algo.training_step()
    seen.append((result["num_env_steps_sampled_lifetime"], result["num_healthy_workers"]))
    R.kill(algo.runners.remote[0])
    for _ in range(2):
        result = algo.training_step()
        seen.append((result["num_env_steps_sampled_lifetime"], result["num_healthy_workers"]))
    algo.stop()
    return result, seen


def test_impala_replaces_a_killed_runner(runtimes):
    _, jseen = _elastic_impala(ray_tpu, _impala_config(JR).build())
    result, seen = _elastic_impala(ray_tpu_torch, _impala_config(PR).build(device="cpu"))
    # the step after the kill samples from one runner (+64) and restores
    # the group, the next samples from two again (+128)
    assert seen == jseen == [(128, 2), (192, 2), (320, 2)]
    assert np.isfinite(result["pg_loss"]) and np.isfinite(result["vf_loss"])
