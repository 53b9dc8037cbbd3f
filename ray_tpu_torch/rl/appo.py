"""APPO: IMPALA's actor-learner architecture with the PPO clipped-surrogate
objective on V-trace-corrected advantages (port of ``ray_tpu/rl/appo.py``).

Parity: ``rllib/algorithms/appo/appo.py:1`` and the torch loss at
``rllib/algorithms/appo/torch/appo_torch_learner.py``. Only the loss
differs from IMPALA, so APPO reuses IMPALA's runner and learner through the
update-builder registry. The surrogate differentiates through the live
ratios; V-trace takes them detached.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rl.impala import (
    IMPALA,
    IMPALAConfig,
    _build_update,
    _masked_terms,
    _policy_terms,
    vtrace_targets,
)


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        # RLlib APPO defaults: clip 0.4, lower LR than IMPALA
        self.clip_param = 0.4
        self.lr = 5e-4

    def build(self, device="cuda") -> "APPO":
        return APPO(self, device=device)


def appo_loss(params, batch, cfg_vals):
    logp, logp_all, values, rhos = _policy_terms(params, batch)
    vs, pg_adv = vtrace_targets(values, batch["last_values"], batch["rewards"], batch["dones"],
                                rhos.detach(), cfg_vals["gamma"], cfg_vals["vtrace_clip_rho"],
                                cfg_vals["vtrace_clip_c"])
    clip = cfg_vals["clip_param"]
    surrogate = torch.minimum(rhos * pg_adv, torch.clamp(rhos, 1.0 - clip, 1.0 + clip) * pg_adv)
    w = batch["mask"][None, :]
    denom, vf_loss, entropy = _masked_terms(values, vs, logp_all, w, logp.shape[0])
    pg_loss = -(surrogate * w).sum() / denom
    loss = pg_loss + cfg_vals["vf_loss_coeff"] * vf_loss - cfg_vals["entropy_coeff"] * entropy
    return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}


def build_appo_update(cfg_vals: Dict[str, Any], optimizer):
    """APPO learner update: V-trace targets + PPO clipped surrogate, where
    the importance ratio is pi/mu against the BEHAVIOR policy."""
    return _build_update(appo_loss, cfg_vals, optimizer)


class APPO(IMPALA):
    @classmethod
    def _update_builder_name(cls) -> str:
        return "appo"

    @classmethod
    def _extra_cfg_vals(cls, config) -> Dict[str, Any]:
        return {"clip_param": float(getattr(config, "clip_param", 0.4))}
