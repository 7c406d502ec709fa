"""Policy-gradient losses over the Pluto candidate distribution (port of
rift_tpu/rl/losses.py: `masked_log_softmax` and `rift_loss`; the grpo,
reinforce, ppo, sft and rtr losses come later).

The action space is the flattened R*M candidate set; the policy is the
softmax over the decoder's `pi` logits with invalid reference lines masked
to -1e8. `rift_loss` is PPO clip [0.8, 1.2] with a dual clip at 3A for
A < 0 (reference rift_trainer.py:140-182).
"""

from __future__ import annotations

import torch

CLIP_LO, CLIP_HI = 0.8, 1.2
DUAL_CLIP = 3.0


def masked_log_softmax(probability: torch.Tensor, r_padding: torch.Tensor):
    """(bs, R, M) logits + (bs, R) padding -> (bs, R*M) log-probs."""
    bs, R, M = probability.shape
    logits = torch.where(r_padding[:, :, None], -1e8, probability)
    return torch.log_softmax(logits.reshape(bs, R * M), dim=-1)


def rift_loss(probability, r_padding, old_logits, advantage, valid_mask):
    """PPO dual-clip surrogate, negated and averaged over the valid
    candidates: probability, old_logits, advantage, valid_mask (bs, R, M);
    r_padding (bs, R) True where a reference line is invalid."""
    bs, R, M = probability.shape
    log_p = masked_log_softmax(probability, r_padding)
    log_p_old = masked_log_softmax(old_logits, r_padding)
    adv = advantage.reshape(bs, R * M)
    ratio = torch.exp(log_p - log_p_old)
    min_obj = torch.minimum(adv * ratio, adv * torch.clamp(ratio, CLIP_LO, CLIP_HI))
    # dual clip: bound how negative the objective can get for A < 0
    objective = torch.where(adv < 0, torch.maximum(min_obj, adv * DUAL_CLIP), min_obj)
    m = valid_mask.reshape(bs, R * M)
    n = torch.clamp(m.sum(), min=1)
    return -torch.sum(objective * m) / n
