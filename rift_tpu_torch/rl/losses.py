"""Policy-gradient losses over the Pluto candidate distribution (port of
rift_tpu/rl/losses.py), one per fine-tuning algorithm of the zoo.

The action space is the flattened R*M candidate set; the policy is the
softmax over the decoder's `pi` logits with invalid reference lines masked
to -1e8.

  rift_loss          PPO clip [0.8, 1.2] with a dual clip at 3A for A < 0
  grpo_loss          PPO clip + 0.2 * KL(pi_ref || pi)
  reinforce_loss     log-prob of the executed candidate x return
  ppo_candidate_loss clipped surrogate on the executed candidate, entropy
                     bonus and a SmoothL1 value loss
  rtr_loss           lambda_rl * ppo_candidate_loss + teacher cross-entropy
  sft_loss           cross-entropy to the teacher-selected candidate

plus `smooth_l1` and `gae` (generalized advantage estimation over one
trajectory). Gradients are stopped where the JAX package stops them.
"""

from __future__ import annotations

import torch

CLIP_LO, CLIP_HI = 0.8, 1.2
DUAL_CLIP = 3.0
KL_COEF = 0.2


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


def _pick(log_p, idx):
    """(bs, K) log-probs at the (bs,) indices."""
    return log_p.gather(1, idx.long()[:, None])[:, 0]


def grpo_loss(probability, r_padding, old_logits, ref_logits, advantage, valid_mask,
              kl_coef: float = KL_COEF):
    """PPO clip surrogate minus kl_coef * KL(pi_ref || pi) per candidate,
    negated and averaged over the valid candidates; ref_logits (bs, R, M)
    are the frozen pretrain policy's."""
    bs, R, M = probability.shape
    log_p = masked_log_softmax(probability, r_padding)
    log_p_old = masked_log_softmax(old_logits, r_padding)
    ref_p = torch.exp(masked_log_softmax(ref_logits, r_padding))
    adv = advantage.reshape(bs, R * M)
    kl = ref_p * (torch.log(torch.clamp(ref_p, min=1e-12)) - log_p)
    ratio = torch.exp(log_p - log_p_old)
    objective = torch.minimum(adv * ratio, adv * torch.clamp(ratio, CLIP_LO, CLIP_HI)) - kl_coef * kl
    m = valid_mask.reshape(bs, R * M)
    n = torch.clamp(m.sum(), min=1)
    return -torch.sum(objective * m) / n


def reinforce_loss(probability, r_padding, chosen_idx, returns):
    """-mean(log pi(chosen) * return), the return's gradient stopped."""
    chosen = _pick(masked_log_softmax(probability, r_padding), chosen_idx)
    return -torch.mean(chosen * returns.detach())


def ppo_candidate_loss(probability, r_padding, chosen_idx, old_log_prob, advantage,
                       value_pred, reward_sum, clip_epsilon: float = 0.2,
                       lambda_entropy: float = 0.01):
    """Clipped surrogate on the executed candidate with an entropy bonus,
    plus a SmoothL1 value loss toward reward_sum (all (bs,))."""
    log_p = torch.clamp(masked_log_softmax(probability, r_padding), min=-1e6)
    cur_log_prob = _pick(log_p, chosen_idx)
    entropy = -torch.sum(torch.exp(log_p) * log_p, dim=-1)
    adv = advantage.detach()
    ratio = torch.exp(cur_log_prob - old_log_prob.detach())
    surrogate = torch.minimum(
        adv * ratio, adv * torch.clamp(ratio, 1 - clip_epsilon, 1 + clip_epsilon)
    ).mean()
    actor_loss = -(surrogate + entropy.mean() * lambda_entropy)
    return actor_loss + smooth_l1(value_pred, reward_sum.detach()).mean()


def sft_loss(probability, r_padding, teacher_idx, teacher_valid=None):
    """Cross-entropy to the (bs,) teacher indices, averaged over the
    samples where teacher_valid holds (all when it is None)."""
    ce = -_pick(masked_log_softmax(probability, r_padding), teacher_idx)
    if teacher_valid is not None:
        n = torch.clamp(teacher_valid.sum(), min=1)
        return torch.sum(ce * teacher_valid) / n
    return ce.mean()


def rtr_loss(probability, r_padding, chosen_idx, old_log_prob, advantage, value_pred,
             reward_sum, teacher_idx, lambda_rl: float = 5.0):
    ppo = ppo_candidate_loss(probability, r_padding, chosen_idx, old_log_prob, advantage,
                             value_pred, reward_sum)
    return lambda_rl * ppo + sft_loss(probability, r_padding, teacher_idx)


def smooth_l1(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def gae(rewards, values, dones, gamma: float = 0.98, lam: float = 0.95):
    """Generalized advantage estimation over one trajectory: rewards [T],
    values [T+1] (with the bootstrap), dones [T]. Returns (advantage,
    advantage + values[:-1]), each [T]."""
    not_done = 1.0 - dones.float()
    deltas = rewards + gamma * values[1:] * not_done - values[:-1]
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        adv[t] = carry
    return adv, adv + values[:-1]
