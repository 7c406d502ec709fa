from .buffer import (
    DEFAULT_CAPACITY,
    RingBuffer,
    gather_batch,
    ring_append,
    ring_init,
    ring_reset,
    sample_batches,
)
from .evaluator import (
    GAMMA,
    NUM_FRAMES,
    dense_reward,
    derive_kinematics,
    executed_cbv_reward,
    forecast_neighbors,
    grpo_advantage_batched,
    rollout_candidates,
)
from .losses import masked_log_softmax, rift_loss
from .trainer import TrainConfig, fit, make_optimizer, rift_loss_fn, train_step, trainable_mask

__all__ = [
    "DEFAULT_CAPACITY",
    "RingBuffer",
    "ring_init",
    "ring_append",
    "ring_reset",
    "sample_batches",
    "gather_batch",
    "GAMMA",
    "NUM_FRAMES",
    "dense_reward",
    "derive_kinematics",
    "executed_cbv_reward",
    "forecast_neighbors",
    "grpo_advantage_batched",
    "rollout_candidates",
    "masked_log_softmax",
    "rift_loss",
    "TrainConfig",
    "fit",
    "make_optimizer",
    "train_step",
    "trainable_mask",
    "rift_loss_fn",
]
