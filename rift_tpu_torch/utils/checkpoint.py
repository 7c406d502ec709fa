"""Checkpoint and resume (port of rift_tpu/utils/checkpoint.py).

A checkpoint is a `torch.save` of a state_dict at `{root}/{name}-episode_{N}`,
the JAX package's naming; resume takes the latest episode.
"""

from __future__ import annotations

import os
import re

import torch

EP_RE = re.compile(r"episode_(\d+)$")


class CheckpointManager:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def path(self, episode: int, name: str = "model") -> str:
        return os.path.join(self.root, f"{name}-episode_{episode}")

    def save(self, state_dict, episode: int, name: str = "model") -> str:
        path = self.path(episode, name)
        torch.save(state_dict, path)
        return path

    def latest_episode(self, name: str = "model") -> int | None:
        eps = [
            int(m.group(1)) for d in os.listdir(self.root)
            if d.startswith(f"{name}-") and (m := EP_RE.search(d))
        ]
        return max(eps) if eps else None

    def restore(self, episode: int | None = None, name: str = "model", map_location=None):
        """(state_dict, episode) of `episode` (default: the latest), or
        (None, None) when there is none."""
        if episode is None:
            episode = self.latest_episode(name)
        if episode is None:
            return None, None
        state_dict = torch.load(self.path(episode, name), map_location=map_location,
                                weights_only=True)
        return state_dict, episode
