"""Checkpointable — uniform component-state save/restore for algorithms:
the port of ``ray_tpu/rllib/checkpointable.py``.

Reference parity: rllib/utils/checkpoints.py Checkpointable (get_state /
set_state / save_to_path / restore_from_path as a uniform component
tree). Algorithms expose their state as a nested dict of named
components; the mixin persists it in the JAX package's file format,
a pickle of ``{"class", "state"}`` in ``state.pkl`` (the JAX package
writes it with cloudpickle, whose output the standard pickle reads;
the state is plain data, so the standard pickle writes it here).
Tensor leaves are saved as host numpy copies, so a checkpoint does not
depend on the device it was taken on.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ray_tpu_torch.util import tree


def to_host(value):
    """`value` with every tensor leaf (also inside the optimizers' state
    dataclasses) as a numpy copy; other leaves (iteration counters) as
    they are."""
    return tree.tree_map_with_path(
        lambda _, x: x.detach().to("cpu", copy=True).numpy()
        if isinstance(x, torch.Tensor) else x, value)


def to_device(value, device):
    """`value` with every numpy leaf as a tensor on `device`; scalar
    bookkeeping stays plain Python ints."""
    return tree.tree_map_with_path(
        lambda _, x: torch.from_numpy(np.array(x)).to(device)
        if isinstance(x, np.ndarray) else x, value)


class Checkpointable:
    """Mixin: subclasses define STATE_COMPONENTS, a tuple of attribute
    names whose values form the component tree, and `device`, where
    `set_state` puts the restored tensors."""

    STATE_COMPONENTS: tuple[str, ...] = ()

    def get_state(self) -> dict:
        return {name: to_host(getattr(self, name))
                for name in self.STATE_COMPONENTS}

    def set_state(self, state: dict):
        for name, value in state.items():
            if name not in self.STATE_COMPONENTS:
                continue
            setattr(self, name, to_device(value, self.device))

    def save_to_path(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "state.pkl")
        with open(out, "wb") as f:
            pickle.dump(
                {"class": type(self).__name__, "state": self.get_state()}, f)
        return path

    def restore_from_path(self, path: str):
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            payload = pickle.load(f)
        self.set_state(payload["state"])
        return self
