"""Import a checkpoint written by the JAX package (``progen_tpu.checkpoint``,
an orbax ``state/`` tree) into the port's format
(``progen_tpu_torch.checkpoint``). It needs jax, so it lives with the
tests; the port itself refuses an orbax checkpoint and names this module.

The arrays are restored to numpy, the parameters and Adam's count and
moments go through ``convert.flax_params_to_state_dict`` and
``convert.flax_opt_state_to_torch``, and the port's ``save`` writes them
with the step, the data cursor, the model and train configs and the run
id unchanged.
"""

from __future__ import annotations

import jax
import numpy as np

from progen_tpu.checkpoint import get_checkpoint_fns as jax_checkpoint_fns
from progen_tpu_torch.checkpoint import (
    Package,
    get_checkpoint_fns,
    load_train_state,
)
from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.convert import (
    flax_opt_state_to_torch,
    flax_params_to_state_dict,
)
from progen_tpu_torch.training.step import init_train_state

_ADAM = {"count", "mu", "nu"}


def _adam_state(tree):
    """The {count, mu, nu} node of a restored optax state, wherever the
    chain put it (restored without a template, tuples come back as
    lists and named tuples as dicts)."""
    if isinstance(tree, dict):
        if _ADAM <= tree.keys():
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def import_jax_checkpoint(src: str, dst: str) -> str:
    """Convert the newest checkpoint under ``src`` (JAX package) into a
    new checkpoint under ``dst`` (port); returns its directory."""
    _, get_last, _ = jax_checkpoint_fns(src)
    pkg = get_last()
    if pkg is None:
        raise FileNotFoundError(f"no checkpoint under {src}")
    tree = jax.tree.map(np.asarray, pkg.state)
    config = ProGenConfig.from_dict(pkg.model_config)
    adam = _adam_state(tree["opt_state"])
    if adam is None:
        raise ValueError(f"{pkg.path}: no Adam state in the optimizer state")
    state = init_train_state(config, seed=None, device="cpu")
    load_train_state(state, {
        "params": flax_params_to_state_dict(tree["params"], config),
        "optimizer": flax_opt_state_to_torch(adam, config),
        "step": int(tree["step"]),
    })
    _, _, save = get_checkpoint_fns(dst)
    return save(Package(next_seq_index=pkg.next_seq_index, state=state,
                        model_config=pkg.model_config, run_id=pkg.run_id,
                        train_config=pkg.train_config))
