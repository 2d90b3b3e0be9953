"""The training state: the step counter, the model and the optimizer.

Counterpart of ``progen_tpu/training/state.py``. There the state is a
pytree of arrays that the jitted step donates and returns anew; here the
train step updates the parameters, the optimizer's moments and count, and
``step`` in place, which stands in for that donation: no second copy of
the parameters or moments is ever made.
"""

from __future__ import annotations

import dataclasses

from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.training.optimizer import MaskedAdamW


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer steps taken, refused ones included
    model: ProGen
    optimizer: MaskedAdamW

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
