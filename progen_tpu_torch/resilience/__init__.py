"""Fault tolerance: the port's copies of the JAX package's
``resilience/`` modules.

  * transient IO faults -> ``retry.py`` (classified exponential backoff
    around checkpoint and data IO);
  * process death / corruption -> the checkpoint's integrity manifest and
    fallback walk (``checkpoint.py``), rehearsed by ``chaos.py``;
  * numerical anomalies -> ``anomaly.py`` (skip isolated spikes, roll
    back to the last good checkpoint and skip ahead in the data on
    persistent ones).
"""

from progen_tpu_torch.resilience.anomaly import (
    OK,
    ROLLBACK,
    SPIKE,
    LossSentinel,
    PoisonBisector,
    consistent_flag,
)
from progen_tpu_torch.resilience.chaos import (
    ChaosError,
    ChaosInjector,
    install_from_env,
    maybe_inject,
    perturb,
)
from progen_tpu_torch.resilience.retry import (
    RetryPolicy,
    TransientError,
    is_transient,
    policy_from_env,
    retry_call,
    retryable,
)

__all__ = [
    "OK",
    "SPIKE",
    "ROLLBACK",
    "LossSentinel",
    "PoisonBisector",
    "consistent_flag",
    "ChaosError",
    "ChaosInjector",
    "install_from_env",
    "maybe_inject",
    "perturb",
    "RetryPolicy",
    "TransientError",
    "is_transient",
    "policy_from_env",
    "retry_call",
    "retryable",
]
