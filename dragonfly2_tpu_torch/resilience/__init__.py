"""Resilience of the port, each module a copy of dragonfly2_tpu/resilience/'s:

  backoff   — BackoffPolicy: exponential backoff with seeded jitter
  breaker   — CircuitBreaker: per-target closed/open/half-open state
  budget    — RetryBudget: a token bucket over retries per target class,
              pre-charged by servers' retry_after_s hints
  deadline  — cooperative deadline propagation (contextvar)
  faultline — seeded fault injection behind named points on the port's
              artifact loads and RPC wire
"""

from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy
from dragonfly2_tpu_torch.resilience.breaker import CircuitBreaker
from dragonfly2_tpu_torch.resilience.budget import RetryBudget
from dragonfly2_tpu_torch.resilience.deadline import Deadline

__all__ = [
    "BackoffPolicy",
    "CircuitBreaker",
    "Deadline",
    "RetryBudget",
]
