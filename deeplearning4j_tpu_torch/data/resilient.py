"""Retrying data path.

The counterpart of ``deeplearning4j_tpu/data/resilient.py``. Production
data sources (object stores, network record readers) fail transiently;
upstream's record readers surface those as IOExceptions straight into
fit(). RetryingDataSetIterator wraps any DataSetIterator so transient
fetch errors are absorbed with the shared capped-backoff policy
(runtime.resilience.RetryPolicy, the one checkpoint I/O uses) instead of
killing a multi-hour job, while other errors still propagate after
maxRetries.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.runtime.resilience import RetryPolicy, retry


class RetryingDataSetIterator:
    """Wrap a DataSetIterator (or MultiDataSetIterator) so hasNext()/
    next() retry transient failures with deterministic backoff.

    retriesExhausted errors re-raise the ORIGINAL exception — callers
    see the same type the base iterator threw, just later. Retries are
    counted in .retries (per-run total) and observable via on_retry.
    """

    def __init__(self, base, policy: RetryPolicy = None, on_retry=None):
        self._base = base
        self._policy = policy or RetryPolicy()
        self.retries = 0
        self._user_on_retry = on_retry

    def _on_retry(self, attempt, exc, delay):
        self.retries += 1
        if self._user_on_retry is not None:
            self._user_on_retry(attempt, exc, delay)

    def reset(self):
        retry(self._base.reset, self._policy, self._on_retry)

    def hasNext(self):
        return retry(self._base.hasNext, self._policy, self._on_retry)

    def next(self, num=None):
        if num is None:  # some custom iterators define next(self) only
            return retry(self._base.next, self._policy, self._on_retry)
        return retry(lambda: self._base.next(num), self._policy,
                     self._on_retry)

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def __getattr__(self, name):  # batch()/totalExamples()/preprocessors
        return getattr(self._base, name)
