"""enqueue_us.signals: host microseconds per ``ShardedEmulator.device_call``
from the call until it returns, before any synchronize: the mean over the
window's calls outside the profiled slice (a span in the benchmark's own
generator around the call)."""


def read(record):
    spans = record.get("enqueue_s")
    return 1e6 * sum(spans) / len(spans) if spans else None
