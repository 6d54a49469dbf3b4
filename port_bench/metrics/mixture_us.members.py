"""mixture_us.members: the host microseconds of a deep ensemble's
``mixture`` span per call in the traced slice (the logsumexp, the
softmax and the weighted sum around the member-batched launch), less the
likelihood-wrapper and launch spans nested in it and less the CUDA
runtime calls made inside it (``runtime_ns``: a launch that waits for
room in a full queue waits there): the mixture's own Python and
dispatch, the mean over the slice's mixture calls."""

import bisect
import statistics

from port_bench.spans import _children, _covered_ns, _descendants, _spans
from tpu21cmvae_torch.utils.profiling import KERNELS, WRAPPERS


def read(record):
    spans = _spans(record)
    runtime = (record.get("trace") or {}).get("runtime_ns")
    if not spans or runtime is None:
        return None
    kids = _children(spans)
    starts = [r[0] for r in runtime]
    own = []
    for i, s in enumerate(spans):
        if s.name != "mixture":
            continue
        lo, hi = bisect.bisect_left(starts, s.start_ns), bisect.bisect_left(starts, s.end_ns)
        inside = [(a, min(b, s.end_ns)) for a, b in runtime[lo:hi]]
        inside += [(spans[j].start_ns, spans[j].end_ns) for j in _descendants(kids, i)
                   if spans[j].layer in (WRAPPERS, KERNELS)]
        own.append(s.end_ns - s.start_ns - _covered_ns(inside))
    return 1e-3 * statistics.fmean(own) if own else None
