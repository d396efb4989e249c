"""Host ms a call of the program's entries' own code: the ``pqmf.entry.*``
spans (``pitchshift_streams``, ``pitchshift_fn``, ``process``,
``roundtrip``) less the handover and graph spans inside them, i.e. the
entries' Python and eager dispatch. None without an entry span."""

from benchmark import spans
from benchmark.metrics import per_call_ms


def read(t):
    s = spans.self_seconds(t, lambda n: n.startswith("pqmf.entry."))
    return None if s is None else per_call_ms(t, s)
