"""Host ms a call in a CUDA graph's replay (``graphs.Program._run``): the
union of its spans ``pqmf.graph.copy_in`` (the arguments' checks and copies
into the static buffers), ``pqmf.graph.launch`` (the replay) and
``pqmf.graph.clone_out`` (the outputs' clones). None where no graph
replays."""

from benchmark import spans
from benchmark.metrics import per_call_ms

REPLAY = ("pqmf.graph.copy_in", "pqmf.graph.launch", "pqmf.graph.clone_out")


def read(t):
    s = spans.seconds(spans.union(t, lambda n: n in REPLAY))
    return per_call_ms(t, s) if s else None
