"""Host ms a call in the program's ``pqmf.handover`` span: a host block's
trip to the card (``streaming.as_device_tensor`` on an array: its host
copy, then the pageable copy to the card). None where no call hands a host
block over."""

from benchmark import spans
from benchmark.metrics import per_call_ms


def read(t):
    s = spans.seconds(spans.union(t, lambda n: n == "pqmf.handover"))
    return per_call_ms(t, s) if s else None
