"""Device ms a call of the host-card copies (the profiler's Memcpy HtoD
and DtoH rows): the call's block in through the program's ``as_tensor``, the
outputs back to the host."""

from benchmark.metrics import per_call_ms


def read(t):
    ms = t.seconds("memcpy", exclude=("DtoD",))
    return per_call_ms(t, ms) if t.count("memcpy") else None
