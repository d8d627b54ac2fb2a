"""Share of a request's time in which no device activity ran, in %: 1 −
(the profiled slice's busy time a request, the union of its kernel, copy and
fill intervals, ÷ the time a request takes in the untraced head of the
window)."""


def read(record):
    n, t = record["iterations"], record["iteration_s"]
    return 100.0 * (1.0 - record["busy_s"] / n / t) if n and t else None
