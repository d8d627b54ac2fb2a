"""Share of a step's time in which no device activity ran, in %: 1 − (the
device slice's busy time a step, the union of its kernel, copy and fill
intervals, ÷ the time a step takes in the untraced head of the window)."""


def read(record):
    n, t = record["iterations"], record["iteration_s"]
    return 100.0 * (1.0 - record["busy_s"] / n / t) if n and t else None
