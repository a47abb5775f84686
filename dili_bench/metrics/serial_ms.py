"""The serial loop (span ``serial_loop``), per round, summed over the
servers."""
from dili_bench.reading import per_round_ms


def read(rec):
    return per_round_ms(rec, "serial_loop")
