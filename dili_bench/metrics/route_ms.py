"""The round driver's host routing and harvest (span
``host_routing``), per round."""
from dili_bench.reading import per_round_ms


def read(rec):
    return per_round_ms(rec, "host_routing")
