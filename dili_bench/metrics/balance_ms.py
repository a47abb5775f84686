"""The balancer's pass (span ``balance``, ``core/balancer.py``), per round
of the traced window's timer stretch."""
from dili_bench.reading import per_round_ms


def read(rec):
    return per_round_ms(rec, "balance")
