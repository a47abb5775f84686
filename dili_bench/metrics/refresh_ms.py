"""The packed-block refresh walk (span ``refresh_blocks``), per round,
summed over the servers."""
from dili_bench.reading import per_round_ms


def read(rec):
    return per_round_ms(rec, "refresh_blocks")
