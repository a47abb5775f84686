"""The round pre-pass, ``hybrid_search`` and the pointer walk included
(span ``round_prepass``), per round, summed over the servers."""
from dili_bench.reading import per_round_ms


def read(rec):
    return per_round_ms(rec, "round_prepass")
