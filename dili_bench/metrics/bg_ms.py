"""Background work: Split / Move / Merge steps, the Move replay and the
write-back (spans ``bg_step``, ``replay_prepass``, ``write_back``), per
round, summed over the servers."""
from dili_bench.reading import per_round_ms


def read(rec):
    return per_round_ms(rec, "bg_step", "replay_prepass", "write_back")
