"""Share of the traced slice in which no operation ran on the device."""

from benchmark.harness.stats import idle_share


def read(rec):
    return idle_share(rec.profile)
