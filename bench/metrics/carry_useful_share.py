"""The share of the fields written back into the loop carry that the
update changed, in percent: 100 x (``stencil.carry_writes`` -
``stencil.carry_unchanged``) / ``stencil.carry_writes`` (bench/spans.py)."""

from bench import spans


def read(run):
    c = spans.counters()
    if c is None or not c.get("carry_writes"):
        return None
    return 100.0 * (c["carry_writes"] - c["carry_unchanged"]) \
        / c["carry_writes"]
