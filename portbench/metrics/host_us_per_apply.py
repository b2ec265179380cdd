"""host_us_per_apply: host microseconds inside each ``op @ x`` call (no
sync) while the card's launch queue has room, before the traced tail:
what the host pays to dispatch one apply."""


def read(ctx):
    return ctx.stats.get("host_us_per_apply")
