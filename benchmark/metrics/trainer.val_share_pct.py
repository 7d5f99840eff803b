"""The share of the window spent in the trainer's validation (the
benchmark's span around each ``Trainer._validate``), in %."""


def read(ctx):
    spans = ctx.run.win_val
    return 100.0 * sum(spans) / ctx.window_s if spans else None
