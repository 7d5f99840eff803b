"""The sampler alone (``sample_blocks`` at the trainer's final plan and
arm weights), replayed from a CUDA graph after the window: the median of
20 synced replays, in ms."""


def read(ctx):
    return ctx.sampler_ms
