"""``setup_s``: process start to the first timed request (making and
compressing the text, registering it, warming up)."""


def read(run):
    return run.setup_s
