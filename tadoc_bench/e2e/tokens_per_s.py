"""``tokens_per_s``: uncompressed tokens covered by every analytic answered
in the window, over the window (first request's start to the last one's
answer on the host)."""


def read(run):
    done = run.done()
    if not done or not run.window_s > 0:
        return None
    return sum(run.request_tokens(r) for r in done) / run.window_s
