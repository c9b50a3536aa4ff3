"""``rays_per_s``: the rays of every call completed in the window over the
window's seconds (host clock, from the window's start to the end of its
last call). A stream unit counts at its yield; a sharded call counts its
whole unit."""


def read(view: dict):
    run = view["run"]
    done = run.attempted - run.failed
    if done <= 0 or view["window_s"] <= 0:
        return None
    return done * run.rays / view["window_s"]
