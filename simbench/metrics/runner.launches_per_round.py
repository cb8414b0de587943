"""Device operations (kernels, copies, fills) launched per round of the
traced episode, the episode's start and end included: the runner loop's
dispatch count, which bounds how much host time a round needs."""


def read(r):
    if r.device_ops <= 0 or r.rounds <= 0:
        return None
    return r.device_ops / r.rounds
