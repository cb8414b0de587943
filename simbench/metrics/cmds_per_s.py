"""Commands per second over the whole window: every episode's committed
slots (paxos) or executed instances (epaxos), all groups, the window's
last episode up to where the window cut it, divided by the window's
seconds from its first launch until the device finished its last round."""


def read(w):
    if w.seconds <= 0:
        return None
    return w.cmds / w.seconds
